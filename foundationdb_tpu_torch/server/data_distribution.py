"""The data distributor: shard tracking, MoveKeys and re-replication
(trimmed copy of foundationdb_tpu/server/data_distribution.py).

Reference: fdbserver/DataDistribution.actor.cpp (DDTeamCollection :629,
storageServerTracker :4488, teamTracker :3506),
fdbserver/DataDistributionTracker.actor.cpp (split and merge on size) and
fdbserver/MoveKeys.actor.cpp (the two-phase handoff through
`\\xff/keyServers/` transactions).

  * A shard move is two transactions: phase 1 sets the shard's team to
    old + new (both take the new writes), each new member fetches a
    snapshot from a surviving old member at or above phase 1's version,
    phase 2 sets the final team, and the vacated members drop the span.
    Readers are never wrong: a destination answers wrong_shard_server
    until its snapshot is in, and a vacated member closes the span at
    phase 2's version (the proxy's disownment fence), so clients locate
    the key again.
  * Re-replication: when a storage server's process dies, every shard
    whose team held it moves to its surviving members plus the healthy
    server the replication policy ranks first (server/policy.py), its
    data fetched from the survivors.
  * Split: a shard past DD_SHARD_SPLIT_BYTES splits at its middle byte,
    a metadata transaction with no data moved; merge: two neighbours of
    one team under DD_SHARD_MERGE_BYTES together become one.

Its metadata transactions go through the ordinary client (a
client/database.py Database): the same serializable commit path as
every other transaction, resolved on every Resolver role as state
transactions.

  * The storage fleet (DDTeamCollection's recruitment :629 and
    storageServerTracker :4488): a lost server is replaced while an
    idle storage-class worker is registered with the cluster controller
    (_recruit_replacement, under a tag _alloc_tag never issued before:
    its floor is the committed \\xff/maxServerTag); the registry scan
    re-admits a rebooted server whose wait_failure endpoint changed and
    follows the exclusion list, whose servers _drain_excluded empties
    without a team ever below the replication factor; the perpetual
    wiggle drains one server at a time and re-images it onto the
    configured engine (_wiggle_loop, _maybe_migrate_engine); and a
    distributor that a later epoch's announcement does not name halts
    (_check_removed).

Kept: BoundaryMap, _Lock, move_shard with the phase-1 rollback, the
policy ranking of candidates, _handle_storage_failure, _maybe_retire,
the failure monitor over server/failure.py, the split sweep with its
poll backoff and size cache, the merge pass, _recruit_replacement,
_alloc_tag, _registry_scan, _drain_excluded, the wiggle (_wiggle_pos,
_set_wiggle_pos, _wiggle_one, _maybe_migrate_engine, _wiggle_loop),
_check_removed and run().  Run with no ServerDBInfo (a StaticCluster's
distributor), _recruit_replacement recruits nothing, the reference's own
branch for that case: re-replication uses the surviving healthy servers.
The distributor records each move it
makes (`move_log`) and counts its metadata transactions, recruitments,
wiggles and engine migrations (`stats`).
"""

from __future__ import annotations

import bisect
from time import perf_counter
from typing import Any, Dict, List, Optional

from ..core.coverage import test_coverage
from ..core.error import FdbError, err
from ..core.futures import Promise, wait_all
from ..core.knobs import server_knobs
from ..core.scheduler import delay, now
from ..core.trace import Severity, TraceEvent
from ..rpc.endpoint import RequestStream
from .failure import hold_wait_failure, wait_failure_of
from .interfaces import (DataDistributorInterface, FetchKeysRequest,
                         GetShardMetricsRequest, GetWorkersRequest,
                         InitializeStorageRequest, MigrateEngineRequest,
                         RemoveShardRequest, Tag, same_incarnation)
from .policy import PolicyAcross, policy_from_config
from .system_data import (EXCLUDED_END, EXCLUDED_PREFIX, MAX_TAG_KEY,
                          SERVER_TAG_END, SERVER_TAG_PREFIX,
                          STORAGE_WIGGLE_POS_KEY, decode_server_tag_value,
                          excluded_key, key_servers_key, key_servers_value,
                          server_tag_key)


class BoundaryMap:
    """The distributor's shard map: explicit boundaries that are never
    coalesced (a RangeMap joins equal neighbours, which is right for
    routing and wrong here: a same-team split boundary is state, it
    bounds the tracking)."""

    def __init__(self) -> None:
        self._bounds = [b""]
        self._teams = [None]

    def set_boundary(self, key: bytes, team) -> None:
        i = bisect.bisect_left(self._bounds, key)
        if i < len(self._bounds) and self._bounds[i] == key:
            self._teams[i] = team
        else:
            self._bounds.insert(i, key)
            self._teams.insert(i, team)

    def remove_boundary(self, key: bytes) -> None:
        """Merge the shard starting at `key` into its predecessor (what
        clearing its keyServers boundary does)."""
        i = bisect.bisect_left(self._bounds, key)
        if 0 < i < len(self._bounds) and self._bounds[i] == key:
            del self._bounds[i]
            del self._teams[i]

    def lookup(self, key: bytes):
        return self._teams[bisect.bisect_right(self._bounds, key) - 1]

    def shard_end(self, begin: bytes) -> bytes:
        i = bisect.bisect_right(self._bounds, begin)
        return self._bounds[i] if i < len(self._bounds) else b"\xff\xff"

    def is_boundary(self, key: bytes) -> bool:
        i = bisect.bisect_left(self._bounds, key)
        return i < len(self._bounds) and self._bounds[i] == key

    def ranges(self):
        for i, b in enumerate(self._bounds):
            e = (self._bounds[i + 1] if i + 1 < len(self._bounds)
                 else b"\xff\xff")
            yield b, e, self._teams[i]

    def __len__(self) -> int:
        return len(self._bounds)


class _Lock:
    """An async mutex: relocations (moves, splits, merges) must not
    interleave across awaits, or a split could commit a stale team's
    boundary mid-move (the reference's MoveKeys lock)."""

    def __init__(self) -> None:
        self._locked = False
        self._waiters: List = []

    async def __aenter__(self) -> None:
        while self._locked:
            p = Promise()
            self._waiters.append(p)
            await p.get_future()
        self._locked = True

    async def __aexit__(self, *exc) -> None:
        self._locked = False
        if self._waiters:
            self._waiters.pop(0).send(None)


class DataDistributor:
    def __init__(self, dd_id: str, db, storage_interfaces: Dict[Tag, Any],
                 key_servers_ranges, replication: int = 1) -> None:
        self.id = dd_id
        self.db = db                      # client Database (metadata txns)
        self.interface = DataDistributorInterface(dd_id)
        self.interface.role = self   # in-process backref (not on the wire)
        self.storage = dict(storage_interfaces)
        self.replication = replication
        self.map = BoundaryMap()
        for b, _e, team in key_servers_ranges:
            self.map.set_boundary(b, list(team))
        self.healthy = set(self.storage)
        self.excluded: set = set()
        # The tags being wiggled: not a placement destination while they
        # drain, but, unlike an excluded one, still healthy, still a fetch
        # source, and admitted again when the drain ends.
        self.wiggling: set = set()
        # The storage pool's configured size: a lost server is replaced
        # while a spare is there to recruit.
        self.desired_storage = len(self.storage)
        # Never issued again: a retired or excluded tag keeps its number.
        self._max_tag_seen = max(list(self.storage) + [-1])
        self._draining = False
        self._db_info_var = None
        self._process = None
        self._actors: List = []
        self.halted = False
        self.moves_in_flight = 0
        self._relocation_lock = _Lock()
        # A shard well under the split threshold is polled exponentially
        # less often: begin -> [interval, sweeps left].
        self._poll_backoff: Dict[bytes, List[int]] = {}
        # begin -> the shard's bytes at its last poll: the merge pass
        # takes its candidates from here.
        self._shard_sizes: Dict[bytes, int] = {}
        self.stats = {"splits": 0, "merges": 0, "moves": 0,
                      "rereplications": 0, "metadata_txns": 0,
                      "recruits": 0, "wiggles": 0, "engine_migrations": 0}
        # One entry a completed move: its span, teams, the two phases'
        # commit versions and the loop's and the host's times at them.
        self.move_log: List[dict] = []

    # -- metadata transactions ----------------------------------------------
    async def _commit_boundaries(self, sets) -> int:
        """One serializable transaction writing keyServers boundaries,
        retried; a team of None CLEARS the boundary (a merge: the span
        joins the shard before it).  Returns the commit version (a move's
        phase-1 version: its sources serve snapshots at or above it)."""
        t = self.db.create_transaction()
        t.access_system_keys = True
        while True:
            try:
                for boundary, team in sets:
                    if team is None:
                        t.clear(key_servers_key(boundary))
                    else:
                        t.set(key_servers_key(boundary),
                              key_servers_value(team))
                version = await t.commit()
                self.stats["metadata_txns"] += 1
                return version
            except FdbError as e:
                await t.on_error(e)

    # -- MoveKeys (the reference's two-phase handoff) ------------------------
    async def move_shard(self, begin: bytes, end: bytes,
                         new_team: List[Tag]) -> None:
        """Move [begin, end), a whole shard, onto new_team, its data
        fetched from the current team's survivors."""
        async with self._relocation_lock:
            await self._move_shard_locked(begin, end, new_team)

    async def _move_shard_locked(self, begin: bytes, end: bytes,
                                 new_team: List[Tag]) -> None:
        # A split or merge that committed while this move waited for the
        # lock makes (begin, end) stale: moving on would remove a span the
        # map still gives the old team.  Checked again under the lock.
        if not self.map.is_boundary(begin) or \
                self.map.shard_end(begin) != end:
            raise err("movekeys_conflict",
                      f"shard at {begin!r} changed while the move waited")
        old_team = list(self.map.lookup(begin) or [])
        union = old_team + [t for t in new_team if t not in old_team]
        self.moves_in_flight += 1
        phase1_done = False
        try:
            # Phase 1 (startMoveKeys): both teams take the new writes.
            move_version = await self._commit_boundaries([(begin, union)])
            phase1 = (now(), perf_counter())
            self.map.set_boundary(begin, union)
            phase1_done = True
            # Each new member fetches from the live old members, at or
            # above the phase-1 version: a source behind it would miss the
            # mutations sent to the old team only.
            sources = [self.storage[t] for t in old_team
                       if t in self.healthy and t in self.storage]
            fetches = []
            for t in new_team:
                if t in old_team:
                    continue
                fetches.append(RequestStream.at(
                    self.storage[t].fetch_keys.endpoint).get_reply(
                    FetchKeysRequest(begin=begin, end=end,
                                     sources=sources,
                                     min_version=move_version)))
            await wait_all(fetches)
            # Phase 2 (finishMoveKeys): the final team.
            final_version = await self._commit_boundaries(
                [(begin, list(new_team))])
            self.map.set_boundary(begin, list(new_team))
            for t in old_team:
                if t in new_team or t not in self.healthy:
                    continue
                RequestStream.at(
                    self.storage[t].remove_shard.endpoint).send(
                    RemoveShardRequest(begin=begin, end=end))
            self.stats["moves"] += 1
            self.move_log.append({
                "begin": begin, "end": end, "from": old_team,
                "to": list(new_team), "phase1_version": move_version,
                "phase2_version": final_version,
                "virtual_s": now() - phase1[0],
                "wall_s": perf_counter() - phase1[1]})
            TraceEvent("DDMovedShard").detail("Begin", begin).detail(
                "End", end).detail("From", old_team).detail(
                "To", new_team).log()
        except BaseException:
            if phase1_done:
                # Roll the boundary back, so the shard does not point at a
                # destination that disowned it (a failed fetch); the
                # caller decides whether to try other members.
                try:
                    await self._commit_boundaries([(begin, old_team)])
                    self.map.set_boundary(begin, old_team)
                except FdbError as e:
                    TraceEvent("DDMoveRollbackFailed",
                               Severity.Error).detail(
                        "Begin", begin).detail("Error", e.name).log()
            raise
        finally:
            self.moves_in_flight -= 1

    # -- storage recruitment (reference DDTeamCollection :629, :4488) --------
    async def _recruit_replacement(self) -> Optional[Tag]:
        """A new storage server, under a tag never issued before, on an
        idle storage-class worker that the cluster controller's
        get_workers names; its tag, or None when there is no controller
        or no idle worker, or the recruitment failed.  The worker commits
        the new server's registry entry, so the proxies learn its
        interface and the next recovery carries its tag."""
        info = self._db_info_var.get() if self._db_info_var else None  # flowlint: state -- one config snapshot per recruitment
        cc = getattr(info, "cluster_controller", None) if info else None
        if cc is None:
            return None
        try:
            regs = await RequestStream.at(
                cc.get_workers.endpoint).get_reply(GetWorkersRequest())
        except FdbError:
            return None
        live_tags = {t for t in self.storage if t in self.healthy}
        idle = None
        for reg in regs:
            if reg.process_class != "storage":
                continue
            if set(reg.recovered_storage) & live_tags:
                continue            # already hosts a live storage server
            idle = reg.worker
            break
        if idle is None:
            return None
        new_tag = await self._alloc_tag()
        engine = getattr(info, "storage_engine", "") or ""
        try:
            ssi = await RequestStream.at(
                idle.init_storage.endpoint).get_reply(
                InitializeStorageRequest(ss_id=f"ss{new_tag}", tag=new_tag,
                                         engine=engine))
        except FdbError as e:
            TraceEvent("DDRecruitFailed", Severity.Warn).detail(
                "Worker", idle.id).detail("Error", e.name).log()
            return None
        self.storage[new_tag] = ssi
        self.healthy.add(new_tag)
        self.stats["recruits"] += 1
        self._actors.append(self._process.spawn(
            self._failure_monitor(new_tag, ssi), f"{self.id}.ssTracker"))
        TraceEvent("DDStorageRecruited").detail("Tag", new_tag).detail(
            "Worker", idle.id).log()
        return new_tag

    async def _alloc_tag(self) -> Tag:
        """A tag never issued before: above every tag this distributor
        has seen and above the committed \\xff/maxServerTag, which the
        same transaction raises, so no recovery can issue it again (a
        reissued tag would inherit a retired one's state, such as a late
        exclusion)."""
        floor = max(self._max_tag_seen, max(list(self.storage) + [-1]),
                    max(self.excluded, default=-1))
        t = self.db.create_transaction()
        t.access_system_keys = True
        while True:
            try:
                raw = await t.get(MAX_TAG_KEY)
                committed = int(raw) if raw else -1
                new_tag = max(floor, committed) + 1
                t.set(MAX_TAG_KEY, b"%d" % new_tag)
                await t.commit()
                self.stats["metadata_txns"] += 1
                self._max_tag_seen = max(self._max_tag_seen, new_tag)
                return new_tag
            except FdbError as e:
                await t.on_error(e)

    def _policy(self):
        """The placement policy this configuration means (reference
        DatabaseConfiguration::setDefaultReplicationPolicy)."""
        return policy_from_config(self.replication)

    def _candidate(self, t: Tag):
        """(tag, locality dict): the Candidate shape of the policy."""
        iface = self.storage.get(t)
        loc = getattr(iface, "locality", None) if iface is not None else None
        if not loc:
            return (t, {})
        dcid, zoneid, machineid = (tuple(loc) + ("", "", ""))[:3]
        return (t, {"dcid": dcid, "zoneid": zoneid or machineid,
                    "machineid": machineid})

    def _ordered_candidates(self, kept: List[Tag], team,
                            avoid=frozenset()) -> List[Tag]:
        """Replacement candidates ranked by the replication policy
        (PolicyAcross(zoneid)): each pick scores whether kept + pick heads
        toward a valid team, and its zone counts as taken for the next
        pick, so two replacements cannot land in one fresh zone.  An
        excluded server is never a candidate; `avoid` is the wiggle's own
        (re-replication and a drain keep a wiggling server in the pool:
        it is healthy, and the rotation takes a replica placed there
        later)."""
        policy = self._policy()
        kept_c = [self._candidate(t) for t in kept]
        pool = (set(self.healthy) - set(team) - self.excluded -
                set(avoid))
        out: List[Tag] = []

        def diversity(cand) -> int:
            """Distinct placement groups under the policy's attribute
            (what PolicyAcross.validate needs, with partial credit when
            the survivors already break it)."""
            if isinstance(policy, PolicyAcross):
                return len({c[1].get(policy.attr) or f"__u{c[0]}"
                            for c in cand})
            return sum(1 for c in cand)      # One: count

        while pool:
            pick = min(pool, key=lambda t: (
                -diversity(kept_c + [self._candidate(t)]), t))
            out.append(pick)
            pool.discard(pick)
            kept_c.append(self._candidate(pick))
        return out

    # -- re-replication (reference teamTracker's unhealthy path) -------------
    async def _handle_storage_failure(self, dead_tag: Tag) -> None:
        self.healthy.discard(dead_tag)
        TraceEvent("DDStorageFailed", Severity.Warn).detail(
            "Tag", dead_tag).log()
        # Capacity first: a lost server is replaced while a spare exists.
        while len([t for t in self.healthy if t not in self.excluded]) < \
                self.desired_storage:
            if await self._recruit_replacement() is None:
                break
        for begin, _e, _t in list(self.map.ranges()):
            # Looked up again: a split or move may have changed the shard.
            team = self.map.lookup(begin)
            end = self.map.shard_end(begin)
            if not team or dead_tag not in team:
                continue
            survivors = [t for t in team if t in self.healthy]
            if not survivors:
                TraceEvent("DDShardUnrecoverable", Severity.Error).detail(
                    "Begin", begin).detail("End", end).log()
                continue
            candidates = self._ordered_candidates(survivors, team)
            new_team = survivors + candidates[:max(
                0, min(self.replication, len(self.healthy)) -
                len(survivors))]
            if set(new_team) == set(team):
                continue
            # A fetch can fail for a moment (a source behind the phase-1
            # commit, a source dying mid-snapshot): a few tries with
            # backoff (the reference requeues failed relocations).
            for attempt in range(5):
                try:
                    await self.move_shard(begin, end, new_team)
                    self.stats["rereplications"] += 1
                    break
                except FdbError as e:
                    TraceEvent("DDRereplicationFailed",
                               Severity.Warn).detail(
                        "Begin", begin).detail("Error", e.name).detail(
                        "Attempt", attempt).log()
                    if e.name == "movekeys_conflict":
                        break   # bounds stale; the outer scan re-derives
                    await delay(0.5 * (1 << attempt))
        await self._maybe_retire(dead_tag)

    async def _maybe_retire(self, dead_tag: Tag) -> None:
        """Take a dead server that no team names any more out of the
        system: its registry and exclusion entries cleared, and forgotten
        here (reference removeStorageServer after its relocations)."""
        if dead_tag in self.healthy:
            return
        for begin, _e, _t in self.map.ranges():
            team = self.map.lookup(begin)
            if team and dead_tag in team:
                return          # still named: not fully drained
        t = self.db.create_transaction()
        t.access_system_keys = True
        while True:
            try:
                t.clear(server_tag_key(dead_tag))
                t.clear(excluded_key(dead_tag))
                await t.commit()
                self.stats["metadata_txns"] += 1
                break
            except FdbError as e:
                try:
                    await t.on_error(e)
                except FdbError:
                    return      # not retryable: a later sweep retires it
        self.storage.pop(dead_tag, None)
        TraceEvent("DDStorageRetired").detail("Tag", dead_tag).log()

    async def _failure_monitor(self, tag: Tag, ssi) -> None:
        await wait_failure_of(ssi)
        # A stale monitor does nothing: a rejoin replaced the interface.
        if self.storage.get(tag) is ssi and tag in self.healthy:
            await self._handle_storage_failure(tag)

    async def _registry_scan(self) -> None:
        """Every DD_METRICS_INTERVAL, read the server registry and the
        exclusion list (reference serverListKeys and
        excludedServersPrefix): a rebooted server that committed a new
        incarnation (its wait_failure endpoint changed) is healthy again
        with a failure monitor of its own; the drain starts whenever an
        excluded tag is still in a team, so one that waited for capacity
        goes on when a spare worker registers."""
        knobs = server_knobs()
        while True:
            await delay(float(knobs.DD_METRICS_INTERVAL))
            try:
                t = self.db.create_transaction()
                t.access_system_keys = True
                rows = await t.get_range(SERVER_TAG_PREFIX, SERVER_TAG_END)
                ex_rows = await t.get_range(EXCLUDED_PREFIX, EXCLUDED_END)
            except FdbError:
                continue
            excluded = {int(k[len(EXCLUDED_PREFIX):]) for k, v in ex_rows
                        if v == b"1"}
            newly = excluded - self.excluded
            self.excluded = excluded
            if excluded:
                self._max_tag_seen = max(self._max_tag_seen, max(excluded))
            if newly:
                TraceEvent("DDServersExcluded").detail(
                    "Tags", sorted(newly)).log()
            if excluded and not self._draining and any(
                    set(self.map.lookup(b) or ()) & excluded
                    for b, _e, _t in self.map.ranges()):
                self._actors.append(self._process.spawn(
                    self._drain_excluded(), f"{self.id}.drainExcluded"))
            for k, v in rows:
                tag = int(k[len(SERVER_TAG_PREFIX):])
                try:
                    iface = decode_server_tag_value(v)
                except FdbError:
                    continue
                cur = self.storage.get(tag)
                if cur is not None and same_incarnation(cur, iface):
                    continue
                self.storage[tag] = iface
                self.healthy.add(tag)
                self._max_tag_seen = max(self._max_tag_seen, tag)
                self._actors.append(self._process.spawn(
                    self._failure_monitor(tag, iface),
                    f"{self.id}.ssTracker"))
                TraceEvent("DDStorageRejoined").detail("Tag", tag).log()

    # -- shard sizes (reference DataDistributionTracker) ---------------------
    async def _split_loop(self) -> None:
        """The size poll of every shard, each DD_METRICS_INTERVAL: a
        storage server answers a quiet shard from its incremental cache,
        and a cold shard is polled less often (the backoff); a shard past
        DD_SHARD_SPLIT_BYTES splits at the key its server names, then the
        merge pass runs."""
        knobs = server_knobs()
        while True:
            await delay(float(knobs.DD_METRICS_INTERVAL))
            if self.moves_in_flight:
                continue   # no split of a shard mid-move
            for begin, end, team in list(self.map.ranges()):
                if not team:
                    continue
                backoff = self._poll_backoff.get(begin)
                if backoff is not None and backoff[1] > 0:
                    backoff[1] -= 1
                    continue
                holder = next((t for t in team if t in self.healthy), None)
                if holder is None:
                    continue
                try:
                    total, split_key = await RequestStream.at(
                        self.storage[holder].shard_metrics.endpoint
                    ).get_reply(GetShardMetricsRequest(
                        begin=begin, end=end,
                        split_threshold=int(knobs.DD_SHARD_SPLIT_BYTES)))
                except FdbError:
                    continue
                self._shard_sizes[begin] = total
                if total < int(knobs.DD_SHARD_SPLIT_BYTES) // 2:
                    # Cold: double its poll interval (at most 32 sweeps).
                    b = self._poll_backoff.setdefault(begin, [1, 0])
                    b[0] = min(b[0] * 2, 32)
                    b[1] = b[0]
                else:
                    self._poll_backoff.pop(begin, None)
                if split_key is None or not begin < split_key < end:
                    continue
                async with self._relocation_lock:
                    # Checked again under the lock: a move or split may
                    # have changed the shard while its size was polled.
                    if (self.map.lookup(begin) != team or
                            self.map.shard_end(begin) != end or
                            self.halted):
                        continue
                    # A metadata split: one team on both sides.
                    await self._commit_boundaries([(split_key, list(team))])
                    self.map.set_boundary(split_key, list(team))
                    self.stats["splits"] += 1
                    TraceEvent("DDShardSplit").detail(
                        "At", split_key).detail("Bytes", total).log()
            await self._merge_pass()

    async def _shard_bytes(self, begin: bytes, end: bytes,
                           team) -> Optional[int]:
        holder = next((t for t in team or () if t in self.healthy), None)
        if holder is None:
            return None
        try:
            total, _sk = await RequestStream.at(
                self.storage[holder].shard_metrics.endpoint).get_reply(
                GetShardMetricsRequest(
                    begin=begin, end=end,
                    split_threshold=1 << 62))   # no split key needed
            return total
        except FdbError:
            return None

    async def _merge_pass(self) -> None:
        """Merge neighbours of one team whose sizes together fell below
        DD_SHARD_MERGE_BYTES (reference shardMerger): a metadata clear of
        the right shard's boundary.  The sizes are measured again under
        the relocation lock, so a racing move or split is not merged
        over."""
        knobs = server_knobs()
        merge_limit = int(knobs.DD_SHARD_MERGE_BYTES)
        if self.moves_in_flight or self.halted:
            return
        ranges = list(self.map.ranges())
        i = 0
        while i < len(ranges) - 1:
            b1, e1, t1 = ranges[i]
            b2, e2, t2 = ranges[i + 1]
            if e1 != b2 or not t1 or not t2 or list(t1) != list(t2):
                i += 1
                continue
            # Only pairs the last sweep measured as small are measured
            # again; an unknown size waits for its next poll.
            c1 = self._shard_sizes.get(b1)
            c2 = self._shard_sizes.get(b2)
            if c1 is None or c2 is None or c1 + c2 >= merge_limit:
                i += 1
                continue
            merged = False
            async with self._relocation_lock:
                if (self.halted or self.map.lookup(b1) != t1 or
                        self.map.shard_end(b1) != b2 or
                        self.map.lookup(b2) != t2 or
                        self.map.shard_end(b2) != e2):
                    i += 1
                    continue
                left = await self._shard_bytes(b1, b2, t1)
                right = await self._shard_bytes(b2, e2, t2)
                if left is not None and right is not None and \
                        left + right < merge_limit:
                    await self._commit_boundaries([(b2, None)])
                    self.map.remove_boundary(b2)
                    self._poll_backoff.pop(b2, None)
                    self._shard_sizes.pop(b2, None)
                    self._shard_sizes[b1] = left + right
                    self.stats["merges"] += 1
                    test_coverage("DDShardMerge")
                    TraceEvent("DDShardMerge").detail("At", b2).detail(
                        "Bytes", left + right).log()
                    merged = True
            if merged:
                # The left shard is now [b1, e2): keep absorbing from here.
                ranges[i] = (b1, e2, t1)
                del ranges[i + 1]
            else:
                i += 1

    # -- exclusion (reference: data movement off excluded servers) ----------
    async def _drain_excluded(self) -> None:
        """Move every shard off the excluded servers, which stay fetch
        sources while they drain and only stop being destinations.  A
        replacement is recruited first when the pool without them is
        short of the replication factor; no team is ever made smaller
        than it: a drain the cluster lacks the capacity for waits, and
        the registry scan starts it again."""
        if self._draining:
            return
        self._draining = True
        try:
            pool = {t for t in self.healthy if t not in self.excluded}
            while len(pool) < self.replication:
                if await self._recruit_replacement() is None:
                    TraceEvent("DDDrainWaitingForCapacity",
                               Severity.Warn).detail(
                        "Pool", sorted(pool)).detail(
                        "Replication", self.replication).log()
                    return
                pool = {t for t in self.healthy if t not in self.excluded}
            for begin, _e, _t in list(self.map.ranges()):
                team = self.map.lookup(begin)
                end = self.map.shard_end(begin)
                if not team or not (set(team) & self.excluded):
                    continue
                keep = [t for t in team if t not in self.excluded]
                candidates = self._ordered_candidates(keep, team)
                new_team = keep + candidates[:max(
                    0, min(self.replication, len(pool)) - len(keep))]
                if not new_team or set(new_team) == set(team) or \
                        len(new_team) < min(self.replication, len(pool)):
                    TraceEvent("DDDrainStuck", Severity.Warn).detail(
                        "Begin", begin).detail(
                        "Excluded", sorted(self.excluded)).log()
                    continue
                for attempt in range(5):
                    try:
                        await self.move_shard(begin, end, new_team)
                        break
                    except FdbError as e:
                        TraceEvent("DDDrainMoveFailed",
                                   Severity.Warn).detail(
                            "Begin", begin).detail("Error", e.name).detail(
                            "Attempt", attempt).log()
                        if e.name == "movekeys_conflict":
                            break  # bounds stale: the registry scan retries
                        await delay(0.5 * (1 << attempt))
        finally:
            self._draining = False

    # -- the perpetual wiggle (reference perpetualStorageWiggler: one server
    # at a time drained and refilled, so every replica is rewritten) -------
    async def _wiggle_pos(self) -> int:
        t = self.db.create_transaction()
        t.access_system_keys = True
        while True:
            try:
                raw = await t.get(STORAGE_WIGGLE_POS_KEY)
                return int(raw) if raw else -1
            except FdbError as e:
                await t.on_error(e)

    async def _set_wiggle_pos(self, tag: Tag) -> None:
        t = self.db.create_transaction()
        t.access_system_keys = True
        while True:
            try:
                t.set(STORAGE_WIGGLE_POS_KEY, b"%d" % tag)
                await t.commit()
                self.stats["metadata_txns"] += 1
                return
            except FdbError as e:
                await t.on_error(e)

    async def _wiggle_one(self, tag: Tag) -> None:
        """Drain every shard off `tag`, re-image it onto the configured
        engine, and admit it again.  It stays healthy and a fetch source
        throughout and only stops being a destination; a shard the pool
        cannot place at full replication is skipped (the wiggle never
        lowers redundancy)."""
        self.wiggling.add(tag)
        try:
            TraceEvent("DDWiggleStart").detail("Tag", tag).log()
            for begin, _e, _t in list(self.map.ranges()):
                team = self.map.lookup(begin)
                end = self.map.shard_end(begin)
                if not team or tag not in team or self.halted:
                    continue
                keep = [t for t in team if t != tag]
                candidates = self._ordered_candidates(keep, team,
                                                      avoid=self.wiggling)
                need = len(team) - len(keep)
                if len(candidates) < need:
                    TraceEvent("DDWiggleSkipShard", Severity.Warn).detail(
                        "Begin", begin).detail("Tag", tag).log()
                    continue
                new_team = keep + candidates[:need]
                for attempt in range(5):
                    try:
                        await self.move_shard(begin, end, new_team)
                        break
                    except FdbError as e:
                        TraceEvent("DDWiggleMoveFailed",
                                   Severity.Warn).detail(
                            "Begin", begin).detail("Error", e.name).detail(
                            "Attempt", attempt).log()
                        if e.name == "movekeys_conflict":
                            break   # bounds stale: the next rotation retries
                        await delay(0.5 * (1 << attempt))
            remaining = sum(1 for _b, _e, t in self.map.ranges()
                            if tag in (t or []))
            await self._maybe_migrate_engine(tag, remaining)
            self.stats["wiggles"] += 1
            TraceEvent("DDWiggleDone").detail("Tag", tag).detail(
                "ShardsRemaining", remaining).log()
        finally:
            self.wiggling.discard(tag)

    async def _maybe_migrate_engine(self, tag: Tag, remaining: int) -> None:
        """Re-image a drained server onto the configured engine where it
        runs another (engine migrations ride the rotation); one that still
        holds shards waits for a later rotation."""
        info = self._db_info_var.get() if self._db_info_var else None
        want = getattr(info, "storage_engine", "") or ""
        ssi = self.storage.get(tag)
        have = getattr(ssi, "engine_name", "") if ssi is not None else ""
        if not want or not have or want == have:
            return
        if remaining:
            TraceEvent("DDWiggleEngineDeferred").detail(
                "Tag", tag).detail("Want", want).log()
            return
        try:
            await RequestStream.at(ssi.migrate_engine.endpoint).get_reply(
                MigrateEngineRequest(engine=want))
            ssi.engine_name = want
            self.stats["engine_migrations"] += 1
            TraceEvent("DDWiggleEngineMigrated").detail(
                "Tag", tag).detail("To", want).log()
        except FdbError as e:
            TraceEvent("DDWiggleEngineFailed", Severity.Warn).detail(
                "Tag", tag).detail("Error", e.name).log()

    async def _wiggle_loop(self) -> None:
        """The rotation: every STORAGE_WIGGLE_INTERVAL, while
        PERPETUAL_STORAGE_WIGGLE is on (read each round, so it turns on
        and off live), no drain runs and the pool is larger than the
        replication factor, wiggle the next healthy tag after the
        committed position, then commit the position (a new distributor
        resumes there)."""
        knobs = server_knobs()
        while True:
            await delay(float(knobs.STORAGE_WIGGLE_INTERVAL))
            try:
                if not knobs.PERPETUAL_STORAGE_WIGGLE or self._draining:
                    continue
                pool = sorted(t for t in self.healthy
                              if t not in self.excluded)
                if len(pool) <= self.replication:
                    TraceEvent("DDWiggleNoHeadroom", Severity.Warn).detail(
                        "Pool", pool).detail(
                        "Replication", self.replication).log()
                    continue
                pos = await self._wiggle_pos()
                tag = next((t for t in pool if t > pos), pool[0])
                await self._wiggle_one(tag)
                await self._set_wiggle_pos(tag)
            except FdbError as e:
                # One error that is not retryable (operation_failed inside
                # a recovery) must not end the rotation: the next round
                # tries again.
                TraceEvent("DDWiggleError", Severity.Warn).detail(
                    "Error", e.name).log()

    # -- the halt of a deposed distributor (reference checkRemoved) ---------
    async def _check_removed(self, db_info_var, epoch: int) -> None:
        """Halt once an announcement of this epoch or a later one that
        accepts commits names another distributor: a deposed distributor
        must issue no more moves.  The same epoch counts too (a failed
        recovery attempt whose successor won).  Compared by endpoint, not
        by object: an announcement may be a decoded copy."""
        while True:
            info = db_info_var.get()
            if info.data_distributor is not None and \
                    info.epoch >= epoch and \
                    info.recovery_state in ("accepting_commits",
                                            "fully_recovered") and \
                    not same_incarnation(info.data_distributor,
                                         self.interface):
                TraceEvent("DataDistributorHalted").detail(
                    "Id", self.id).detail("NewEpoch", info.epoch).log()
                self.halted = True
                for a in self._actors:
                    if not a.is_ready():
                        a.cancel()
                return
            await db_info_var.on_change()

    def run(self, process, db_info_var=None, epoch: int = 0) -> list:
        """Register the interface on `process` and spawn there a failure
        monitor for every storage server, the split sweep, the registry
        scan, the wiggle loop and the waitFailure holder, and with a
        ServerDBInfo variable (a worker's) the halt watch; the actors
        that a halt cancels."""
        self.halted = False
        self._process = process
        self._db_info_var = db_info_var
        for s in self.interface.streams():
            process.register(s)
        self._actors = [process.spawn(self._failure_monitor(tag, ssi),
                                      f"{self.id}.ssTracker")
                        for tag, ssi in self.storage.items()]
        self._actors.append(process.spawn(self._split_loop(),
                                          f"{self.id}.shardTracker"))
        self._actors.append(process.spawn(self._registry_scan(),
                                          f"{self.id}.registryScan"))
        self._actors.append(process.spawn(self._wiggle_loop(),
                                          f"{self.id}.storageWiggler"))
        process.spawn(hold_wait_failure(self.interface.wait_failure),
                      f"{self.id}.waitFailure")
        if db_info_var is not None:
            process.spawn(self._check_removed(db_info_var, epoch),
                          f"{self.id}.checkRemoved")
        TraceEvent("DataDistributorStarted").detail("Id", self.id).detail(
            "Shards", len(self.map)).detail(
            "Storage", len(self.storage)).log()
        return list(self._actors)
