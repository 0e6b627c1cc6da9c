"""Resolver boundaries and resolution balancing (trimmed copy of the
resolution-plane part of foundationdb_tpu/server/master.py).

Reference: fdbserver/masterserver.actor.cpp resolutionBalancing (:1318)
with the resolver's metrics and split endpoints
(Resolver.actor.cpp:341-348), and the resolver_changes the master
piggybacks on its version replies (:1175-1182).  Here: the epoch's
keyResolvers assignment as recruitment seeds it (seed_resolver_boundaries,
_valid_resolver_ranges, _key_resolver_ranges), and ResolutionBalancer,
whose step() is one pass of resolution_balancing's loop body and which
keeps the master's record of the moves (resolution_changes, handed to a
proxy with its next version and dropped once every expected proxy has
seen them, as _allocate_version does).

Master (:57-170) hands out commit versions: VERSIONS_PER_SECOND a second
of the clock's time (at least 1, at most
MAX_READ_TRANSACTION_LIFE_VERSIONS / 2 a request, at most
MAX_VERSIONS_IN_FLIGHT past the live committed version), each proxy's
requests answered in request_num order with a resend answered from its
cache, and the balancer's moves riding each reply (resolver_changes); it
keeps the live committed version the proxies report and the GRV proxies
read.  The clock is a constructor argument (time.monotonic by default),
so a test can drive it.  The calls are synchronous, so a request that
arrives ahead of its predecessor raises instead of parking.

DBCoreState (:195-388, whole) is what survives between epochs: the
generation's TLog ids, the storage tags and their ids, the shard map
snapshot at map_version, the resolver count and ranges; fields the static
cluster does not use stay at their defaults, so the packed bytes equal
the reference's.  epoch_end() is the epoch-end step of master_server
(:834-1080) as one call: lock every TLog of the old generation, choose a
holder and its popped version for each storage tag, take the recovery
version as the least end version over the locked logs, replay the
TXS_TAG shard-map deltas after map_version onto the snapshot, and build
the new epoch's Master at the recovery version.

Left out: the balancing loop's interval delay (the caller steps the
balancer), the DBCoreState persistence of the moved boundaries, and of
the recovery state machine: region failover, backup, tenants, the
database lock, configuration changes, log routers and the coordinators
(the static cluster writes the core state to its data directory).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.error import FdbError, err
from ..core.knobs import server_knobs
from ..core.trace import TraceEvent
from ..core.wire import Reader, Writer
from ..txn.types import KeyRange, Version
from .interfaces import (RESOLVER_ALL, TXS_TAG, GetCommitVersionReply,
                         GetCommitVersionRequest, GetRawCommittedVersionReply,
                         GetRawCommittedVersionRequest,
                         ReportRawCommittedVersionRequest, Reply,
                         ResolutionMetricsRequest, ResolutionSplitRequest,
                         Tag, TLogLockReply, TLogLockRequest, ask)
from .shardmap import RangeMap
from .system_data import SYSTEM_KEYS_BEGIN, apply_key_servers_mutation
from .tlog import peek_through

# Resolution balancing's gates, the reference's knob defaults
# (foundationdb_tpu/core/knobs.py:333-334): the least ranges a poll on the
# busiest resolver before a move, and the busiest-to-least-busy load
# ratio that triggers one.
RESOLUTION_BALANCING_MIN_LOAD = 50
RESOLUTION_BALANCING_RATIO = 1.5


def _split_points(n: int) -> List[bytes]:
    return [bytes([(256 * i) // n]) for i in range(1, n)]


def seed_resolver_boundaries(key_servers_ranges, n_resolvers: int
                             ) -> List[bytes]:
    """n-1 interior cut keys for the resolver plane, seeded equi-depth
    from the storage shard map, triples (begin, end, team): DD keeps
    shards split by data volume, so shard begin keys sample the committed
    key distribution -- static even byte splits would land a
    shared-prefix keyspace (tenants, "k000..." keys) entirely on one
    resolver.  Falls back to static byte splits when the shard map is too
    coarse to cut n ways (cold boot)."""
    if n_resolvers <= 1:
        return []
    cands = sorted({b for b, _e, _team in key_servers_ranges
                    if b"" < b < SYSTEM_KEYS_BEGIN})
    if len(cands) < n_resolvers - 1:
        return _split_points(n_resolvers)
    cuts: List[bytes] = []
    for i in range(1, n_resolvers):
        c = cands[min(len(cands) - 1, (i * len(cands)) // n_resolvers)]
        if not cuts or c > cuts[-1]:
            cuts.append(c)
    if len(cuts) != n_resolvers - 1:
        return _split_points(n_resolvers)
    return cuts


def _valid_resolver_ranges(ranges, n_resolvers: int) -> bool:
    """A user-keyspace ownership list is adoptable iff it covers
    [b"", \\xff) contiguously AND every resolver index owns some user
    range (a count increase must re-seed, or the extra resolvers would
    hold only the \\xff broadcast)."""
    if not ranges:
        return False
    cur = b""
    seen = set()
    for b, e, idx in ranges:
        if b != cur or e <= b or not 0 <= idx < n_resolvers:
            return False
        seen.add(idx)
        cur = e
    return cur == SYSTEM_KEYS_BEGIN and len(seen) == n_resolvers


def _key_resolver_ranges(n_resolvers: int,
                         user_ranges=None,
                         boundaries: Optional[List[bytes]] = None
                         ) -> List[Tuple[bytes, bytes, int]]:
    """The epoch's keyResolvers assignment: user-keyspace ownership ranges
    (adopted, seeded from `boundaries`, or static even byte splits) plus
    the \\xff system range broadcast to ALL resolvers -- every resolver
    holds identical system-key history, so metadata transactions resolve
    identically everywhere and boundary moves never migrate it."""
    if user_ranges is None:
        if boundaries is None:
            boundaries = _split_points(n_resolvers)
        bounds = [b""] + list(boundaries) + [SYSTEM_KEYS_BEGIN]
        user_ranges = [(bounds[i], bounds[i + 1], i)
                       for i in range(n_resolvers)]
    return list(user_ranges) + [
        (SYSTEM_KEYS_BEGIN, b"\xff\xff", RESOLVER_ALL)]


class ResolutionBalancer:
    """Moves resolver boundaries by measured load, and keeps the moves
    until every proxy has them.

    When the busiest resolver's ranges since the last poll exceed the
    least busy's by RESOLUTION_BALANCING_RATIO (and at least
    RESOLUTION_BALANCING_MIN_LOAD), the first of its owned ranges that
    its sampled load splits is cut at the load midpoint and the upper
    part moves to the least busy.  The \\xff system range (RESOLVER_ALL)
    never matches a resolver index, so it never moves."""

    def __init__(self, key_resolver_ranges, expected_proxies=()) -> None:
        self.owned: RangeMap = RangeMap(default=0)
        for b, e, idx in key_resolver_ranges:
            self.owned.set_range(b, e, idx)
        # (KeyRange, resolver_idx, change_version) in change order.
        self.resolution_changes: list = []
        self.resolution_changes_version: Version = 0
        # The proxies of the epoch; a change is dropped once all of them
        # have been handed it (a version-age GC would let an idle proxy
        # miss a move and keep routing to the old owner).
        self.expected_proxies = list(expected_proxies)
        self.last_change_seen: Dict[str, Version] = {}

    def step(self, resolvers, version: Version) -> Optional[tuple]:
        """One pass of the reference's loop body over the roles' metrics
        and split requests; `version` is the last version handed out.
        Returns the change made, or None."""
        loads = []
        for r in resolvers:
            reply = Reply()
            r.serve_metrics(ResolutionMetricsRequest(reply=reply))
            loads.append(reply.value)
        hi = max(range(len(loads)), key=lambda i: loads[i])
        lo = min(range(len(loads)), key=lambda i: loads[i])
        if loads[hi] < RESOLUTION_BALANCING_MIN_LOAD or \
                loads[hi] < loads[lo] * RESOLUTION_BALANCING_RATIO or \
                hi == lo:
            return None
        src_ranges = [(b, e) for b, e, idx in self.owned.ranges()
                      if idx == hi]
        split = e = None
        for rb, re_ in src_ranges:
            reply = Reply()
            resolvers[hi].serve_split(ResolutionSplitRequest(
                begin=rb, end=re_, fraction=0.5, reply=reply))
            cand = reply.value
            if cand is not None and rb < cand < re_:
                e, split = re_, cand
                break
        if split is None:
            return None
        self.owned.set_range(split, e, lo)
        # Strictly increasing: two moves with no version handed out
        # between them must not share a change version, or proxies (which
        # dedup by version) would drop the second.
        self.resolution_changes_version = max(
            version + 1, self.resolution_changes_version + 1)
        change = (KeyRange(split, e), lo, self.resolution_changes_version)
        self.resolution_changes.append(change)
        TraceEvent("ResolutionBalanced").detail(
            "From", hi).detail("To", lo).detail(
            "SplitKey", split).detail("End", e).detail(
            "Loads", loads).log()
        return change

    def changes_for(self, proxy_id: str) -> list:
        """The changes a version reply to `proxy_id` carries: first drop
        those every expected proxy has been handed, then hand this proxy
        the rest (reference Master._allocate_version, _reply_version)."""
        self.last_change_seen.setdefault(proxy_id, 0)
        if self.resolution_changes:
            seen = [self.last_change_seen.get(pid, 0)
                    for pid in (self.expected_proxies or
                                list(self.last_change_seen))]
            floor = min(seen) if seen else 0
            self.resolution_changes = [
                c for c in self.resolution_changes if c[2] > floor]
        self.last_change_seen[proxy_id] = max(
            self.last_change_seen[proxy_id], self.resolution_changes_version)
        return list(self.resolution_changes)


class _ProxyVersionState:
    """Per-proxy request ordering + resend dedup (reference
    MasterData::lastCommitProxyVersionReplies)."""

    __slots__ = ("last_request_num", "replies")

    def __init__(self) -> None:
        # Proxies number requests from 1; "0 already served" seeds the chain.
        self.last_request_num = 0
        self.replies: Dict[int, GetCommitVersionReply] = {}


class Master:
    """One master epoch's commit-version state."""

    def __init__(self, recovery_version: Version = 0,
                 clock: Callable[[], float] = time.monotonic,
                 balancer: Optional[ResolutionBalancer] = None,
                 epoch: int = 1) -> None:
        """`clock`: seconds, read once a version request.  `balancer`:
        the resolution balancer whose moves ride the version replies (none:
        no moves).  `epoch`: the generation this master serves; its
        versions start at `recovery_version`, the last epoch's end."""
        self.epoch = epoch
        self.last_epoch_end: Version = recovery_version
        self.version: Version = recovery_version       # last allocated
        self.live_committed_version: Version = recovery_version
        self.last_version_time: float = 0.0
        self.clock = clock
        self.balancer = balancer
        self.proxy_states: Dict[str, _ProxyVersionState] = {}

    # -- version allocation (reference getVersion :1126) ---------------------
    def _allocate_version(self, proxy_id: str) -> GetCommitVersionReply:
        knobs = server_knobs()
        t1 = self.clock()
        if self.last_version_time == 0.0:
            self.last_version_time = t1
        to_add = max(1, min(int(knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS / 2),
                            int(knobs.VERSIONS_PER_SECOND *
                                (t1 - self.last_version_time))))
        self.last_version_time = t1
        prev = self.version
        new_version = self.version + to_add
        # Gap cap: don't run more than MAX_VERSIONS_IN_FLIGHT ahead of the
        # fully-committed frontier.
        max_allowed = self.live_committed_version + int(
            knobs.MAX_VERSIONS_IN_FLIGHT)
        new_version = max(prev + 1, min(new_version, max_allowed))
        self.version = new_version
        changes, changes_version = [], 0
        if self.balancer is not None:
            # The balancer drops the changes every expected proxy has been
            # handed, then hands this proxy the rest (the reference's
            # resolver-change GC and last_change_seen).
            changes = self.balancer.changes_for(proxy_id)
            changes_version = self.balancer.resolution_changes_version
        return GetCommitVersionReply(
            version=new_version, prev_version=prev,
            resolver_changes=changes,
            resolver_changes_version=changes_version)

    def serve_commit_version(self, req: GetCommitVersionRequest) -> None:
        """A proxy's version request: a resend of an answered request is
        answered from the cache (and dropped, unanswered, once evicted, as
        the reference drops it); the next request gets a new version; one
        ahead of its predecessor raises (the reference parks it, and the
        calls here are synchronous)."""
        st = self.proxy_states.setdefault(req.proxy_id, _ProxyVersionState())
        if req.request_num <= st.last_request_num:
            cached = st.replies.get(req.request_num)
            if cached is not None:
                req.reply.send(cached)
            return
        if req.request_num > st.last_request_num + 1:
            raise RuntimeError(
                f"master: request {req.request_num} of {req.proxy_id} "
                f"arrived before {st.last_request_num + 1}")
        reply = self._allocate_version(req.proxy_id)
        st.last_request_num = req.request_num
        st.replies[req.request_num] = reply
        # Drop replies older than the one before this (proxy won't resend).
        st.replies = {n: r for n, r in st.replies.items()
                      if n >= req.request_num - 1}
        req.reply.send(reply)

    # -- live committed version (reference :1217) ----------------------------
    def serve_live_committed(self, req: GetRawCommittedVersionRequest
                             ) -> None:
        req.reply.send(GetRawCommittedVersionReply(
            version=self.live_committed_version))

    def serve_report_committed(self, req: ReportRawCommittedVersionRequest
                               ) -> None:
        if req.version > self.live_committed_version:
            self.live_committed_version = req.version
        req.reply.send(None)


# ---------------------------------------------------------------------------
# DBCoreState: what survives between epochs (reference
# fdbserver/DBCoreState.h; the reference's also carries the txn-state
# metadata)
# ---------------------------------------------------------------------------

@dataclass
class DBCoreState:
    epoch: int
    recovery_version: Version
    tlogs: List[Any] = field(default_factory=list)        # TLogInterface|None
    log_replication: int = 1
    storage_servers: Dict[Tag, Any] = field(default_factory=dict)
    key_servers_ranges: List[Tuple[bytes, bytes, List[Tag]]] = \
        field(default_factory=list)
    n_resolvers: int = 1
    # Version at which key_servers_ranges was snapshotted: recovery replays
    # TXS_TAG metadata deltas with version > map_version on top of it
    # (reference: txnStateStore recovered from the txsTag stream).
    map_version: Version = 0
    backup_active: bool = False
    # Durable identities mirroring the interface lists: live interface
    # objects don't survive a power failure, so pack() stores ids and the
    # rebooted master re-resolves them against worker-recovered roles
    # (reference DBCoreState stores TLog UIDs, not endpoints, for the same
    # reason).
    tlog_ids: List[str] = field(default_factory=list)
    storage_ids: Dict[Tag, str] = field(default_factory=dict)
    # Committed \xff/conf/ configuration values as of map_version (the
    # reference's DatabaseConfiguration lives in the database; the
    # baseline snapshot rides the cstate like key_servers_ranges, with
    # TXS replay applying later changes on top).
    conf: Dict[str, bytes] = field(default_factory=dict)
    # Region replication plane (usable_regions >= 2): the remote TLog set
    # and the remote storage replicas keyed by TWIN tag — what a region
    # failover locks and recovers from (reference DBCoreState's remote
    # tLog sets in oldTLogData).
    remote_tlogs: List[Any] = field(default_factory=list)
    remote_storage: Dict[Tag, Any] = field(default_factory=dict)
    remote_tlog_ids: List[str] = field(default_factory=list)
    remote_storage_ids: Dict[Tag, str] = field(default_factory=dict)
    # Active backup's container URL (committed alongside the flag): the
    # recruited backup worker role resumes appending here.
    backup_container: str = ""
    # Database lock UID (\xff/dbLocked): recruited proxies must enforce
    # the fence from their first batch, even after a full power failure
    # (the lock is committed data; reference databaseLockedKey).
    locked: Optional[bytes] = None
    # Tenant map snapshot {id: name} as of map_version (committed
    # \xff/tenant/map/ state; TXS replay applies later creates/deletes on
    # top) — recruited proxies enforce the tenant fence from their first
    # batch, across full power failures.
    tenants: Dict[int, bytes] = field(default_factory=dict)
    tenant_metadata_version: int = 0
    # Resolution-plane USER-keyspace ownership as of this epoch:
    # (begin, end, resolver_idx) covering [b"", \xff) contiguously —
    # recruitment-time equi-depth seeds plus any resolutionBalancing
    # moves persisted since.  The broadcast \xff system range is implicit
    # (every epoch appends it; see _key_resolver_ranges).  A recovery
    # whose resolver count still matches adopts these boundaries instead
    # of re-seeding, so balanced cuts survive epoch changes.
    resolver_ranges: List[Tuple[bytes, bytes, int]] = \
        field(default_factory=list)
    # Region-failover record (the last epoch that adopted the remote
    # plane): the adopted version — min(end_version) across the locked
    # remote TLogs, below which every acked commit survived — and the
    # visible lost tail above it (0 for a drained switchover).  Durable
    # history: status keeps reporting the loss window across later
    # epochs and power failures, so an operator inspecting a recovered
    # cluster can still see what an undrained failover cost.
    failover_epoch: int = 0
    failover_version: Version = 0
    failover_lost_tail: Version = 0

    def pack(self) -> bytes:
        w = Writer().u32(self.epoch).i64(self.recovery_version)
        w.i64(self.map_version)
        w.u8(1 if self.backup_active else 0)
        w.u8(self.log_replication).u8(self.n_resolvers)
        tlog_ids = self.tlog_ids or [t.id for t in self.tlogs]
        w.u16(len(tlog_ids))
        for tid in tlog_ids:
            w.str_(tid)
        storage_ids = self.storage_ids or {
            tag: s.id for tag, s in self.storage_servers.items()}
        w.u16(len(storage_ids))
        for tag, sid in storage_ids.items():
            w.u32(tag).str_(sid)
        w.u16(len(self.key_servers_ranges))
        for b, e, team in self.key_servers_ranges:
            w.bytes_(b).bytes_(e).u16(len(team))
            for t in team:
                w.u32(t)
        w.u16(len(self.conf))
        for name, raw in self.conf.items():
            w.str_(name).bytes_(raw)
        rt_ids = self.remote_tlog_ids or [t.id for t in self.remote_tlogs]
        w.u16(len(rt_ids))
        for tid in rt_ids:
            w.str_(tid)
        rs_ids = self.remote_storage_ids or {
            tag: s.id for tag, s in self.remote_storage.items()}
        w.u16(len(rs_ids))
        for tag, sid in rs_ids.items():
            w.u32(tag).str_(sid)
        w.str_(self.backup_container)
        w.u8(1 if self.locked is not None else 0)
        if self.locked is not None:
            w.bytes_(self.locked)
        # u32 count: per-user tenancy targets millions of tenants and a
        # u16 here would wedge every future recovery past 65535.
        w.u32(len(self.tenants))
        for tid, tname in sorted(self.tenants.items()):
            w.i64(tid).bytes_(tname)
        w.i64(self.tenant_metadata_version)
        w.u16(len(self.resolver_ranges))
        for b, e, idx in self.resolver_ranges:
            w.bytes_(b).bytes_(e).i64(idx)
        w.u32(self.failover_epoch).i64(self.failover_version)
        w.i64(self.failover_lost_tail)
        return w.done()

    @staticmethod
    def coerce(raw) -> "Optional[DBCoreState]":
        """Normalize a CoordinatedState read: live DBCoreState objects pass
        through; the packed byte form (what survives a coordinator reboot)
        is unpacked; None stays None."""
        if isinstance(raw, (bytes, bytearray)):
            return DBCoreState.unpack(raw)
        return raw

    @classmethod
    def unpack(cls, blob: bytes) -> "DBCoreState":
        r = Reader(blob)
        epoch, rv = r.u32(), r.i64()
        map_version = r.i64()
        backup_active = r.u8() != 0
        log_rep, n_res = r.u8(), r.u8()
        tlog_ids = [r.str_() for _ in range(r.u16())]
        storage_ids = {r.u32(): r.str_() for _ in range(r.u16())}
        ranges = []
        for _ in range(r.u16()):
            b, e = r.bytes_(), r.bytes_()
            team = [r.u32() for _ in range(r.u16())]
            ranges.append((b, e, team))
        conf = {}
        if not r.at_end():
            for _ in range(r.u16()):
                name = r.str_()
                conf[name] = r.bytes_()
        remote_tlog_ids: List[str] = []
        remote_storage_ids: Dict[Tag, str] = {}
        backup_container = ""
        if not r.at_end():
            remote_tlog_ids = [r.str_() for _ in range(r.u16())]
            remote_storage_ids = {r.u32(): r.str_()
                                  for _ in range(r.u16())}
        if not r.at_end():
            backup_container = r.str_()
        locked: Optional[bytes] = None
        if not r.at_end() and r.u8():
            locked = r.bytes_()
        tenants: Dict[int, bytes] = {}
        tenant_metadata_version = 0
        if not r.at_end():
            for _ in range(r.u32()):
                tid = r.i64()
                tenants[tid] = r.bytes_()
            tenant_metadata_version = r.i64()
        resolver_ranges: List[Tuple[bytes, bytes, int]] = []
        if not r.at_end():
            for _ in range(r.u16()):
                rb, re_ = r.bytes_(), r.bytes_()
                resolver_ranges.append((rb, re_, r.i64()))
        failover_epoch = 0
        failover_version: Version = 0
        failover_lost_tail: Version = 0
        if not r.at_end():
            failover_epoch = r.u32()
            failover_version = r.i64()
            failover_lost_tail = r.i64()
        return cls(epoch=epoch, recovery_version=rv,
                   tlogs=[None] * len(tlog_ids), log_replication=log_rep,
                   storage_servers={t: None for t in storage_ids},
                   key_servers_ranges=ranges, n_resolvers=n_res,
                   tlog_ids=tlog_ids, storage_ids=storage_ids,
                   map_version=map_version, backup_active=backup_active,
                   conf=conf, remote_tlog_ids=remote_tlog_ids,
                   remote_storage={t: None for t in remote_storage_ids},
                   remote_storage_ids=remote_storage_ids,
                   backup_container=backup_container, locked=locked,
                   tenants=tenants,
                   tenant_metadata_version=tenant_metadata_version,
                   resolver_ranges=resolver_ranges,
                   failover_epoch=failover_epoch,
                   failover_version=failover_version,
                   failover_lost_tail=failover_lost_tail)


# ---------------------------------------------------------------------------
# The epoch end (reference master_server LOCKING_CSTATE, :886-1077)
# ---------------------------------------------------------------------------

@dataclass
class EpochEnd:
    """What the epoch end hands the recruitment of the next generation."""

    epoch: int
    recovery_version: Version
    # Old TLog index -> its lock reply (the TLogs that answered).
    locked: Dict[int, TLogLockReply]
    # Storage tag -> the old TLog that carries it, and its popped version.
    tag_holders: Dict[Tag, Any]
    popped: Dict[Tag, Version]
    # The shard map at the recovery version (snapshot + replayed deltas).
    key_servers_ranges: List[Tuple[bytes, bytes, List[Tag]]]
    txs_deltas: int
    master: Master


def epoch_end(prev: DBCoreState, old_tlogs: Dict[str, Any],
              clock: Callable[[], float] = time.monotonic) -> EpochEnd:
    """End `prev`'s epoch: lock its TLogs (`old_tlogs`, by id: the roles
    the boot scan rebuilt; a missing or unanswering one is skipped), pick
    for each storage tag the first locked TLog of its team and that
    log's popped version, set the recovery version to the least end
    version over the locked logs (every acknowledged commit reached all
    of them), replay the TXS_TAG shard-map deltas in (map_version,
    recovery version] onto the snapshot, and build the next epoch's
    Master there.  Raises master_recovery_failed when no TLog locks or a
    tag (or TXS_TAG) has no locked holder."""
    from .commit_proxy import LogSystemClient
    epoch = prev.epoch + 1
    tlog_ids = prev.tlog_ids or [t.id for t in prev.tlogs]
    logs = [old_tlogs.get(tid) for tid in tlog_ids]
    old_ls = LogSystemClient(logs, prev.log_replication)
    locked: Dict[int, TLogLockReply] = {}
    for i, t in enumerate(logs):
        if t is None:
            continue
        try:
            locked[i] = ask(t.lock, TLogLockRequest(epoch=epoch))
        except FdbError:
            continue
    if not locked:
        raise err("master_recovery_failed", "no old TLogs reachable")

    def holder_of(tag: Tag) -> int:
        holder = next((i for i in old_ls.team_for_tag(tag) if i in locked),
                      None)
        if holder is None:
            raise err("master_recovery_failed",
                      f"tag {tag} has no surviving TLog holder")
        return holder

    tag_holders: Dict[Tag, Any] = {}
    popped: Dict[Tag, Version] = {}
    for tag in sorted(prev.storage_ids or prev.storage_servers):
        holder = holder_of(tag)
        tag_holders[tag] = logs[holder]
        popped[tag] = locked[holder].tags.get(tag, 0)
    recovery_version = min(r.end_version for r in locked.values())
    map_rm: RangeMap = RangeMap(default=None)
    for b, e, team in prev.key_servers_ranges:
        map_rm.set_range(b, e, team)
    deltas = 0
    for v, msgs in peek_through(logs[holder_of(TXS_TAG)], TXS_TAG,
                                prev.map_version + 1, recovery_version):
        if prev.map_version < v:
            for m in msgs:
                deltas += apply_key_servers_mutation(map_rm, m)
    master = Master(recovery_version, clock=clock, epoch=epoch)
    TraceEvent("MasterEpochEnd").detail("Epoch", epoch).detail(
        "RecoveryVersion", recovery_version).detail(
        "Locked", len(locked)).detail("TxsDeltas", deltas).log()
    return EpochEnd(
        epoch=epoch, recovery_version=recovery_version, locked=locked,
        tag_holders=tag_holders, popped=popped,
        key_servers_ranges=[(b, e, team) for b, e, team in map_rm.ranges()
                            if team is not None],
        txs_deltas=deltas, master=master)
