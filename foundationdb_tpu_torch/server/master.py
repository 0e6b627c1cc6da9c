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
arrives ahead of its predecessor raises instead of parking (a proxy's
batcher waits for each version before it asks the next).  On a process
(run(process)), actors serve the MasterInterface with the same calls.

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

master_server (:781-1930) is one epoch of a SimFdbCluster's master
(server/cluster.py) through the reference's five recovery states:
reading_cstate (the core state from the coordinators and the worker
registry, which resolves a packed core state's ids after a whole-cluster
reboot), locking_cstate (the old TLogs locked over the network, a holder
and popped version a tag, the recovery version, the TXS_TAG replay),
recruiting (pools ranked by fitness; the first wave of TLogs, resolvers
and, at a cold boot, storage; then the ratekeeper, the data distributor,
the commit and GRV proxies; the resolution boundaries adopted or
re-seeded), writing_cstate (a lost race ends this master) and
accepting_commits (the version servers start, the role directory goes to
the cluster controller); then it watches the recruited roles and ends
the epoch when one fails, or when the committed configuration differs
from the recruited one.

Configuration as data (:991-1002, :1083-1090, :1775-1839): locking_cstate
replays the \\xff/conf/ mutations of TXS_TAG onto the core state's
`conf`, recruiting takes the static configuration overridden by it
(DatabaseConfiguration.with_conf), writing_cstate stores it, and in the
steady state _config_change_watch (a commit proxy's nudge) and
_config_poll (every 5 s of the loop's time) end the epoch on a field
whose committed value differs from the recruited one.

The coordinators change (:1841-1903): _coordinators_watch polls the
committed \\xff/coordinators every 2 s of the loop's time; when it
differs from the quorum this epoch recovered on, it seeds the new quorum
with the core state, forwards the old one (coordination.py
move_coordinated_state) and ends the epoch.

Left out: the balancing loop (no master_server steps a balancer; a
StaticCluster's caller steps it), the DBCoreState persistence of the
moved boundaries, and of the recovery state machine: region failover and
recruiting, storage caches, backup workers, TSS, tenants, the database
lock and log routers.
"""

from __future__ import annotations

import time
# The recovery log's wall stamp, recorded for chip_smoke.py's report
# only: nothing may ever branch on it.
from time import perf_counter as _perf_counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.error import FdbError, err
from ..core.knobs import server_knobs
from ..core.trace import Severity, TraceEvent
from ..core.wire import Reader, Writer
from ..txn.types import KeyRange, Version
from .failure import hold_wait_failure
from .interfaces import (RESOLVER_ALL, TXS_TAG, GetCommitVersionReply,
                         GetCommitVersionRequest, GetRawCommittedVersionReply,
                         GetRawCommittedVersionRequest, MasterInterface,
                         ReportRawCommittedVersionRequest, Reply,
                         ResolutionMetricsRequest, ResolutionSplitRequest,
                         Tag, TLogLockReply, TLogLockRequest, ask,
                         same_incarnation)
from .shardmap import RangeMap
from .system_data import (SYSTEM_KEYS_BEGIN, apply_key_servers_mutation,
                          parse_conf_mutation, parse_server_tag_mutation)
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
        # master_server's recovery: the state it is in, and each state
        # entered with the loop's time and the wall clock's.
        self.recovery_state = "unrecruited"
        self.recovery_log: List[Tuple[str, float, float]] = []
        self.interface = MasterInterface()
        self.interface.role = self   # in-process backref (not on the wire)

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

    # -- the serve loops (a process) -----------------------------------------
    @staticmethod
    async def _serve(stream, handler) -> None:
        async for req in stream.queue:
            handler(req)

    def run(self, process) -> list:
        """Register the interface's streams on `process` and spawn its
        serve loops there; their futures."""
        for stream in self.interface.streams():
            process.register(stream)
        i = self.interface
        return [
            process.spawn(self._serve(i.get_commit_version,
                                      self.serve_commit_version),
                          "master.getCommitVersion"),
            process.spawn(self._serve(i.report_live_committed_version,
                                      self.serve_report_committed),
                          "master.reportLiveCommittedVersion"),
            process.spawn(self._serve(i.get_live_committed_version,
                                      self.serve_live_committed),
                          "master.getLiveCommittedVersion"),
            process.spawn(hold_wait_failure(i.wait_failure),
                          "master.waitFailure")]


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


# ---------------------------------------------------------------------------
# The recovery state machine (reference masterserver.actor.cpp masterCore
# :1670; the JAX package's master.py master_server :781-1930)
# ---------------------------------------------------------------------------

RECOVERY_STATES = ("reading_cstate", "locking_cstate", "recruiting",
                   "writing_cstate", "accepting_commits")


def _own_team_spans(ss, tag: Tag, key_servers_ranges) -> None:
    """A storage server owns the spans of its teams and no other (the
    port's rule since PR 23's shard moves: a server never answers a read
    of a span it does not hold)."""
    ss.shards = RangeMap(default=("absent", 0))
    for b, e, team in key_servers_ranges:
        if tag in team:
            ss.shards.set_range(b, e, ("owned", 0))


def _differs(config, static, fname: str, raw: Optional[bytes]) -> bool:
    """Would the committed value `raw` of field `fname` recruit another
    value than the recruited `config`'s?  None (cleared) means the static
    configuration's.  The value is taken as with_conf takes it (the
    reference compares the printed text, so a value with_conf cannot
    parse, or an empty engine name, ends every later epoch too)."""
    want = getattr(static if raw is None else config.with_conf(
        {fname: raw}), fname, None)
    return getattr(config, fname, None) != want


def _known_fields() -> set:
    from .interfaces import DatabaseConfiguration
    return set(DatabaseConfiguration._INT_FIELDS) | \
        set(DatabaseConfiguration._STR_FIELDS)


async def _config_change_watch(master: Master, config, static) -> None:
    """Return (ending the epoch) on a proxy's nudge that names a field
    whose committed value differs from the recruited `config`'s, or on a
    broad clear (:1775-1797).  An unknown field, and a value equal to the
    recruited one, are ignored: ending the epoch for either would bounce
    every later epoch too (a retried, identical configure)."""
    known = _known_fields()
    async for req in master.interface.config_changed.queue:
        for fname, raw in (req or {}).items():
            if fname == "*":
                return
            if fname in known and _differs(config, static, fname, raw):
                return


async def _config_poll(coordinators, config, static, seeded_fields: set,
                       interval: float = 5.0) -> None:
    """The heal of a lost nudge (:1799-1839; the nudge is a one-way send,
    and a master recruited after the commit never got it): every
    `interval` seconds read the committed configuration and return on a
    real difference.  A committed field compares with the recruited
    value; a field this epoch took from the database and that is now
    cleared compares with the static configuration's; another absent
    field is
    ignored (a configuration set in code, never committed, must not end
    every epoch)."""
    from ..client.database import ClusterConnection, Database
    from ..client.management import get_configuration
    from ..core.scheduler import delay
    known = _known_fields()
    db = Database(ClusterConnection(coordinators))
    try:
        while True:
            await delay(interval)
            try:
                committed = await get_configuration(db)
            except Exception:  # noqa: BLE001 -- mid-recovery: next round
                continue
            for fname in sorted(known & (set(committed) | seeded_fields)):
                raw = committed.get(fname)
                if _differs(config, static, fname, raw):
                    TraceEvent("MasterConfigPollDiff").detail(
                        "Field", fname).detail(
                        "Recruited", str(getattr(config, fname, None))
                    ).detail("Committed", raw).log()
                    return
    finally:
        db.cluster.close()


async def _coordinators_watch(coordinators, cstate,
                              interval: float = 2.0) -> None:
    """Return (ending the epoch) once the quorum moved: when the committed
    \\xff/coordinators names another quorum than the one this epoch
    recovered on, seed it with the core state and forward the old one.
    A target that cannot take the move (it shares members with this
    quorum) is traced and left alone: ending the epoch would retry it
    forever."""
    from ..client.database import ClusterConnection, Database
    from ..client.management import _retrying
    from ..core.scheduler import delay
    from .coordination import move_coordinated_state, normalize_spec
    from .system_data import COORDINATORS_KEY
    parts = []
    for c in coordinators:
        addr = getattr(getattr(c, "reg_read", None), "address", None)
        if addr is None:
            return              # address-less coordinators cannot move
        parts.append(f"{addr.ip}:{addr.port}")
    cur_spec = ",".join(parts)
    db = Database(ClusterConnection(coordinators))
    try:
        while True:
            await delay(interval)

            async def go(t):
                return await t.get(COORDINATORS_KEY)
            try:
                raw = await _retrying(db, go)
            except Exception:  # noqa: BLE001 -- mid-recovery: next round
                continue
            try:
                want = normalize_spec(raw.decode()) if raw else ""
            except (ValueError, UnicodeDecodeError):
                continue        # an unparsable committed spec
            if want and want != cur_spec:
                TraceEvent("CoordinatorsChangeDetected").detail(
                    "From", cur_spec).detail("To", want).log()
                try:
                    await move_coordinated_state(cstate, want)
                except FdbError as e:
                    if e.name != "client_invalid_operation":
                        raise
                    TraceEvent("CoordinatorsMoveRejected",
                               Severity.Warn).detail("To", want).detail(
                        "Error", str(e)).log()
                    continue
                return
    finally:
        db.cluster.close()


async def master_server(master: Master, process, coordinators, config,
                        cc_interface) -> None:
    """One master epoch: recover through the five states, recruit every
    role of the transaction system onto registered workers, then serve
    until a recruited role fails (or this process dies), which ends the
    epoch; the cluster controller then recruits the next master.

    `master.recovery_log` records each state entered, with the loop's
    time and the wall clock's (perf_counter), for the recovery's split.
    A write of the core state that loses to another master's
    (coordinated_state_conflict) ends this one.  The wall stamps are
    bound at import (_perf_counter) and only recorded: nothing here
    branches on one."""
    from ..core.futures import swallow, wait_all, wait_any
    from ..core.rng import deterministic_random
    from ..core.scheduler import now, spawn
    from ..rpc.endpoint import RequestStream
    from .commit_proxy import LogSystemClient
    from .coordination import CoordinatedState
    from .failure import wait_failure_of
    from .interfaces import (FITNESS_NEVER, FITNESS_OKAY, FITNESS_UNSET,
                             FITNESS_WORST, GetWorkersRequest,
                             InitializeCommitProxyRequest,
                             InitializeDataDistributorRequest,
                             InitializeGrvProxyRequest,
                             InitializeRatekeeperRequest,
                             InitializeResolverRequest,
                             InitializeStorageRequest, InitializeTLogRequest,
                             MasterRegistrationRequest, ServerDBInfo,
                             role_fitness, zone_of)

    children: list = []

    def adopt(coro, name: str):
        f = process.spawn(coro, name)
        children.append(f)
        return f

    def enter(state: str, **details) -> None:
        master.recovery_state = state
        master.recovery_log.append((state, now(), _perf_counter()))
        ev = TraceEvent("MasterRecoveryState").detail("State", state)
        for k, v in details.items():
            ev.detail(k, v)
        ev.log()

    try:
        master._process = process
        for s in master.interface.streams():
            if s._endpoint is None:   # _init_master registers before it
                process.register(s)   # replies
        adopt(hold_wait_failure(master.interface.wait_failure),
              "master.waitFailure")

        # READING_CSTATE (:1678).  After a whole-cluster reboot the
        # coordinators hold the packed DBCoreState (ids only): the worker
        # registry resolves them to the roles the boot scans brought back.
        enter("reading_cstate")
        cstate = CoordinatedState(coordinators)
        prev: Optional[DBCoreState] = DBCoreState.coerce(await cstate.read())
        workers = await RequestStream.at(
            cc_interface.get_workers.endpoint).get_reply(GetWorkersRequest())
        if not workers:
            raise err("master_recovery_failed", "no workers registered")
        recovered_logs: Dict[str, Any] = {}
        recovered_storage: Dict[Tag, Any] = {}
        best_storage_ver: Dict[Tag, int] = {}
        for reg in workers:
            recovered_logs.update(reg.recovered_logs)
            for tag, iface in reg.recovered_storage.items():
                # Two workers holding one tag (a failed recruitment left
                # an empty one): the one with the most applied data wins.
                v = reg.storage_versions.get(tag, 0)
                if tag not in recovered_storage or \
                        v > best_storage_ver.get(tag, -1):
                    recovered_storage[tag] = iface
                    best_storage_ver[tag] = v

        # LOCKING_CSTATE: lock the previous TLog generation (the epoch
        # end), choose a holder of each tag, the recovery version, and
        # replay the shard map's TXS_TAG deltas onto the snapshot.
        old_tag_holders: Dict[Tag, Any] = {}
        old_popped: Dict[Tag, Version] = {}
        recovery_version: Version = 0
        key_servers_ranges: list = []
        if prev is not None:
            enter("locking_cstate", PrevEpoch=prev.epoch)
            tlog_ids = prev.tlog_ids or [t.id for t in prev.tlogs]
            old_tlogs = [recovered_logs.get(tid) or prev.tlogs[i]
                         for i, tid in enumerate(tlog_ids)]
            old_ls = LogSystemClient(old_tlogs, prev.log_replication)
            # Every old TLog at once: dead ones cost one failure delay.
            lock_futures = {
                i: RequestStream.at(t.lock.endpoint).get_reply(
                    TLogLockRequest(epoch=master.epoch))
                for i, t in enumerate(old_tlogs) if t is not None}
            await wait_all([swallow(f) for f in lock_futures.values()])
            locked = {i: f.get() for i, f in lock_futures.items()
                      if not f.is_error()}
            if not locked:
                raise err("master_recovery_failed", "no old TLogs reachable")

            def holder_of(tag: Tag) -> int:
                holder = next((i for i in old_ls.team_for_tag(tag)
                               if i in locked), None)
                if holder is None:
                    raise err("master_recovery_failed",
                              f"tag {tag} has no surviving TLog holder")
                return holder

            # Every acknowledged commit reached all old TLogs, so the least
            # end version covers every visible commit.
            recovery_version = min(r.end_version for r in locked.values())
            map_rm: RangeMap = RangeMap(default=None)
            for b, e, team in prev.key_servers_ranges:
                map_rm.set_range(b, e, team)
            n_deltas = 0
            rejoined: Dict[Tag, Any] = {}
            for v, msgs in peek_through(old_tlogs[holder_of(TXS_TAG)].role,
                                        TXS_TAG, prev.map_version + 1,
                                        recovery_version):
                if prev.map_version < v:
                    for m in msgs:
                        n_deltas += apply_key_servers_mutation(map_rm, m)
                        for tag, iface in \
                                parse_server_tag_mutation(m) or ():
                            rejoined[tag] = iface
                        # Configuration committed since the snapshot:
                        # this recovery adopts it (:991-1002).
                        for fname, raw in parse_conf_mutation(m) or ():
                            if fname == "*":
                                prev.conf.clear()
                            elif raw is None:
                                prev.conf.pop(fname, None)
                            else:
                                prev.conf[fname] = raw
            key_servers_ranges = [(b, e, team)
                                  for b, e, team in map_rm.ranges()
                                  if team is not None]
            # The registry's changes since the snapshot: a rejoined or
            # recruited server's newest incarnation, a retired tag gone.
            # A tag of the snapshot stays unless a clear retired it: after
            # a power failure the packed snapshot names it by id alone
            # (None here), and the worker registry resolves it below.
            merged = {t: i for t, i in prev.storage_servers.items()
                      if not (t in rejoined and rejoined[t] is None)}
            for t, i in rejoined.items():
                if i is not None and not same_incarnation(merged.get(t), i):
                    merged[t] = i
            prev.storage_servers = merged
            for tag in sorted(merged):
                holder = holder_of(tag)
                old_tag_holders[tag] = old_tlogs[holder]
                old_popped[tag] = locked[holder].tags.get(tag, 0)
            TraceEvent("MasterTxnStateReplayed").detail(
                "Deltas", n_deltas).detail(
                "FromVersion", prev.map_version).log()

        master.version = recovery_version
        master.last_epoch_end = recovery_version
        master.live_committed_version = recovery_version

        # The effective configuration (:1083-1090): the static one
        # overridden by the committed \xff/conf/ fields, so the role
        # counts below come from the database.  seeded_fields are those
        # taken from it: the poll compares one that is cleared later with
        # the static default.
        static_config = config
        seeded_fields: set = set()
        if prev is not None and prev.conf:
            config = config.with_conf(prev.conf)
            seeded_fields = {k for k, v in prev.conf.items()
                             if v is not None and k != "*"}
            TraceEvent("MasterConfigFromDatabase").detail(
                "Conf", {k: v.decode(errors="replace")
                         for k, v in prev.conf.items()}).log()

        # RECRUITING (:1741): place the roles on registered workers, each
        # role's pool the best-fitness band that has anyone in it.
        enter("recruiting", RecoveryVersion=recovery_version)

        def pool(role: str):
            ranked = sorted(
                (reg for reg in workers
                 if role_fitness(reg.process_class, role) < FITNESS_NEVER),
                key=lambda reg: (role_fitness(reg.process_class, role),
                                 reg.worker.id))
            for cut in (FITNESS_UNSET, FITNESS_OKAY, FITNESS_WORST):
                band = [reg.worker for reg in ranked
                        if role_fitness(reg.process_class, role) <= cut]
                if band:
                    return band
            return [reg.worker for reg in ranked] or \
                sorted((reg.worker for reg in workers), key=lambda x: x.id)

        stateless = pool("stateless")
        log_pool = pool("log")
        storage_pool = pool("storage")
        # Away from the master's own worker: a master kill must never also
        # take the only copy of a TLog.
        others = [x for x in stateless if x.id != process.name] or stateless
        log_others = [x for x in log_pool if x.id != process.name] or log_pool
        zone_by_worker_id = {
            reg.worker.id: (reg.locality[1] or reg.locality[2]
                            or reg.worker.id) for reg in workers}
        # Round-robin across failure zones, so a tag's TLog team
        # ((tag + j) % n) lands in distinct zones when there are enough.
        by_zone: Dict[str, list] = {}
        for w in log_others:
            by_zone.setdefault(zone_by_worker_id.get(w.id, w.id),
                               []).append(w)
        queues = [list(q) for q in by_zone.values()]
        log_others = []
        while queues:
            q = queues.pop(0)
            log_others.append(q.pop(0))
            if q:
                queues.append(q)

        def pick(i: int):
            return others[i % len(others)]

        # The first wave, in parallel: the new TLog generation (carrying
        # the surviving tags' data), the resolvers and, at a cold boot,
        # the storage servers.
        new_teams = LogSystemClient([None] * config.n_tlogs,
                                    config.log_replication)
        # Instance-unique ids: an empty WAL a failed attempt left must
        # never be taken for this generation's after a reboot.  The
        # ".e<epoch>" suffix stays last for the worker's file GC.
        tuid = deterministic_random().random_unique_id()[:8]
        tlog_futures = []
        for i in range(config.n_tlogs):
            mine = {t: h for t, h in old_tag_holders.items()
                    if i in new_teams.team_for_tag(t)}
            tlog_futures.append(RequestStream.at(
                log_others[i % len(log_others)].init_tlog.endpoint
            ).get_reply(InitializeTLogRequest(
                tlog_id=f"log{i}.{tuid}.e{master.epoch}",
                recovery_version=recovery_version, recover_tags=mine,
                recover_popped={t: old_popped.get(t, 0) for t in mine},
                epoch=master.epoch)))
        proxy_ids = [f"proxy{i}.e{master.epoch}"
                     for i in range(config.n_commit_proxies)]
        n_resolvers = max(1, min(config.n_resolvers, 255))
        resolver_futures = [RequestStream.at(
            pick(i + 1).init_resolver.endpoint).get_reply(
            InitializeResolverRequest(
                resolver_id=f"resolver{i}.e{master.epoch}",
                epoch=master.epoch, recovery_version=recovery_version,
                proxy_ids=proxy_ids))
            for i in range(n_resolvers)]
        storage_futures = []
        if prev is None:
            storage_futures = [RequestStream.at(
                storage_pool[i % len(storage_pool)].init_storage.endpoint
            ).get_reply(InitializeStorageRequest(
                ss_id=f"ss{i}", tag=i, engine=config.storage_engine))
                for i in range(config.n_storage)]
        tlogs = await wait_all(tlog_futures)
        resolvers = await wait_all(resolver_futures)
        if prev is not None:
            # Storage outlives epochs: the live servers, or the ones the
            # boot scans rebuilt (same tag) after a reboot.
            storage_servers = {}
            for tag, iface in prev.storage_servers.items():
                resolved = recovered_storage.get(tag) or iface
                if resolved is None:
                    raise err("master_recovery_failed",
                              f"storage tag {tag} not yet re-registered")
                storage_servers[tag] = resolved
        else:
            ssis = await wait_all(storage_futures)
            storage_servers = dict(enumerate(ssis))
            cuts = config.storage_boundaries
            if cuts is None:
                cuts = _split_points(config.n_storage)
            bounds = [b""] + list(cuts) + [b"\xff\xff"]
            for i in range(config.n_storage):
                # A zone-diverse team (reference PolicyAcross zoneid):
                # forward from tag i, tags of new zones first, then any.
                team = [Tag(i)]
                zones = {zone_of(ssis[i])}
                for j in range(1, config.n_storage):
                    if len(team) >= config.storage_replication:
                        break
                    cand = Tag((i + j) % config.n_storage)
                    if zone_of(ssis[cand]) not in zones:
                        team.append(cand)
                        zones.add(zone_of(ssis[cand]))
                j = 1
                while len(team) < config.storage_replication and \
                        len(team) < config.n_storage:
                    cand = Tag((i + j) % config.n_storage)
                    if cand not in team:
                        team.append(cand)
                    j += 1
                key_servers_ranges.append((bounds[i], bounds[i + 1], team))
        # A server that has not served yet (fresh, or rebuilt by a boot
        # scan) learns which spans it owns.
        for tag, iface in storage_servers.items():
            role = getattr(iface, "role", None)   # a registry copy has none
            if role is not None and role.log_system is None:
                _own_team_spans(role, tag, key_servers_ranges)

        # The second wave (:1384): ratekeeper, data distributor, proxies.
        ratekeeper = await RequestStream.at(
            pick(0).init_ratekeeper.endpoint).get_reply(
            InitializeRatekeeperRequest(
                rk_id=f"rk.e{master.epoch}",
                storage_interfaces=storage_servers,
                tlog_interfaces=list(tlogs),
                resolver_interfaces=list(resolvers)))
        data_distributor = await RequestStream.at(
            pick(2).init_data_distributor.endpoint).get_reply(
            InitializeDataDistributorRequest(
                dd_id=f"dd.e{master.epoch}", epoch=master.epoch,
                storage_interfaces=storage_servers,
                key_servers_ranges=key_servers_ranges,
                replication=config.storage_replication))
        # The resolution boundaries (:1403): the persisted user-keyspace
        # ownership when the resolver count still matches, else re-seeded
        # equi-depth from the shard map.
        prev_rr = list(prev.resolver_ranges) if prev is not None else []
        if _valid_resolver_ranges(prev_rr, n_resolvers):
            key_resolvers_ranges = _key_resolver_ranges(
                n_resolvers, user_ranges=prev_rr)
        else:
            key_resolvers_ranges = _key_resolver_ranges(
                n_resolvers, boundaries=seed_resolver_boundaries(
                    key_servers_ranges, n_resolvers))
        resolver_user_ranges = [r for r in key_resolvers_ranges
                                if r[2] != RESOLVER_ALL]
        commit_proxies = await wait_all([RequestStream.at(
            pick(i).init_commit_proxy.endpoint).get_reply(
            InitializeCommitProxyRequest(
                proxy_id=proxy_ids[i], epoch=master.epoch,
                master=master.interface, resolvers=resolvers, tlogs=tlogs,
                key_resolvers_ranges=key_resolvers_ranges,
                key_servers_ranges=key_servers_ranges,
                storage_interfaces=storage_servers,
                recovery_version=recovery_version))
            for i in range(config.n_commit_proxies)])
        grv_proxies = await wait_all([RequestStream.at(
            pick(i + 1).init_grv_proxy.endpoint).get_reply(
            InitializeGrvProxyRequest(
                proxy_id=f"grv{i}.e{master.epoch}", epoch=master.epoch,
                master=master.interface, tlogs=tlogs, ratekeeper=ratekeeper))
            for i in range(config.n_grv_proxies)])

        # WRITING_CSTATE (:1908): the new generation made durable.  A
        # conflict means another master won: this one dies.
        enter("writing_cstate")
        await cstate.write(DBCoreState(
            epoch=master.epoch, recovery_version=recovery_version,
            tlogs=tlogs, log_replication=config.log_replication,
            storage_servers=storage_servers,
            key_servers_ranges=key_servers_ranges, n_resolvers=n_resolvers,
            resolver_ranges=resolver_user_ranges,
            map_version=recovery_version,
            conf=dict(prev.conf) if prev is not None else {}))

        # ACCEPTING_COMMITS (:1943): serve versions and announce.
        i = master.interface
        adopt(Master._serve(i.get_commit_version,
                            master.serve_commit_version),
              "master.getCommitVersion")
        adopt(Master._serve(i.report_live_committed_version,
                            master.serve_report_committed),
              "master.reportLiveCommittedVersion")
        adopt(Master._serve(i.get_live_committed_version,
                            master.serve_live_committed),
              "master.getLiveCommittedVersion")
        db_info = ServerDBInfo(
            epoch=master.epoch, recovery_state="accepting_commits",
            recovery_version=recovery_version, master=master.interface,
            grv_proxies=grv_proxies, commit_proxies=commit_proxies,
            resolvers=resolvers, tlogs=tlogs,
            storage_servers=storage_servers, ratekeeper=ratekeeper,
            data_distributor=data_distributor,
            cluster_controller=cc_interface,
            log_replication=config.log_replication,
            storage_engine=config.storage_engine,
            resolver_ranges=key_resolvers_ranges)
        enter("accepting_commits", Epoch=master.epoch)
        await RequestStream.at(
            cc_interface.master_registration.endpoint).get_reply(
            MasterRegistrationRequest(epoch=master.epoch, db_info=db_info))

        # Steady state: until a recruited role of the transaction system
        # fails (reference: the master dies on tlog_failed,
        # commit_proxy_failed, resolver_failed) or the committed
        # configuration differs from the recruited one.
        role_failures = [
            spawn(wait_failure_of(x), "master.roleWatch")
            for x in (tlogs + resolvers + commit_proxies + grv_proxies +
                      [ratekeeper])]
        config_watch = spawn(
            _config_change_watch(master, config, static_config),
            "master.confWatch")
        config_poll = spawn(
            _config_poll(coordinators, config, static_config,
                         seeded_fields), "master.confPoll")
        coord_watch = spawn(_coordinators_watch(coordinators, cstate),
                            "master.coordWatch")
        children.extend(role_failures)
        children.extend([config_watch, config_poll, coord_watch])
        idx, _ = await wait_any(role_failures +
                                [config_watch, config_poll, coord_watch])
        reason = ("coordinators changed" if idx == len(role_failures) + 2
                  else "configuration changed" if idx >= len(role_failures)
                  else "recruited role failed")
        TraceEvent("MasterTerminated", Severity.Warn).detail(
            "Epoch", master.epoch).detail("Reason", reason).detail(
            "RoleIdx", idx).log()
    except FdbError as e:
        TraceEvent("MasterRecoveryFailed", Severity.Warn).detail(
            "Epoch", master.epoch).detail("Error", e.name).detail(
            "Message", str(e)).log()
    except Exception as e:  # noqa: BLE001 -- the controller treats any
        # master death alike; the cause must show in the trace.
        TraceEvent("MasterRecoveryFailed", Severity.Error).detail(
            "Epoch", master.epoch).detail("Error", repr(e)).log()
    finally:
        for c in children:
            if not c.is_ready():
                c.cancel()
