"""The roles' messages (trimmed copy of
foundationdb_tpu/server/interfaces.py, reference
fdbserver/ResolverInterface.h:33,81-123, fdbclient/CommitProxyInterface.h,
fdbserver/MasterInterface.h, fdbserver/TLogInterface.h and
fdbclient/StorageServerInterface.h).

The Resolver role's and the commit proxy's dataclasses, the master's
version messages, the GRV request and reply with the transaction
priorities, the key-location request, the TLog's commit, peek, pop and
lock, the storage server's point and range reads, the tags (Tag,
TXS_TAG), RESOLVER_ALL and a reply that keeps its value.  `reply` is any
object with send(value) (and, for a commit, send_error(error)); the role
answers each request through it.

Each role's interface bundles its request streams (rpc/endpoint.py
RequestStream) with the reference's names and priorities: the master's,
the Resolver's, a commit proxy's, a GRV proxy's, a TLog's and a storage
server's (its reads, the four streams of data distribution and its
waitFailure; the reference's other storage streams serve watches, the
queuing metrics, the wiggle's engine migration and TSS, which the port
does not have), and the data distributor's.  The data distribution
messages are the reference's (:848-924): a destination's fetch of a
shard, a source's snapshot for it, the poll of a shard's size and the
removal of a shard a move vacated.  A role's actors read them when it runs on a process
(`run(process)`); the network (rpc/network.py, rpc/real_network.py)
carries the requests, and rpc/serde.py encodes each interface as the
reference's frame does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.scheduler import TaskPriority
from ..rpc.endpoint import RequestStream
from ..txn.types import (CommitResult, CommitTransactionRef, KeyRange,
                         Mutation, Version)

# keyResolvers value of the \xff system range: owned by EVERY resolver of
# the epoch (foundationdb_tpu/server/interfaces.py:53).
RESOLVER_ALL: int = -1

# A storage server's tag in the log system (foundationdb_tpu/server/
# interfaces.py:26-29), and the tag of the metadata (state-transaction)
# stream, reference txsTag: u32-max-adjacent so it packs through the
# wire format.
Tag = int
TXS_TAG: Tag = 0xFFFFFFFE


class Reply:
    """A reply that keeps what it was sent, value or error, for a caller
    that hands a request to a role and reads the answer after the call.
    It is answered once: a second answer raises."""

    __slots__ = ("value", "error", "sent")

    def __init__(self) -> None:
        self.value: Any = None
        self.error: Any = None
        self.sent = False

    def send(self, value: Any = None) -> None:
        self._answer()
        self.value = value

    def send_error(self, error: Exception) -> None:
        self._answer()
        self.error = error

    def _answer(self) -> None:
        if self.sent:
            raise RuntimeError("a reply is answered once")
        self.sent = True


def ask(serve, req):
    """Hand `req` to a role's `serve` method with a fresh Reply and return
    what it was sent, raising the error it was answered with; a role that
    leaves it unanswered raises broken_promise, as the reference's
    dropped ReplyPromise does."""
    from ..core.error import err
    req.reply = Reply()
    serve(req)
    if not req.reply.sent:
        raise err("broken_promise", f"{type(req).__name__}: no reply")
    if req.reply.error is not None:
        raise req.reply.error
    return req.reply.value


def call(role, serve: str, stream: str, req, over_network: bool):
    """The Future of `role`'s answer to `req`: over the network to the
    interface's stream named `stream` when `over_network` (the role runs
    on a process), else the role's method named `serve` within the call
    (ask), its answer or the FdbError it answered with already set."""
    from ..core.error import FdbError
    from ..core.futures import error_future, ready_future
    if over_network:
        return RequestStream.at(
            getattr(role.interface, stream).endpoint).get_reply(req)
    try:
        return ready_future(ask(getattr(role, serve), req))
    except FdbError as e:
        return error_future(e)


def run_within_call(coro):
    """Run a role's coroutine to its end within the call and return its
    value (or raise its error): every Future it awaits must already be
    set, as `call(..., over_network=False)` gives them."""
    try:
        coro.send(None)
    except StopIteration as stop:
        return stop.value
    coro.close()
    raise RuntimeError("a call within the call waited on the network")


@dataclass
class CommitTransactionRequest:
    """A client's commit (foundationdb_tpu/server/interfaces.py:322,
    reference fdbclient/CommitProxyInterface.h)."""

    transaction: CommitTransactionRef
    debug_id: str = ""
    # Transaction-repair opt-in (sched/repair.py): the client declares
    # its mutations remain valid under re-read (blind writes / atomic
    # ops), so a staleness-only abort may be re-stamped at a fresh read
    # version and re-resolved server-side.  repair_attempt counts the
    # server-side retries already spent (proxy-local bookkeeping; rides
    # the request so the re-enqueued copy carries its budget).
    repair_eligible: bool = False
    repair_attempt: int = 0
    reply: Any = None


@dataclass
class CommitID:
    """Successful commit reply (CommitProxyInterface.h:133)."""

    version: Version
    txn_batch_id: int = 0
    # This transaction's order within its commit batch — the low 2 bytes
    # of its versionstamp (reference CommitID transactionBatchIndex).
    txn_batch_index: int = 0


@dataclass
class ResolveTransactionBatchRequest:
    prev_version: Version
    version: Version
    last_received_version: Version
    transactions: List[CommitTransactionRef]
    # Indices into `transactions` of the batch's state (metadata)
    # transactions.
    txn_state_transactions: List[int] = field(default_factory=list)
    proxy_id: str = ""
    # Commit-batch span context: stamps the resolver's CommitDebug
    # trace events.
    span: str = ""
    reply: Any = None


@dataclass
class ResolveTransactionBatchReply:
    committed: List[CommitResult]
    # State transactions (reference Resolver.actor.cpp:220-249): entries
    # (version, origin_proxy_id, seq, mutations, local_verdict) for every
    # state txn resolved since the requesting proxy's
    # last_received_version, other proxies' only.
    state_transactions: List[Any] = field(default_factory=list)
    # {local txn index: [(begin, end), ...]}: conflicting read ranges of
    # CONFLICT transactions that set report_conflicting_keys.
    conflicting_ranges: Dict[int, List[Any]] = field(default_factory=dict)
    # {local txn index: exact?} for every CONFLICT verdict: True iff the
    # backend attributed the true culprit range(s) rather than blaming
    # the whole read set.
    attribution_exact: Dict[int, bool] = field(default_factory=dict)


@dataclass
class ResolutionMetricsRequest:
    """Conflict ranges resolved since the last poll (reference
    ResolutionMetricsRequest, Resolver.actor.cpp:341)."""

    reply: Any = None    # -> int


@dataclass
class ResolverHeatRequest:
    """The conflict-heat feed: top-k decayed conflict ranges with their
    per-tag / per-tenant attribution (ConflictHeatTracker.feed_rows)."""

    top_k: int = 32
    reply: Any = None    # -> List[tuple] feed rows


@dataclass
class ResolutionSplitRequest:
    """A key splitting the measured load of [begin, end) roughly at
    `fraction` (reference ResolutionSplitRequest,
    Resolver.actor.cpp:348)."""

    begin: bytes = b""
    end: bytes = b""
    fraction: float = 0.5
    reply: Any = None    # -> Optional[bytes]


# -- master (reference fdbserver/MasterInterface.h) -------------------------
@dataclass
class GetCommitVersionRequest:
    """Proxy -> master: allocate the next commit version for a batch.
    request_num orders one proxy's requests (the master replies in order)."""

    request_num: int
    proxy_id: str
    reply: Any = None


@dataclass
class GetCommitVersionReply:
    version: Version
    prev_version: Version
    # (KeyRange, resolver_idx, change_version) triples
    resolver_changes: List[Tuple[KeyRange, int, Version]] = \
        field(default_factory=list)
    resolver_changes_version: Version = 0


@dataclass
class ReportRawCommittedVersionRequest:
    """Proxy -> master: a version is fully committed (logged); advances
    the live committed version the GRV path reads
    (masterserver.actor.cpp:1217)."""

    version: Version
    reply: Any = None


@dataclass
class GetRawCommittedVersionRequest:
    reply: Any = None


@dataclass
class GetRawCommittedVersionReply:
    version: Version


class TransactionPriority:
    """GRV priorities (reference TransactionPriority, GrvProxyServer
    queues)."""

    BATCH = 0
    DEFAULT = 1
    IMMEDIATE = 2


@dataclass
class GetReadVersionRequest:
    """A client's read-version request (foundationdb_tpu/server/
    interfaces.py:382); `transaction_count` transactions share it."""

    priority: int = TransactionPriority.DEFAULT
    transaction_count: int = 1
    debug_id: str = ""
    # Throttling tags and tenant identity: carried, enforced by nothing
    # in the port (no tag throttles, no predictor at GRV).
    tags: tuple = ()
    tenant_id: int = -1
    reply: Any = None


@dataclass
class GetReadVersionReply:
    version: Version
    locked: bool = False
    # tag -> tps ceiling currently enforced (none in the port).
    tag_throttles: Any = None


@dataclass
class GetKeyServerLocationsRequest:
    """The shards over [begin, end) with their teams, at most `limit`,
    the last ones first when `reverse` (foundationdb_tpu/server/
    interfaces.py:349)."""

    begin: bytes
    end: bytes
    limit: int = 100
    reverse: bool = False
    reply: Any = None


@dataclass
class GetKeyServerLocationsReply:
    # [(range, [storage interfaces])]: shard boundaries with their teams.
    results: List[Tuple[KeyRange, List[Any]]]


class MasterInterface:
    """The reference's MasterInterface.  config_changed carries a commit
    proxy's one-way nudge after a committed \\xff/conf/ change (the
    fields and their new values), which the master's configuration
    watch reads; backup_changed is registered with the rest, so the
    interface's frame is the reference's, and nothing serves it: the
    port has no backup."""

    def __init__(self) -> None:
        self.get_commit_version = RequestStream(
            "master.getCommitVersion", TaskPriority.ProxyGetRawCommittedVersion)
        self.report_live_committed_version = RequestStream(
            "master.reportLiveCommittedVersion",
            TaskPriority.ProxyGetRawCommittedVersion)
        self.get_live_committed_version = RequestStream(
            "master.getLiveCommittedVersion",
            TaskPriority.ProxyGetRawCommittedVersion)
        self.wait_failure = RequestStream(
            "master.waitFailure", TaskPriority.FailureMonitor)
        self.config_changed = RequestStream(
            "master.configChanged", TaskPriority.DefaultEndpoint)
        self.backup_changed = RequestStream(
            "master.backupChanged", TaskPriority.DefaultEndpoint)

    def streams(self) -> List[RequestStream]:
        return [self.get_commit_version, self.report_live_committed_version,
                self.get_live_committed_version, self.wait_failure,
                self.config_changed, self.backup_changed]


class ResolverInterface:
    def __init__(self, resolver_id: str = "") -> None:
        self.id = resolver_id
        self.resolve = RequestStream(
            "resolver.resolve", TaskPriority.ProxyResolverReply)
        self.metrics = RequestStream("resolver.metrics",
                                     TaskPriority.ResolutionMetrics)
        self.split = RequestStream("resolver.split",
                                   TaskPriority.ResolutionMetrics)
        self.heat = RequestStream("resolver.heat",
                                  TaskPriority.ResolutionMetrics)
        self.wait_failure = RequestStream("resolver.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.resolve, self.metrics, self.split, self.heat,
                self.wait_failure]


class CommitProxyInterface:
    def __init__(self, proxy_id: str = "") -> None:
        self.id = proxy_id
        self.commit = RequestStream("proxy.commit", TaskPriority.ProxyCommit)
        self.get_key_servers_locations = RequestStream(
            "proxy.getKeyServersLocations",
            TaskPriority.DefaultPromiseEndpoint)
        self.wait_failure = RequestStream("proxy.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.commit, self.get_key_servers_locations,
                self.wait_failure]


class GrvProxyInterface:
    def __init__(self, proxy_id: str = "") -> None:
        self.id = proxy_id
        self.get_consistent_read_version = RequestStream(
            "grvproxy.getConsistentReadVersion",
            TaskPriority.GetConsistentReadVersion)
        self.wait_failure = RequestStream("grvproxy.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.get_consistent_read_version, self.wait_failure]


class TLogInterface:
    """The reference's TLogInterface but its queuing-metrics stream
    (the port's ratekeeper polls no TLog)."""

    def __init__(self, tlog_id: str = "") -> None:
        self.id = tlog_id
        self.commit = RequestStream("tlog.commit", TaskPriority.TLogCommit)
        self.peek = RequestStream("tlog.peek", TaskPriority.TLogPeek)
        self.pop = RequestStream("tlog.pop", TaskPriority.TLogPop)
        self.confirm_running = RequestStream(
            "tlog.confirmRunning", TaskPriority.TLogConfirmRunning)
        self.lock = RequestStream("tlog.lock", TaskPriority.TLogCommit)
        self.wait_failure = RequestStream("tlog.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.commit, self.peek, self.pop, self.confirm_running,
                self.lock, self.wait_failure]


class StorageServerInterface:
    def __init__(self, ss_id: str = "", tag: "Tag" = 0) -> None:
        self.id = ss_id
        self.tag = tag
        # (dcid, zoneid, machineid) of the hosting process, stamped when
        # the server starts on one: data distribution ranks replacement
        # replicas by zone (server/policy.py).
        self.locality = ("", "", "")
        self.get_value = RequestStream(
            "storage.getValue", TaskPriority.DefaultPromiseEndpoint)
        self.get_key_values = RequestStream(
            "storage.getKeyValues", TaskPriority.DefaultPromiseEndpoint)
        # Data distribution (reference fetchKeys and ShardMetrics).
        self.fetch_keys = RequestStream(
            "storage.fetchKeys", TaskPriority.FetchKeys)
        self.fetch_shard = RequestStream(
            "storage.fetchShard", TaskPriority.FetchKeys)
        self.shard_metrics = RequestStream(
            "storage.shardMetrics", TaskPriority.DefaultEndpoint)
        self.remove_shard = RequestStream(
            "storage.removeShard", TaskPriority.DefaultEndpoint)
        # The perpetual wiggle's engine rewrite (MigrateEngineRequest).
        self.migrate_engine = RequestStream(
            "storage.migrateEngine", TaskPriority.DefaultEndpoint)
        self.wait_failure = RequestStream("storage.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.get_value, self.get_key_values, self.fetch_keys,
                self.fetch_shard, self.shard_metrics, self.remove_shard,
                self.migrate_engine, self.wait_failure]


# -- TLog (reference fdbserver/TLogInterface.h) ------------------------------
@dataclass
class TLogCommitRequest:
    prev_version: Version
    version: Version
    known_committed_version: Version
    # tag -> the mutations for that tag at this version.
    messages: Dict[Tag, List[Mutation]]
    reply: Any = None


@dataclass
class TLogPeekRequest:
    tag: Tag
    begin: Version
    reply: Any = None


@dataclass
class TLogPeekReply:
    # [(version, [mutations])] for the tag, version-ascending.
    messages: List[Tuple[Version, List[Mutation]]]
    end: Version               # exclusive: peek again from here
    max_known_version: Version


@dataclass
class TLogPopRequest:
    tag: Tag
    to: Version
    reply: Any = None


@dataclass
class TLogConfirmRunningRequest:
    reply: Any = None


@dataclass
class TLogLockRequest:
    """Master -> old-generation TLog at epoch end: stop accepting commits
    and report state (reference TLogInterface lock / epoch end)."""

    epoch: int
    reply: Any = None


@dataclass
class TLogLockReply:
    end_version: Version            # highest appended version
    known_committed_version: Version
    tags: Dict[Tag, Version]        # tag -> popped-through version


# -- storage server (reference fdbclient/StorageServerInterface.h) ----------
@dataclass
class GetValueRequest:
    key: bytes
    version: Version
    reply: Any = None


@dataclass
class GetValueReply:
    value: Optional[bytes]
    version: Version = 0


@dataclass
class GetKeyValuesRequest:
    begin: bytes
    end: bytes
    version: Version
    limit: int = 1000
    limit_bytes: int = 1 << 20
    reverse: bool = False
    reply: Any = None


@dataclass
class GetKeyValuesReply:
    data: List[Tuple[bytes, bytes]]
    more: bool = False
    version: Version = 0


# -- data distribution (reference fetchKeys, storageserver.actor.cpp
# :107-123, StorageMetrics and removeDataRange) ------------------------------
@dataclass
class FetchKeysRequest:
    """Data distributor -> destination storage server: become a replica
    of [begin, end), from a snapshot of one of `sources`
    (StorageServerInterfaces), served at or above `min_version` (the
    MoveKeys phase-1 commit: the mutations in (snapshot, phase 1] went
    to the old team only)."""

    begin: bytes = b""
    end: bytes = b""
    sources: List[Any] = field(default_factory=list)
    min_version: Version = 0
    reply: Any = None


@dataclass
class FetchShardRequest:
    """Destination -> source storage server: the rows of [begin, end) at
    the source's version, floored at min_version."""

    begin: bytes = b""
    end: bytes = b""
    min_version: Version = 0
    reply: Any = None    # -> FetchShardReply


@dataclass
class FetchShardReply:
    data: List[Any] = field(default_factory=list)   # [(key, value)]
    version: Version = 0


@dataclass
class GetShardMetricsRequest:
    """Data distributor -> storage server: the bytes of [begin, end) and,
    past split_threshold, a key that halves them (reference
    StorageMetrics waitMetrics / getSplitPoints)."""

    begin: bytes = b""
    end: bytes = b""
    split_threshold: int = 1 << 30
    reply: Any = None    # -> (bytes, Optional[split key])


@dataclass
class RemoveShardRequest:
    """Data distributor -> storage server after a move: stop owning
    [begin, end) and drop its rows (reference removeDataRange)."""

    begin: bytes = b""
    end: bytes = b""
    reply: Any = None


class DataDistributorInterface:
    def __init__(self, dd_id: str = "") -> None:
        self.id = dd_id
        self.wait_failure = RequestStream("dd.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.wait_failure]


# ---------------------------------------------------------------------------
# The control plane: worker, cluster controller, recruitment (reference
# fdbserver/WorkerInterface.actor.h Initialize*Request,
# fdbserver/ClusterController.actor.cpp RegisterWorkerRequest,
# fdbserver/ServerDBInfo.h ServerDBInfo, fdbclient ClientDBInfo; the JAX
# package's interfaces.py:56-77, :164-227 and :565-1063)
# ---------------------------------------------------------------------------

def zone_of(iface) -> str:
    """Failure-zone key of a storage interface: explicit zoneid, else the
    machine, else the server id (reference LocalityData::zoneId
    defaulting to machineId)."""
    loc = getattr(iface, "locality", None) or ("", "", "")
    return loc[1] or loc[2] or getattr(iface, "id", "")


def same_incarnation(a, b) -> bool:
    """Do two interface handles name the same role incarnation?  Judged by
    the wait_failure endpoint: a decoded message is a fresh copy, so
    object identity means nothing across the wire."""
    if a is b:
        return a is not None
    ea = getattr(getattr(a, "wait_failure", None), "_endpoint", None)
    eb = getattr(getattr(b, "wait_failure", None), "_endpoint", None)
    return ea is not None and ea == eb


@dataclass
class DatabaseConfiguration:
    """Role counts and replication (reference
    fdbclient/DatabaseConfiguration.h), without the reference's region,
    storage-cache and TSS fields (rpc/serde.py writes their defaults).
    `storage_boundaries`, the port's own and never on the wire: the
    interior cut keys of a cold boot's shard map (None: the reference's
    n_storage - 1 even byte splits), as StaticCluster takes them."""

    n_tlogs: int = 1
    n_commit_proxies: int = 1
    n_grv_proxies: int = 1
    n_resolvers: int = 1
    n_storage: int = 2
    log_replication: int = 1
    storage_replication: int = 1
    conflict_backend: Optional[str] = None
    storage_engine: str = "memory"     # memory | btree (reference ssd-2)
    min_workers: int = 1
    storage_boundaries: Optional[List[bytes]] = None

    _INT_FIELDS = ("n_tlogs", "n_commit_proxies", "n_grv_proxies",
                   "n_resolvers", "n_storage", "log_replication",
                   "storage_replication", "min_workers")
    _STR_FIELDS = ("conflict_backend", "storage_engine")

    def with_conf(self, conf: Dict[str, Optional[bytes]]
                  ) -> "DatabaseConfiguration":
        """This configuration overridden by committed \\xff/conf/ values
        (reference :196-230, DatabaseConfiguration parsed from system
        keys): an absent or None field keeps this one's value, "*" (a
        broad clear) and a field the port does not keep are skipped, and
        an integer field whose value does not parse keeps its own."""
        import dataclasses as _dc
        out = _dc.replace(self)
        for name, raw in conf.items():
            if raw is None or name == "*":
                continue
            if name in self._INT_FIELDS:
                try:
                    setattr(out, name, int(raw))
                except ValueError:
                    pass
            elif name in self._STR_FIELDS:
                setattr(out, name, raw.decode() or None)
        return out


@dataclass
class ServerDBInfo:
    """Cluster-wide role directory broadcast by the cluster controller."""

    epoch: int = 0                       # master generation (recoveryCount)
    recovery_state: str = "unrecruited"  # see the master's recovery states
    recovery_version: Version = 0
    master: Any = None                   # MasterInterface
    grv_proxies: List[Any] = field(default_factory=list)
    commit_proxies: List[Any] = field(default_factory=list)
    resolvers: List[Any] = field(default_factory=list)
    tlogs: List[Any] = field(default_factory=list)
    storage_servers: Dict[Tag, Any] = field(default_factory=dict)
    ratekeeper: Any = None
    data_distributor: Any = None
    # The recruiting cluster controller (reference
    # ServerDBInfo.clusterInterface).
    cluster_controller: Any = None
    # The reference's region plane: empty in the port (no regions).
    log_routers: List[Any] = field(default_factory=list)
    remote_tlogs: List[Any] = field(default_factory=list)
    remote_storage: Dict[Tag, Any] = field(default_factory=dict)
    # TLog replication factor of this generation.
    log_replication: int = 1
    storage_engine: str = ""
    # Resolution-plane assignment of this generation: (begin, end,
    # resolver index) with RESOLVER_ALL for the broadcast system range.
    resolver_ranges: List[Tuple[bytes, bytes, int]] = \
        field(default_factory=list)
    regions: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ClientDBInfo:
    """What clients need (reference fdbclient ClientDBInfo)."""

    epoch: int = 0
    grv_proxies: List[Any] = field(default_factory=list)
    commit_proxies: List[Any] = field(default_factory=list)
    protocol_version: int = 0


@dataclass
class PingRequest:
    """Health ping (reference fdbrpc PingRequest): answered at once."""

    echo: int = 0
    reply: Any = None


@dataclass
class RegisterWorkerRequest:
    """A worker's registration with the cluster controller, with the
    durable roles its boot scan brought back and the applied version of
    each storage role (the tiebreak when two workers hold one tag).  The
    reference's machine stats, metrics document and health report are
    not kept (rpc/serde.py writes them empty)."""

    worker: "WorkerInterface"
    process_class: str = "unset"
    recovered_logs: Dict[str, Any] = field(default_factory=dict)
    recovered_storage: Dict[int, Any] = field(default_factory=dict)
    storage_versions: Dict[int, int] = field(default_factory=dict)
    # (dcid, zoneid, machineid) of the hosting process.
    locality: tuple = ("", "", "")
    reply: Any = None


@dataclass
class WorkerRegistration:
    """One registry entry of the cluster controller (get_workers)."""

    worker: "WorkerInterface"
    process_class: str = "unset"
    recovered_logs: Dict[str, Any] = field(default_factory=dict)
    recovered_storage: Dict[int, Any] = field(default_factory=dict)
    storage_versions: Dict[int, int] = field(default_factory=dict)
    locality: tuple = ("", "", "")
    registered_at: float = 0.0


# Placement fitness (reference flow/ProcessClass machineClassFitness and
# ClusterController.actor.cpp:3576): lower is better.  BEST=0 (dedicated
# class), GOOD=1, UNSET=2, OKAY=3, WORST=4 (only when nothing better
# registered), NEVER=9.
FITNESS_BEST, FITNESS_GOOD, FITNESS_UNSET = 0, 1, 2
FITNESS_OKAY, FITNESS_WORST, FITNESS_NEVER = 3, 4, 9

_ROLE_FITNESS: Dict[str, Dict[str, int]] = {
    "master": {"master": FITNESS_BEST, "stateless": FITNESS_GOOD,
               "unset": FITNESS_UNSET, "log": FITNESS_OKAY,
               "transaction": FITNESS_OKAY, "storage": FITNESS_WORST,
               "coordinator": FITNESS_NEVER, "tester": FITNESS_NEVER},
    # Proxies, resolvers, ratekeeper, data distributor.
    "stateless": {"stateless": FITNESS_BEST, "master": FITNESS_GOOD,
                  "unset": FITNESS_UNSET, "log": FITNESS_OKAY,
                  "transaction": FITNESS_OKAY, "storage": FITNESS_WORST,
                  "coordinator": FITNESS_NEVER, "tester": FITNESS_NEVER},
    "log": {"log": FITNESS_BEST, "transaction": FITNESS_BEST,
            "stateless": FITNESS_GOOD, "unset": FITNESS_UNSET,
            "master": FITNESS_OKAY, "storage": FITNESS_WORST,
            "coordinator": FITNESS_NEVER, "tester": FITNESS_NEVER},
    "storage": {"storage": FITNESS_BEST, "unset": FITNESS_UNSET,
                "log": FITNESS_OKAY, "transaction": FITNESS_OKAY,
                "stateless": FITNESS_WORST, "master": FITNESS_WORST,
                "coordinator": FITNESS_NEVER, "tester": FITNESS_NEVER},
}


def role_fitness(process_class: str, role: str) -> int:
    """Placement rank of a worker class for a role; lower is better."""
    table = _ROLE_FITNESS.get(role) or _ROLE_FITNESS["stateless"]
    return table.get(process_class, FITNESS_UNSET)


@dataclass
class GetWorkersRequest:
    reply: Any = None


@dataclass
class OpenDatabaseRequest:
    """Client -> cluster controller: the ClientDBInfo of an epoch past
    `known_epoch` that accepts commits (a long poll)."""

    known_epoch: int = -1
    reply: Any = None


@dataclass
class InitializeMasterRequest:
    epoch: int
    cc: Any = None        # ClusterControllerInterface
    reply: Any = None     # -> MasterInterface


@dataclass
class InitializeTLogRequest:
    """Recruit a TLog of `epoch` at `recovery_version`, carrying each tag
    of `recover_tags` (tag -> old-generation TLogInterface) from its
    popped version.  The reference's remote-feeder fields are not kept
    (no regions)."""

    tlog_id: str
    recovery_version: Version
    recover_tags: Dict[Tag, Any] = field(default_factory=dict)
    recover_popped: Dict[Tag, Version] = field(default_factory=dict)
    epoch: int = 0
    reply: Any = None     # -> TLogInterface


@dataclass
class InitializeCommitProxyRequest:
    """Recruit a commit proxy of `epoch`.  The reference's backup, lock,
    region, storage-cache, TSS and tenant fields are not kept."""

    proxy_id: str
    epoch: int
    master: Any
    resolvers: List[Any]
    tlogs: List[Any]
    key_resolvers_ranges: List[Tuple[bytes, bytes, int]]
    key_servers_ranges: List[Tuple[bytes, bytes, List[Tag]]]
    storage_interfaces: Dict[Tag, Any]
    recovery_version: Version
    reply: Any = None     # -> CommitProxyInterface


@dataclass
class InitializeGrvProxyRequest:
    proxy_id: str
    epoch: int
    master: Any
    tlogs: List[Any]
    ratekeeper: Any = None
    reply: Any = None     # -> GrvProxyInterface


@dataclass
class InitializeRatekeeperRequest:
    rk_id: str
    storage_interfaces: Dict[Tag, Any] = field(default_factory=dict)
    tlog_interfaces: List[Any] = field(default_factory=list)
    resolver_interfaces: List[Any] = field(default_factory=list)
    reply: Any = None     # -> RatekeeperInterface


@dataclass
class InitializeResolverRequest:
    resolver_id: str
    epoch: int
    recovery_version: Version
    # The epoch's commit proxies, registered with the role up front.
    proxy_ids: List[str] = field(default_factory=list)
    reply: Any = None     # -> ResolverInterface


@dataclass
class InitializeDataDistributorRequest:
    dd_id: str = ""
    epoch: int = 0
    storage_interfaces: Dict[Tag, Any] = field(default_factory=dict)
    key_servers_ranges: List[Any] = field(default_factory=list)
    replication: int = 1
    reply: Any = None    # -> DataDistributorInterface


@dataclass
class MigrateEngineRequest:
    """Data distribution (the wiggle) -> a storage server: re-image the
    durable store onto `engine`.  Answered once the new store is durable
    and the old one's files are gone (the boot scan recovers by file
    extension: a leftover would bring back a stale twin)."""

    engine: str = "memory"
    reply: Any = None


@dataclass
class InitializeStorageRequest:
    """Recruit a storage server over a fresh engine of kind `engine` (""
    is the worker's configured engine).  The reference's remote-replica,
    storage-cache and TSS fields are not kept."""

    ss_id: str
    tag: Tag
    engine: str = ""
    reply: Any = None     # -> StorageServerInterface


class WorkerInterface:
    """Per-process recruitment surface (reference WorkerInterface).  The
    log router's and backup worker's init streams are registered with the
    rest, so the frame is the reference's, and nothing serves them (the
    port has neither role)."""

    def __init__(self, worker_id: str = "") -> None:
        self.id = worker_id
        self.init_master = RequestStream("worker.initMaster",
                                         TaskPriority.DefaultEndpoint)
        self.init_tlog = RequestStream("worker.initTLog",
                                       TaskPriority.DefaultEndpoint)
        self.init_commit_proxy = RequestStream("worker.initCommitProxy",
                                               TaskPriority.DefaultEndpoint)
        self.init_grv_proxy = RequestStream("worker.initGrvProxy",
                                            TaskPriority.DefaultEndpoint)
        self.init_resolver = RequestStream("worker.initResolver",
                                           TaskPriority.DefaultEndpoint)
        self.init_storage = RequestStream("worker.initStorage",
                                          TaskPriority.DefaultEndpoint)
        self.init_ratekeeper = RequestStream("worker.initRatekeeper",
                                             TaskPriority.DefaultEndpoint)
        self.init_data_distributor = RequestStream(
            "worker.initDataDistributor", TaskPriority.DefaultEndpoint)
        self.init_log_router = RequestStream("worker.initLogRouter",
                                             TaskPriority.DefaultEndpoint)
        self.init_backup_worker = RequestStream("worker.initBackupWorker",
                                                TaskPriority.DefaultEndpoint)
        self.wait_failure = RequestStream("worker.waitFailure",
                                          TaskPriority.FailureMonitor)
        self.ping = RequestStream("worker.ping",
                                  TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.init_master, self.init_tlog, self.init_commit_proxy,
                self.init_grv_proxy, self.init_resolver, self.init_storage,
                self.init_ratekeeper, self.init_data_distributor,
                self.init_log_router, self.init_backup_worker,
                self.wait_failure, self.ping]


class ClusterControllerInterface:
    """The reference's ClusterControllerInterface; its get_status stream
    is registered and not served (the port has no status document)."""

    def __init__(self, cc_id: str = "") -> None:
        self.id = cc_id
        self.register_worker = RequestStream(
            "cc.registerWorker", TaskPriority.ClusterController)
        self.get_workers = RequestStream(
            "cc.getWorkers", TaskPriority.ClusterController)
        self.open_database = RequestStream(
            "cc.openDatabase", TaskPriority.ClusterController)
        self.master_registration = RequestStream(
            "cc.masterRegistration", TaskPriority.ClusterController)
        self.get_server_db_info = RequestStream(
            "cc.getServerDBInfo", TaskPriority.ClusterController)
        self.get_status = RequestStream(
            "cc.getStatus", TaskPriority.ClusterController)

    def streams(self) -> List[RequestStream]:
        return [self.register_worker, self.get_workers, self.open_database,
                self.master_registration, self.get_server_db_info,
                self.get_status]


@dataclass
class MasterRegistrationRequest:
    """Master -> cluster controller: its recovery's result, the role
    directory the controller broadcasts (reference
    clusterRegisterMaster)."""

    epoch: int
    db_info: ServerDBInfo
    reply: Any = None
