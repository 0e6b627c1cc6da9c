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
server's (its reads and its waitFailure; the reference's other storage
streams serve data distribution, watches and TSS, which the port does
not have).  A role's actors read them when it runs on a process
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

    def streams(self) -> List[RequestStream]:
        return [self.get_commit_version, self.report_live_committed_version,
                self.get_live_committed_version, self.wait_failure]


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
        self.get_value = RequestStream(
            "storage.getValue", TaskPriority.DefaultPromiseEndpoint)
        self.get_key_values = RequestStream(
            "storage.getKeyValues", TaskPriority.DefaultPromiseEndpoint)
        self.wait_failure = RequestStream("storage.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.get_value, self.get_key_values, self.wait_failure]


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
