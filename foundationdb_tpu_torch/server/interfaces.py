"""The Resolver role's messages and the commit proxy's (trimmed copy of
foundationdb_tpu/server/interfaces.py, reference
fdbserver/ResolverInterface.h:33,81-123 and
fdbclient/CommitProxyInterface.h).

Only the seven dataclasses, RESOLVER_ALL and a reply that keeps its value:
transport (request streams, task priorities, the ResolverInterface that
bundles them) belongs to whoever hosts the role.  `reply` is any object
with send(value) (and, for a commit, send_error(error)); the role
answers each request through it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..txn.types import CommitResult, CommitTransactionRef, Version

# keyResolvers value of the \xff system range: owned by EVERY resolver of
# the epoch (foundationdb_tpu/server/interfaces.py:53).
RESOLVER_ALL: int = -1


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
