"""The Resolver role's messages (trimmed copy of the resolver part of
foundationdb_tpu/server/interfaces.py, reference
fdbserver/ResolverInterface.h:33,81-123).

Only the five dataclasses, RESOLVER_ALL and a reply that keeps its value:
transport (request streams, task priorities, the ResolverInterface that
bundles them) belongs to whoever hosts the role.  `reply` is any object
with send(value); the role answers each request through it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..txn.types import CommitResult, CommitTransactionRef, Version

# keyResolvers value of the \xff system range: owned by EVERY resolver of
# the epoch (foundationdb_tpu/server/interfaces.py:53).
RESOLVER_ALL: int = -1


class Reply:
    """A reply that keeps what it was sent, for a caller that hands a
    request to a role and reads the answer after the call."""

    __slots__ = ("value", "sent")

    def __init__(self) -> None:
        self.value: Any = None
        self.sent = False

    def send(self, value: Any = None) -> None:
        self.value, self.sent = value, True


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
