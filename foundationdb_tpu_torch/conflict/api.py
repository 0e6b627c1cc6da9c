"""ConflictSet: the Resolver's write-history + batch conflict detection.

Opaque-factory boundary mirroring the reference's ConflictSet.h:30-52
(newConflictSet / ConflictBatch::addTransaction / detectConflicts), with a
backend selector: "torch" (the PyTorch + CUDA backend, on `cuda` unless
the caller passes device="cpu", under the supervision layer), "torch-raw"
(the same, bare), "sharded" (the backend with its window
key-range-sharded over a mesh of the visible cards, supervised), "native"
(the C++ engine of conflict/native.py, host code), "auto" (the supervised
torch set with a card, the native engine without) or "cpu" (the exact
oracle).

Abstract semantics (the parity contract, from fdbserver/SkipList.cpp):

  The history is a piecewise-constant function V(k): key -> last-write
  version, plus oldest_version (the MVCC window floor).  For a batch of
  transactions resolving at commit version `now`:

  1. too-old:   txn is TOO_OLD iff read_snapshot < oldest_version and it has
                read conflict ranges (SkipList.cpp:819-827).
  2. history:   txn conflicts iff any read range [b,e) has
                max{V(k) : k in [b,e)} > read_snapshot  (SkipList.cpp:443).
  3. intra:     scanning txns in batch order, a txn conflicts iff any read
                range overlaps a write range of an earlier txn that SURVIVED
                (was not conflicted/too-old) (SkipList.cpp:874-906).
  4. insert:    all write ranges of surviving txns are written into the
                history: V(k) := now for k in each range (SkipList.cpp:989).
  5. gc:        oldest_version := max(oldest_version, new_oldest_version);
                segments wholly below oldest_version may be merged — never
                affecting any future decision (SkipList.cpp:576 removeBefore).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..core.knobs import server_knobs
from ..txn.types import CommitResult, CommitTransactionRef, Version


class ConflictSet:
    """Abstract conflict set. Subclasses: OracleConflictSet,
    TorchConflictSet, ShardedTorchConflictSet, SupervisedConflictSet."""

    def __init__(self, oldest_version: Version = 0) -> None:
        self.oldest_version: Version = oldest_version
        # Heat-telemetry attribution of the LAST resolve_with_conflicts
        # batch: {txn index: [(begin, end), ...]} for CONFLICT verdicts,
        # and per-index True where the ranges are the EXACT culprits
        # rather than the conservative whole-read-set fallback.
        self.last_attribution: dict = {}
        self.last_attribution_exact: dict = {}

    def resolve(self, transactions: Sequence[CommitTransactionRef],
                now: Version,
                new_oldest_version: Optional[Version] = None
                ) -> List[CommitResult]:
        """Resolve one commit batch at version `now`; updates history and
        (optionally) advances the MVCC window floor. Returns one
        CommitResult per transaction, in input order."""
        raise NotImplementedError

    def resolve_with_conflicts(self, transactions, now: Version,
                               new_oldest_version: Optional[Version] = None):
        """(verdicts, {txn_index: [(begin, end), ...]}) — the conflicting
        READ ranges of CONFLICT-verdict transactions that set
        report_conflicting_keys.  The base implementation is CONSERVATIVE:
        every read range of a conflicted reporter (a superset of the true
        culprits); OracleConflictSet reports the exact ranges."""
        verdicts = self.resolve(transactions, now, new_oldest_version)
        # Heat-telemetry attribution: conservative, the whole read set is
        # blamed; backends with exact knowledge (the oracle) overwrite it
        # with the true culprits.  Gated on the master knob: with
        # telemetry off no per-batch dict of read sets is built.
        if server_knobs().HEAT_TELEMETRY_ENABLED:
            self.last_attribution = full_conservative_attribution(
                verdicts, transactions)
            self.last_attribution_exact = {
                t: False for t in self.last_attribution}
        else:
            self.last_attribution = {}
            self.last_attribution_exact = {}
        return verdicts, conservative_conflict_ranges(verdicts, transactions)

    def clear(self, version: Version) -> None:
        """Reset all history (reference clearConflictSet)."""
        raise NotImplementedError


def full_conservative_attribution(verdicts, transactions) -> dict:
    """{txn_index: [(begin, end), ...]}: the WHOLE read set of every
    CONFLICT-verdict transaction (reporter or not) -- the conservative
    heat-attribution fallback when no exact culprit is known."""
    out: dict = {}
    for i, (v, tr) in enumerate(zip(verdicts, transactions)):
        if v == CommitResult.CONFLICT and tr.read_conflict_ranges:
            out[i] = [(r.begin, r.end) for r in tr.read_conflict_ranges]
    return out


def conservative_conflict_ranges(verdicts, transactions) -> dict:
    """{txn_index: [(begin, end), ...]} reporting EVERY read range of each
    conflicted reporter."""
    ranges: dict = {}
    for i, (v, tr) in enumerate(zip(verdicts, transactions)):
        if v == CommitResult.CONFLICT and \
                getattr(tr, "report_conflicting_keys", False):
            ranges[i] = [(r.begin, r.end)
                         for r in tr.read_conflict_ranges]
    return ranges


def new_conflict_set(backend: Optional[str] = None,
                     oldest_version: Version = 0, mesh=None,
                     **kwargs) -> ConflictSet:
    """Factory honoring the CONFLICT_SET_BACKEND knob (reference
    conflict/api.py new_conflict_set).  backend None reads the knob.

    "torch": TorchConflictSet (kwargs: capacity, delta_capacity,
    gc_interval_batches, device -- `cuda` by default; the factory raises
    when no CUDA device is present and none was named).  "sharded":
    ShardedTorchConflictSet over `mesh`, by default a mesh of every
    visible card (raises when there is none; kwargs: capacity and
    delta_capacity per shard, gc_interval_batches, splits).  Both are
    wrapped in the supervision layer (conflict/supervisor.py) unless the
    CONFLICT_BACKEND_SUPERVISED knob is off: deadline-budgeted dispatch,
    degrade to an exact CPU mirror, re-probe and promotion, and the
    exact long-key recheck; the device set is built anew, with the same
    kwargs, at every promotion.  The first is built here, so a set that
    cannot be built (no card, a kernel build failure, no memory) raises
    instead of the supervisor beginning degraded on its CPU mirror.
    "torch-raw" is the bare TorchConflictSet
    (the reference's "tpu-raw").  "native": NativeConflictSet, the C++
    engine built with g++ at first use.  "auto" is "torch" when a CUDA
    device is present and "native" otherwise.  "cpu": the oracle."""
    backend = backend or server_knobs().CONFLICT_SET_BACKEND
    if backend == "auto":
        import torch
        # Deviation from the reference (foundationdb_tpu/conflict/api.py
        # :139-143), whose "auto" falls quietly to the oracle when the
        # native library fails to build: here a failed build raises with
        # the compiler's stderr, as a failed kernel build does.
        backend = "torch" if torch.cuda.is_available() else "native"
    if backend == "native":
        from .native import NativeConflictSet
        return NativeConflictSet(oldest_version)
    if backend == "cpu":
        from .oracle import OracleConflictSet
        return OracleConflictSet(oldest_version)
    if backend not in ("torch", "torch-raw", "sharded"):
        raise ValueError(f"unknown conflict set backend {backend!r}")
    if backend == "sharded":
        from ..parallel.sharded_resolver import ShardedTorchConflictSet
        from ..parallel.sharded_window import make_conflict_mesh
        mesh = make_conflict_mesh() if mesh is None else mesh

        def make_device(oldest_version: Version = oldest_version):
            return ShardedTorchConflictSet(mesh, oldest_version, **kwargs)
    else:
        from .torch_backend import TorchConflictSet

        def make_device(oldest_version: Version = oldest_version):
            return TorchConflictSet(oldest_version, **kwargs)

    if backend != "torch-raw" and server_knobs().CONFLICT_BACKEND_SUPERVISED:
        from .supervisor import SupervisedConflictSet
        return SupervisedConflictSet(make_device, oldest_version,
                                     device=make_device())
    return make_device()
