"""CPU oracle ConflictSet: exact reference semantics on a sorted segment list.

This is the parity oracle for the TPU backend (and a correct standalone
resolver backend).  Where the reference uses a skip list of keys with
per-level max versions (fdbserver/SkipList.cpp), we store the equivalent
piecewise-constant version function directly: a sorted list of boundary keys
with the version of the segment starting at each boundary.  Same decisions,
simpler invariants; the native C++ backend (native.py + native_src/) is the performance CPU
path, this one is the readable truth.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from typing import List, Optional, Sequence, Tuple

from ..txn.types import (CommitResult, CommitTransactionRef, KeyRange, Version)
from .api import ConflictSet


class VersionHistory:
    """Piecewise-constant V(k): sorted boundary keys + per-segment versions.

    keys[0] == b"" always; segment i covers [keys[i], keys[i+1]) (last one is
    unbounded) with version vals[i]."""

    __slots__ = ("keys", "vals")

    def __init__(self, version: Version = 0) -> None:
        self.keys: List[bytes] = [b""]
        self.vals: List[Version] = [version]

    def query_max(self, begin: bytes, end: bytes) -> Version:
        """max{V(k) : k in [begin, end)}; empty range -> very old (-inf-ish)."""
        if begin >= end:
            return -1 << 62
        i = bisect_right(self.keys, begin) - 1
        j = bisect_left(self.keys, end, lo=i + 1)
        return max(self.vals[i:j])

    def insert(self, begin: bytes, end: bytes, version: Version) -> None:
        """V(k) := version for k in [begin, end) (replace, like the skip list's
        remove+insert in addConflictRanges, SkipList.cpp:430-441)."""
        if begin >= end:
            return
        j = bisect_left(self.keys, end)          # first boundary >= end; >=1
        has_end = j < len(self.keys) and self.keys[j] == end
        # Version continuing at `end` = version of the segment containing end
        # before this insert (SkipList.cpp:434 insert(endF, prior max)).
        cont_v = self.vals[j - 1]
        i = bisect_left(self.keys, begin)        # first boundary >= begin
        if has_end:
            self.keys[i:j] = [begin]
            self.vals[i:j] = [version]
        else:
            self.keys[i:j] = [begin, end]
            self.vals[i:j] = [version, cont_v]

    def insert_many(self, ranges: List[Tuple[bytes, bytes]],
                    version: Version) -> None:
        """Batch V(k) := version for SORTED, DISJOINT, non-touching
        [begin, end) ranges (combine_write_ranges output) in ONE linear
        rebuild pass: O(n + 2w) instead of w list splices (O(w*n)).
        Semantics identical to calling insert() per range in order —
        property-tested in tests/test_conflict_oracle.py.  This is what
        keeps the supervisor's host mirror off the critical path at
        bench batch sizes (100K writes/batch into a ~500K-segment
        window)."""
        if not ranges:
            return
        keys, vals = self.keys, self.vals
        n = len(keys)
        out_k: List[bytes] = []
        out_v: List[Version] = []
        i = 0
        for b, e in ranges:
            j = bisect_left(keys, b, i)      # first boundary >= b
            out_k.extend(keys[i:j])
            out_v.extend(vals[i:j])
            k2 = bisect_left(keys, e, j)     # first boundary >= e
            out_k.append(b)
            out_v.append(version)
            if not (k2 < n and keys[k2] == e):
                # Continuing version at e: the ORIGINAL segment holding e
                # (prior ranges end strictly before b, so they never cover
                # e) — exactly insert()'s cont_v.
                out_k.append(e)
                out_v.append(vals[k2 - 1])
            i = k2
        out_k.extend(keys[i:])
        out_v.extend(vals[i:])
        self.keys, self.vals = out_k, out_v

    def remove_before(self, oldest: Version) -> None:
        """Merge adjacent segments both below `oldest` (reference removeBefore
        SkipList.cpp:576: a node is dropped iff it and its predecessor are both
        below). Decision-invariant for any read with snapshot >= oldest."""
        if len(self.keys) <= 1:
            return
        keep_k: List[bytes] = [self.keys[0]]
        keep_v: List[Version] = [self.vals[0]]
        for k, v in zip(self.keys[1:], self.vals[1:]):
            if v < oldest and keep_v[-1] < oldest:
                continue  # merge into previous stale segment
            keep_k.append(k)
            keep_v.append(v)
        self.keys, self.vals = keep_k, keep_v

    def segment_count(self) -> int:
        return len(self.keys)


def combine_write_ranges(
        ranges: List[Tuple[bytes, bytes]]) -> List[Tuple[bytes, bytes]]:
    """Union of half-open ranges, merging overlapping/touching ones
    (reference combineWriteConflictRanges, SkipList.cpp:996)."""
    if not ranges:
        return []
    ranges = sorted(r for r in ranges if r[0] < r[1])
    out: List[Tuple[bytes, bytes]] = []
    for b, e in ranges:
        if out and b <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((b, e))
    return out


class OracleConflictSet(ConflictSet):
    """Reference-semantics conflict set over VersionHistory."""

    def __init__(self, oldest_version: Version = 0) -> None:
        super().__init__(oldest_version)
        self.history = VersionHistory(oldest_version)
        # Per-batch exact conflict attribution of the LAST resolve (heat
        # telemetry feed): {txn index: [(begin, end), ...]} for every
        # CONFLICT verdict — all culprit ranges for reporters, the first
        # culprit otherwise (the decision loop stops there).  True in
        # last_attribution_exact marks the ranges as exact (this oracle
        # always is; the supervisor's conservative fallback is not).
        self.last_attribution: dict = {}
        self.last_attribution_exact: dict = {}

    def clear(self, version: Version) -> None:
        self.history = VersionHistory(version)

    def resolve(self, transactions: Sequence[CommitTransactionRef], now: Version,
                new_oldest_version: Optional[Version] = None) -> List[CommitResult]:
        verdicts, _ranges = self.resolve_with_conflicts(
            transactions, now, new_oldest_version)
        return verdicts

    def resolve_with_conflicts(self, transactions, now: Version,
                               new_oldest_version: Optional[Version] = None):
        """EXACT conflicting-keys reporting (overrides the conservative
        base): for reporters, every read range individually checked
        against the history and the intra-batch writers — the reported
        set is precisely the ranges whose max write version exceeded the
        snapshot (reference ConflictBatch report path feeding
        ReportConflictingKeys.actor.cpp's cross-check)."""
        n = len(transactions)
        too_old = [False] * n
        conflict = [False] * n
        # Culprit ranges for EVERY conflicted txn (heat attribution);
        # `reported` (the client-facing conflicting-keys surface) is the
        # reporter-only projection of the same dict, built at the end.
        attribution: dict = {}

        def _report(t, _tr, rng) -> None:
            attribution.setdefault(t, []).append((rng.begin, rng.end))

        # 1. too-old classification (SkipList.cpp:819-827): snapshot below the
        # window floor, and only if the txn actually read something.
        for t, tr in enumerate(transactions):
            if tr.read_snapshot < self.oldest_version and tr.read_conflict_ranges:
                too_old[t] = True

        # 2. history check (checkReadConflictRanges -> SkipList::detectConflicts)
        for t, tr in enumerate(transactions):
            if too_old[t]:
                continue
            report = getattr(tr, "report_conflicting_keys", False)
            for r in tr.read_conflict_ranges:
                if self.history.query_max(r.begin, r.end) > tr.read_snapshot:
                    conflict[t] = True
                    _report(t, tr, r)
                    if not report:
                        break

        # 3. intra-batch, in batch order; only surviving writers block
        # (checkIntraBatchConflicts, SkipList.cpp:874-906).
        surviving_writes: List[Tuple[bytes, bytes]] = []
        for t, tr in enumerate(transactions):
            if conflict[t]:
                continue
            c = too_old[t]
            report = getattr(tr, "report_conflicting_keys", False)
            if not c:
                for r in tr.read_conflict_ranges:
                    hit = False
                    for wb, we in surviving_writes:
                        if r.begin < we and wb < r.end:
                            hit = True
                            break
                    if hit:
                        c = True
                        _report(t, tr, r)
                        if not report:
                            break
            conflict[t] = c
            if not c:
                for w in tr.write_conflict_ranges:
                    if w.begin < w.end:
                        surviving_writes.append((w.begin, w.end))

        # 4. merge surviving write ranges into history at version `now`
        # (one linear pass over the segment list, not per-range splices).
        self.history.insert_many(combine_write_ranges(surviving_writes), now)

        # 5. window GC.
        if new_oldest_version is not None and new_oldest_version > self.oldest_version:
            self.oldest_version = new_oldest_version
            self.history.remove_before(new_oldest_version)

        out: List[CommitResult] = []
        for t in range(n):
            if too_old[t]:
                out.append(CommitResult.TOO_OLD)
            elif conflict[t]:
                out.append(CommitResult.CONFLICT)
            else:
                out.append(CommitResult.COMMITTED)
        attribution = {t: rs for t, rs in attribution.items()
                       if out[t] == CommitResult.CONFLICT}
        self.last_attribution = attribution
        self.last_attribution_exact = {t: True for t in attribution}
        reported = {t: rs for t, rs in attribution.items()
                    if getattr(transactions[t], "report_conflicting_keys",
                               False)}
        return out, reported

    def attribute_conflicts(self, transactions, verdicts,
                            limit: int = 1 << 30) -> dict:
        """READ-ONLY exact attribution for a batch someone ELSE resolved
        (the supervisor's device path): given the final verdicts, rerun
        only the decision loop's range checks against the CURRENT history
        — so this must be called BEFORE the batch's surviving writes are
        inserted — and against the surviving writes of earlier txns in
        the batch.  At most `limit` CONFLICT txns are attributed (batch
        order; the caller counts the remainder as conservative).
        Returns {txn index: [(begin, end), ...]}."""
        out: dict = {}
        attributed = 0
        surviving: List[Tuple[bytes, bytes]] = []
        for t, (tr, v) in enumerate(zip(transactions, verdicts)):
            if attributed >= limit:
                break            # budget exhausted: stop scanning
            if v == CommitResult.COMMITTED:
                for w in tr.write_conflict_ranges:
                    if w.begin < w.end:
                        surviving.append((w.begin, w.end))
                continue
            if v != CommitResult.CONFLICT:
                continue
            attributed += 1
            ranges: List[Tuple[bytes, bytes]] = []
            report = getattr(tr, "report_conflicting_keys", False)
            for r in tr.read_conflict_ranges:
                hit = self.history.query_max(r.begin, r.end) \
                    > tr.read_snapshot
                if not hit:
                    for wb, we in surviving:
                        if r.begin < we and wb < r.end:
                            hit = True
                            break
                if hit:
                    ranges.append((r.begin, r.end))
                    if not report:
                        break
            if ranges:
                out[t] = ranges
        return out
