"""Intra-batch conflict-aware reordering: readers before their writers
(copy of foundationdb_tpu/sched/reorder.py, function for function).

The resolver's intra-batch rule (conflict/oracle.py step 3, reference
SkipList.cpp checkIntraBatchConflicts) is ORDER-SENSITIVE: a transaction
aborts when an EARLIER surviving transaction's write ranges overlap its
reads.  Batch order is the commit proxy's choice — so order the batch to
minimize self-inflicted aborts before resolution ever sees it.

Model: hazard edge ``x -> y`` when ``W(x) ∩ R(y) != ∅`` (x placed before
y aborts y).  The greedy topological order places, at every step, a
transaction none of whose writes are read by any still-unplaced
transaction (placing it can abort nobody — and, inductively, nothing
already placed threatens IT either, so an acyclic batch reorders to ZERO
intra-batch aborts).  Cycles — mutual read-modify-write cliques, whose
aborts are genuine — break on minimum remaining in-degree.  Ties break
on the original index everywhere, so the order is deterministic.

Cost: interval overlap is computed once between DISTINCT read and write
intervals (point writes — the dominant shape — by bisect; true range
writes by a short linear scan).  Past ``exact_max`` transactions the
per-edge Kahn bookkeeping would be quadratic on hot-key cliques, so the
pre-pass degrades to its one-round approximation: a stable sort by
initial in-degree (readers of contested ranges first, contested writers
last), which preserves determinism and captures most of the win at
bench batch sizes.

Disabled-path guarantee: the proxy skips this module entirely when
``SCHED_REORDER_ENABLED`` is off, so verdicts are bit-identical to the
pipeline without it (tests/test_torch_sched.py holds commit() with every
knob off to resolve()).
"""

from __future__ import annotations

import heapq
from bisect import bisect_left
from typing import Dict, List, Sequence, Tuple


def _point_end(begin: bytes, end: bytes) -> bool:
    """Single-key range (k, k + b"\\x00")?  For these, overlap with
    [rb, re) reduces to rb <= begin < re — pure bisect territory."""
    return end == begin + b"\x00"


class _Intervals:
    """Distinct-interval registry + overlap queries for one batch."""

    def __init__(self) -> None:
        self.ids: Dict[Tuple[bytes, bytes], int] = {}
        self.spans: List[Tuple[bytes, bytes]] = []

    def intern(self, begin: bytes, end: bytes) -> int:
        key = (begin, end)
        iv = self.ids.get(key)
        if iv is None:
            iv = self.ids[key] = len(self.spans)
            self.spans.append(key)
        return iv


def _overlaps(reads: _Intervals, writes: _Intervals
              ) -> List[List[int]]:
    """overlapping[riv] = write interval ids intersecting read iv riv
    (ascending).  Point writes via one bisect window per read; wide
    writes via a linear scan of the (short) wide list."""
    points: List[Tuple[bytes, int]] = []
    wide: List[Tuple[bytes, bytes, int]] = []
    for wiv, (wb, we) in enumerate(writes.spans):
        if _point_end(wb, we):
            points.append((wb, wiv))
        else:
            wide.append((wb, we, wiv))
    points.sort()
    p_begins = [b for b, _iv in points]
    out: List[List[int]] = []
    for rb, re_ in reads.spans:
        hit = [iv for _b, iv in points[bisect_left(p_begins, rb):
                                       bisect_left(p_begins, re_)]]
        for wb, we, wiv in wide:
            if wb < re_ and we > rb:
                hit.append(wiv)
        out.append(hit)
    return out


def _batch_intervals(txns: Sequence) -> Tuple[
        _Intervals, _Intervals, List[List[int]], List[List[int]]]:
    reads = _Intervals()
    writes = _Intervals()
    reads_of: List[List[int]] = []
    writes_of: List[List[int]] = []
    for t in txns:
        reads_of.append(sorted({reads.intern(r.begin, r.end)
                                for r in t.read_conflict_ranges
                                if r.begin < r.end}))
        writes_of.append(sorted({writes.intern(w.begin, w.end)
                                 for w in t.write_conflict_ranges
                                 if w.begin < w.end}))
    return reads, writes, reads_of, writes_of


def reorder_batch(txns: Sequence, exact_max: int = 1024) -> List[int]:
    """New batch order as a list of original indices (a permutation of
    range(len(txns))).  Pure function of the transactions' conflict
    ranges — no clock, no RNG."""
    n = len(txns)
    if n <= 1:
        return list(range(n))
    reads, writes, reads_of, writes_of = _batch_intervals(txns)
    overlapping = _overlaps(reads, writes)

    # readers[riv] / writers[wiv]: txn ids using each distinct interval.
    readers: List[List[int]] = [[] for _ in reads.spans]
    writers: List[List[int]] = [[] for _ in writes.spans]
    for t in range(n):
        for riv in reads_of[t]:
            readers[riv].append(t)
        for wiv in writes_of[t]:
            writers[wiv].append(t)

    if n <= exact_max:
        return _greedy_topological(n, reads_of, overlapping, readers,
                                   writers)
    return _static_indegree_order(n, reads_of, writes_of, overlapping,
                                  readers, writers)


def _greedy_topological(n: int, reads_of, overlapping, readers,
                        writers) -> List[int]:
    """Exact greedy Kahn: in-degree of x = number of distinct unplaced
    transactions reading something x writes.  Placing a reader y
    decrements every such x (out_edges[y])."""
    out_edges: List[set] = [set() for _ in range(n)]
    for riv, rdrs in enumerate(readers):
        if not rdrs:
            continue
        union: set = set()
        for wiv in overlapping[riv]:
            union.update(writers[wiv])
        if not union:
            continue
        for y in rdrs:
            out_edges[y].update(union)
    indeg = [0] * n
    for y in range(n):
        for x in out_edges[y]:
            if x != y:
                indeg[x] += 1
    heap = [(indeg[x], x) for x in range(n)]
    heapq.heapify(heap)
    placed = [False] * n
    order: List[int] = []
    while heap:
        d, x = heapq.heappop(heap)
        if placed[x]:
            continue
        if d != indeg[x]:
            heapq.heappush(heap, (indeg[x], x))
            continue
        placed[x] = True
        order.append(x)
        for z in out_edges[x]:
            if not placed[z] and z != x:
                indeg[z] -= 1
                heapq.heappush(heap, (indeg[z], z))
    return order


def _static_indegree_order(n: int, reads_of, writes_of, overlapping,
                           readers, writers) -> List[int]:
    """One-round approximation for big batches: stable sort by initial
    in-degree (reader-instance counts, not deduped across intervals —
    the dedup is what costs quadratic memory on hot-key cliques)."""
    # readers_over[wiv]: read instances hitting write interval wiv.
    readers_over = [0] * len(writers)
    for riv, wivs in enumerate(overlapping):
        cnt = len(readers[riv])
        if cnt:
            for wiv in wivs:
                readers_over[wiv] += cnt
    # Self pairs: a txn reading what it writes must not inflate its own
    # in-degree (RMW is the common case, not a hazard against itself).
    indeg = [0] * n
    for t in range(n):
        for wiv in writes_of[t]:
            indeg[t] += readers_over[wiv]
        own_writes = set(writes_of[t])
        for riv in reads_of[t]:
            for wiv in overlapping[riv]:
                if wiv in own_writes:
                    indeg[t] -= 1
    return sorted(range(n), key=lambda t: (indeg[t], t))


def moved_count(order: List[int]) -> int:
    """Transactions not at their original position (the ReorderSwaps
    metric's per-batch increment)."""
    return sum(1 for pos, t in enumerate(order) if pos != t)
