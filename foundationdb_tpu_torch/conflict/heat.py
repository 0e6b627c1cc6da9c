"""Cluster heat telemetry: the decayed hot-range sample table (a copy of
foundationdb_tpu/conflict/heat.py, whose iteration order and tie-breaks
decide the resolver's split keys and top-K rows).

Reference: the read-hot-range / busiest-tag machinery of the reference
storage server (StorageMetrics.actor.cpp readHotRanges) and the
resolver's iops load sampling (Resolver.actor.cpp:191-198), generalized
into ONE table that serves both consumers the resolver has:

  * **load column** — every SAMPLE_EVERY'th conflict range is tallied
    (reads and writes, committed or not): the resolutionBalancing split
    queries project this column onto range-begin keys, preserving the
    pre-existing `_serve_split` semantics bit for bit;
  * **conflict column** — EXACT per-range attribution of every aborted
    transaction (the offending read range(s) the conflict-set history
    loop identified, conflict/oracle.py `last_attribution`): the heat
    signal ROADMAP bullet 2's conflict predictor consumes, with
    per-tenant and per-tag breakdowns riding alongside.

Determinism (the table lives inside the sim-reproducible resolver):
no wall clock anywhere — decay is driven by the caller's cadence
(metrics polls / table overflow), exactly like the sampler it replaces;
iteration only over dicts (insertion-ordered) and sorted projections,
never sets; ties in top-K break on the range key, so equal counts
render identically across runs.

Memory bound: past `table_max` entries the whole table halves and
drops sub-2 counts (the reference's sample-count halving), preserving
the hot tail while forgetting cold mass; the tenant/tag breakdown
tables halve on the same trigger.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class ConflictHeatTracker:
    """Decayed (load, conflict) counts per key range + tenant/tag
    breakdowns of conflict heat.  One instance per resolver."""

    __slots__ = ("sample_every", "table_max", "_tick", "ranges",
                 "tenants", "tags", "total_conflicts", "total_load",
                 "range_tags", "range_tenants")

    def __init__(self, sample_every: int = 8, table_max: int = 4096) -> None:
        self.sample_every = max(1, int(sample_every))
        self.table_max = max(16, int(table_max))
        self._tick = 0
        # (begin, end) -> [load, conflict]; dicts keep insertion order so
        # decay/rebuild is deterministic under any PYTHONHASHSEED.
        self.ranges: Dict[Tuple[bytes, bytes], List[int]] = {}
        self.tenants: Dict[int, int] = {}    # tenant_id -> conflict count
        self.tags: Dict[str, int] = {}       # throttle tag -> conflict count
        self.total_conflicts = 0             # lifetime (undecayed) counter
        self.total_load = 0
        # Per-RANGE identity attribution (the conflict predictor's feed,
        # sched/predictor.py): which tags/tenants the aborts blamed on a
        # range belonged to.  Bounded by `ranges` — entries live and die
        # (and halve) with their range row.
        self.range_tags: Dict[Tuple[bytes, bytes], Dict[str, int]] = {}
        self.range_tenants: Dict[Tuple[bytes, bytes], Dict[int, int]] = {}

    # -- recording -----------------------------------------------------------
    def sample_load(self, begin: bytes, end: bytes) -> bool:
        """Tally every sample_every'th call (the resolver feeds EVERY
        conflict range through here; the tick keeps the pre-existing
        one-in-SAMPLE_EVERY load sampling).  Returns True when the range
        was actually sampled."""
        self._tick += 1
        if self._tick % self.sample_every:
            return False
        e = self.ranges.get((begin, end))
        if e is None:
            e = self.ranges[(begin, end)] = [0, 0]
        e[0] += 1
        self.total_load += 1
        if len(self.ranges) > self.table_max:
            self.decay()
        return True

    def record_conflict(self, begin: bytes, end: bytes,
                        tenant_id: int = -1, tag: str = "",
                        weight: int = 1) -> None:
        """Exact conflict attribution: `weight` aborts blamed on
        [begin, end), with optional tenant/tag identity."""
        e = self.ranges.get((begin, end))
        if e is None:
            e = self.ranges[(begin, end)] = [0, 0]
        e[1] += weight
        self.total_conflicts += weight
        if tenant_id is not None and tenant_id >= 0:
            self.tenants[tenant_id] = \
                self.tenants.get(tenant_id, 0) + weight
            rt = self.range_tenants.get((begin, end))
            if rt is None:
                rt = self.range_tenants[(begin, end)] = {}
            rt[tenant_id] = rt.get(tenant_id, 0) + weight
        if tag:
            self.tags[tag] = self.tags.get(tag, 0) + weight
            rt2 = self.range_tags.get((begin, end))
            if rt2 is None:
                rt2 = self.range_tags[(begin, end)] = {}
            rt2[tag] = rt2.get(tag, 0) + weight
        if len(self.ranges) > self.table_max:
            self.decay()

    # -- decay ---------------------------------------------------------------
    def decay(self) -> None:
        """Halve every count, dropping entries whose BOTH columns fall
        below 1 (the split sampler's halving, extended to two columns):
        recent heat dominates, single-hit cold entries age out within a
        few cadence ticks, and the table never grows past ~table_max."""
        self.ranges = {k: [l // 2, c // 2]
                       for k, (l, c) in self.ranges.items()
                       if l >= 2 or c >= 2}
        self.tenants = {k: v // 2 for k, v in self.tenants.items()
                        if v >= 2}
        self.tags = {k: v // 2 for k, v in self.tags.items() if v >= 2}
        # The per-range identity tables halve on the same trigger and
        # never outlive their range row.
        self.range_tags = self._halve_identity(self.range_tags)
        self.range_tenants = self._halve_identity(self.range_tenants)

    def _halve_identity(self, table: Dict) -> Dict:
        """Halve a per-range identity breakdown, dropping sub-2 counts
        and entries whose range row just aged out of `ranges`."""
        out: Dict = {}
        for k, counts in table.items():
            if k not in self.ranges:
                continue
            halved = {t: v // 2 for t, v in counts.items() if v >= 2}
            if halved:
                out[k] = halved
        return out

    # -- queries -------------------------------------------------------------
    def split_load(self, begin: bytes, end: bytes
                   ) -> List[Tuple[bytes, int]]:
        """Load mass projected onto range-BEGIN keys inside [begin, end),
        sorted ascending — exactly the shape `_serve_split` consumed from
        the old begin-keyed sample dict (two sampled ranges sharing a
        begin merge their counts, as before)."""
        acc: Dict[bytes, int] = {}
        for (b, _e), (load, _c) in self.ranges.items():
            if load and begin <= b < end:
                acc[b] = acc.get(b, 0) + load
        return sorted(acc.items())

    def top_conflicts(self, k: int
                      ) -> List[Tuple[bytes, bytes, int, int]]:
        """Top-k ranges by decayed conflict count: (begin, end,
        conflicts, load), hottest first, key-ordered on ties."""
        rows = [(b, e, c, l) for (b, e), (l, c) in self.ranges.items()
                if c > 0]
        rows.sort(key=lambda r: (-r[2], r[0], r[1]))
        return rows[:k]

    def feed_rows(self, k: int) -> List[tuple]:
        """The conflict predictor's wire feed (sched/predictor.py via
        the ratekeeper piggyback): top-k conflict ranges as (begin, end,
        conflicts, load, {tag: conflicts}, {tenant: conflicts}) tuples,
        hottest first, key-ordered on ties."""
        return [(b, e, c, l,
                 dict(self.range_tags.get((b, e), ()) or {}),
                 dict(self.range_tenants.get((b, e), ()) or {}))
                for b, e, c, l in self.top_conflicts(k)]

    @staticmethod
    def _top_counts(counts: Dict, k: int) -> List[Tuple[object, int]]:
        rows = sorted(counts.items(), key=lambda kv: (-kv[1], repr(kv[0])))
        return rows[:k]

    def to_status(self, k: int = 8) -> Dict[str, object]:
        """The cluster.heat per-resolver document: top-k conflict ranges
        (printable + hex key forms — hex is what the special-key mirror
        keys rows by), busiest tenants/tags, lifetime totals."""
        def pr(b: bytes) -> str:
            return b.decode("utf-8", "backslashreplace")

        return {
            "top_conflict_ranges": [
                {"begin": pr(b), "end": pr(e),
                 "begin_hex": b.hex(), "end_hex": e.hex(),
                 "conflicts": c, "load": l}
                for b, e, c, l in self.top_conflicts(k)],
            "busiest_tenants": [
                {"tenant_id": t, "conflicts": c}
                for t, c in self._top_counts(self.tenants, k)],
            "busiest_tags": [
                {"tag": t, "conflicts": c}
                for t, c in self._top_counts(self.tags, k)],
            "total_conflicts_attributed": self.total_conflicts,
            "total_load_samples": self.total_load,
            "tracked_ranges": len(self.ranges),
        }
