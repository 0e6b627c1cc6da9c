"""Conflict predictor: the per-proxy hot-range abort-probability table
(copy of foundationdb_tpu/sched/predictor.py: every float is computed in
the reference's operation order, so the tables are equal bit for bit).

Reference shape: the admission-control model of "Intelligent Transaction
Scheduling via Conflict Prediction in OLTP DBMS" (arXiv 2409.01675),
instantiated on the feed this cluster already produces — the resolvers'
``ConflictHeatTracker`` rows (decayed per-range conflict/load counts
with per-tag/per-tenant attribution, conflict/heat.py) ride the
ratekeeper's ``GetRateInfoReply`` to every GRV proxy in the reference;
in the port the plane's feed() hands the ratekeeper's fold of them to
every GRV proxy (server/cluster.py).

Each GRV proxy folds the rows into ONE deterministic table:

* per range: an EMA of the observed abort probability (attributed
  conflicts vs sampled load), decayed toward zero when a range stops
  appearing in the feed;
* per tag / tenant: which predicted-doomed range (abort-prob EMA above
  ``ABORT_P``) the identity currently maps to, derived
  from the rows' own attribution breakdowns.

Admission consults :meth:`ConflictPredictor.is_doomed` with the GRV
request's declared tags; the proxy defers doomed requests by a short
knob-bounded delay (starvation-proof via the max-defer count — the
proxy's job, not this table's).

Determinism: no wall clock anywhere — decay advances once per
:meth:`update` call (feed cadence); iteration is over insertion-ordered
dicts and sorted projections only, so two predictors fed the same rows
are bit-identical under any PYTHONHASHSEED.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# A GRV proxy's table (ConflictPredictor.default()), at the reference's
# SCHED_PREDICTOR_* knob defaults: the EMA fold factor per feed snapshot,
# the doom thresholds (abort-probability EMA and decayed conflict count)
# and the table's bound.
ALPHA, ABORT_P, MIN_CONFLICTS, TABLE_MAX = 0.5, 0.3, 4.0, 512


class ConflictPredictor:
    """Decayed abort-probability EMAs keyed by conflict range, with the
    tag/tenant -> predicted-doomed-range mapping admission consults."""

    __slots__ = ("alpha", "abort_p", "min_conflicts", "table_max",
                 "ranges", "doomed_tags", "doomed_tenants", "updates")

    def __init__(self, alpha: float = 0.5, abort_p: float = 0.5,
                 min_conflicts: float = 4.0, table_max: int = 512) -> None:
        self.alpha = min(max(float(alpha), 0.01), 1.0)
        self.abort_p = float(abort_p)
        self.min_conflicts = float(min_conflicts)
        self.table_max = max(16, int(table_max))
        # (begin, end) -> [prob_ema, conflicts_ema, {tag: conflicts},
        # {tenant: conflicts}]; insertion-ordered for determinism.
        self.ranges: Dict[Tuple[bytes, bytes], list] = {}
        self.doomed_tags: Dict[str, Tuple[bytes, bytes]] = {}
        self.doomed_tenants: Dict[int, Tuple[bytes, bytes]] = {}
        self.updates = 0

    @classmethod
    def default(cls) -> "ConflictPredictor":
        return cls(alpha=ALPHA, abort_p=ABORT_P,
                   min_conflicts=MIN_CONFLICTS, table_max=TABLE_MAX)

    # -- feed ----------------------------------------------------------------
    @staticmethod
    def _row_prob(conflicts: float, load: float) -> float:
        """Observed abort weight of one feed row: attributed conflicts
        vs the load column.  Load is already 1-in-SAMPLE_EVERY
        subsampled upstream, so this ratio deliberately overweights
        conflicts — every attributed abort is hard evidence, a load
        sample stands for ~one-eighth of the traffic — which is what
        lets a genuinely doomed range clear ABORT_P
        while cold ranges stay far below it."""
        denom = conflicts + load
        return conflicts / denom if denom > 0 else 0.0

    def update(self, rows: Iterable) -> None:
        """Fold one feed snapshot.  ``rows`` are the resolver heat rows:
        ``(begin, end, conflicts, load, {tag: conflicts},
        {tenant: conflicts})`` tuples (trailing members optional).
        Ranges absent from the snapshot decay toward zero and drop out;
        the doom maps are recomputed from the post-fold table."""
        self.updates += 1
        a = self.alpha
        seen = set()
        for row in rows or ():
            begin, end, conflicts, load = row[0], row[1], row[2], row[3]
            tags = row[4] if len(row) > 4 else {}
            tenants = row[5] if len(row) > 5 else {}
            key = (bytes(begin), bytes(end))
            seen.add(key)
            p_obs = self._row_prob(float(conflicts), float(load))
            e = self.ranges.get(key)
            if e is None:
                e = self.ranges[key] = [p_obs, float(conflicts),
                                        dict(tags or {}),
                                        dict(tenants or {})]
            else:
                e[0] += a * (p_obs - e[0])
                e[1] += a * (float(conflicts) - e[1])
                e[2] = dict(tags or {})
                e[3] = dict(tenants or {})
        # Ranges gone cold (absent from the feed) decay toward zero and
        # drop below noise — a hotspot that moved must stop dooming its
        # old identities within a few cadences.
        for key in [k for k in self.ranges if k not in seen]:
            e = self.ranges[key]
            e[0] *= (1.0 - a)
            e[1] *= (1.0 - a)
            if e[1] < 0.5:
                del self.ranges[key]
        if len(self.ranges) > self.table_max:
            # Keep the hottest table_max rows; deterministic ordering
            # (prob desc, then range key) so equal-prob ties never
            # depend on insertion history.
            keep = sorted(self.ranges.items(),
                          key=lambda kv: (-kv[1][0], kv[0]))[:self.table_max]
            self.ranges = dict(keep)
        self._recompute_doom()

    def _recompute_doom(self) -> None:
        tags: Dict[str, Tuple[bytes, bytes]] = {}
        tenants: Dict[int, Tuple[bytes, bytes]] = {}
        for key in sorted(self.ranges):
            prob, conflicts, row_tags, row_tenants = self.ranges[key]
            if prob < self.abort_p or conflicts < self.min_conflicts:
                continue
            for tag in sorted(row_tags):
                if tag and tag not in tags:
                    tags[tag] = key
            for tenant in sorted(row_tenants):
                if tenant >= 0 and tenant not in tenants:
                    tenants[tenant] = key
        self.doomed_tags = tags
        self.doomed_tenants = tenants

    # -- queries -------------------------------------------------------------
    def is_doomed(self, tags: Iterable[str] = (),
                  tenant_id: int = -1) -> bool:
        """Does any declared identity map to a predicted-doomed range?"""
        for tag in tags or ():
            if tag in self.doomed_tags:
                return True
        return tenant_id is not None and tenant_id >= 0 and \
            tenant_id in self.doomed_tenants

    def doomed_range_for(self, tags: Iterable[str] = (),
                         tenant_id: int = -1
                         ) -> Optional[Tuple[bytes, bytes]]:
        for tag in tags or ():
            r = self.doomed_tags.get(tag)
            if r is not None:
                return r
        if tenant_id is not None and tenant_id >= 0:
            return self.doomed_tenants.get(tenant_id)
        return None

    def range_prob(self, begin: bytes, end: bytes) -> float:
        e = self.ranges.get((begin, end))
        return e[0] if e is not None else 0.0

    def hot_ranges(self, k: int = 8) -> List[Tuple[bytes, bytes, float]]:
        rows = [(b, e, v[0]) for (b, e), v in self.ranges.items()]
        rows.sort(key=lambda r: (-r[2], r[0], r[1]))
        return rows[:k]

    def status(self) -> dict:
        """The per-proxy slice of status cluster.scheduler."""
        def pr(b: bytes) -> str:
            return b.decode("utf-8", "backslashreplace")

        return {
            "tracked_ranges": len(self.ranges),
            "updates": self.updates,
            "doomed_tags": sorted(self.doomed_tags),
            "doomed_tenants": sorted(self.doomed_tenants),
            "hot_ranges": [
                {"begin": pr(b), "end": pr(e), "abort_p": round(p, 4)}
                for b, e, p in self.hot_ranges()],
        }
