"""Log-scale latency histograms + counter collections with periodic
trace emission (trimmed copy of foundationdb_tpu/core/histogram.py and the
part of core/metrics.py it calls).

Reference: flow/Histogram.h:59 (power-of-two histogram) and
fdbrpc/Stats.h:70-183 (Counter/CounterCollection + traceCounters'
periodic rate emission).  No process-wide registry: a collection is read
through its owner.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

_N_BUCKETS = 40
_BASE = 1e-6          # bucket 0 upper bound: 1us; bucket i: 1us * 2^i


class HistogramSnapshot:
    """Mergeable view of a log-scale histogram."""

    __slots__ = ("buckets", "count", "total", "min", "max")

    def __init__(self, buckets: Optional[List[int]] = None, count: int = 0,
                 total: float = 0.0, min_: Optional[float] = None,
                 max_: float = 0.0) -> None:
        self.buckets = list(buckets) if buckets is not None \
            else [0] * _N_BUCKETS
        self.count = count
        self.total = total
        self.min = min_
        self.max = max_

    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        """Fold `other` into self (in place; returns self)."""
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        self.count += other.count
        self.total += other.total
        self.max = max(self.max, other.max)
        if other.min is not None:
            self.min = other.min if self.min is None \
                else min(self.min, other.min)
        return self

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket containing the p-quantile (0..1),
        nearest-rank (ceil)."""
        if self.count == 0:
            return 0.0
        target = min(max(1, math.ceil(self.count * p)), self.count)
        acc = 0
        bound = _BASE
        for c in self.buckets:
            acc += c
            if acc >= target:
                return bound
            bound *= 2
        return bound

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_status(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "min": self.min or 0.0, "max": self.max,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class Histogram:
    """Power-of-two log-scale histogram of seconds (reference Histogram.h).

    The current interval (what one LatencyBand emission reports, then
    roll()s away) plus a lifetime accumulator; snapshot() and to_status()
    merge both."""

    def __init__(self, group: str = "", op: str = "") -> None:
        self.group = group
        self.op = op
        self._accumulated = HistogramSnapshot()
        self._reset_interval()

    def _reset_interval(self) -> None:
        self.buckets = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max = 0.0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.max = max(self.max, seconds)
        self.min = seconds if self.min is None else min(self.min, seconds)
        i = 0
        bound = _BASE
        while seconds > bound and i < _N_BUCKETS - 1:
            bound *= 2
            i += 1
        self.buckets[i] += 1

    def _interval(self) -> HistogramSnapshot:
        return HistogramSnapshot(self.buckets, self.count, self.total,
                                 self.min, self.max)

    def snapshot(self) -> HistogramSnapshot:
        """Lifetime snapshot (accumulated intervals + the current one)."""
        a = self._accumulated
        return HistogramSnapshot(a.buckets, a.count, a.total, a.min,
                                 a.max).merge(self._interval())

    def roll(self) -> HistogramSnapshot:
        """Fold the current interval into the lifetime accumulator and
        reset it; returns the interval's snapshot."""
        interval = self._interval()
        self._accumulated.merge(interval)
        self._reset_interval()
        return interval

    def to_status(self) -> Dict[str, float]:
        return self.snapshot().to_status()


class Counter:
    """Monotonic counter with rate-since-last-emission (Stats.h:70)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0
        self._last_value = 0

    def add(self, n: int = 1) -> None:
        self.value += n

    def rate_and_roll(self, dt: float) -> float:
        d = self.value - self._last_value
        self._last_value = self.value
        return d / dt if dt > 0 else 0.0


class CounterCollection:
    """Named counters + histograms for one role instance; emit_loop traces
    rates on a cadence (reference traceCounters, Stats.h:183)."""

    def __init__(self, group: str, role_id: str) -> None:
        self.group = group
        self.role_id = role_id
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(self.group, name)
        return h

    async def emit_loop(self, interval: Optional[float] = None) -> None:
        """The traceCounters actor: a periodic emit_collection on the
        installed event loop (core/scheduler.py); cadence from the
        METRICS_EMIT_INTERVAL knob unless overridden."""
        from .knobs import server_knobs
        from .scheduler import delay, now
        last = now()
        while True:
            await delay(interval if interval is not None
                        else float(server_knobs().METRICS_EMIT_INTERVAL))
            t = now()
            dt = t - last
            last = t
            emit_collection(self, dt)

    def to_status(self) -> Dict[str, object]:
        return {
            "counters": {n: c.value for n, c in self.counters.items()},
            "latency_statistics": {n: h.to_status()
                                   for n, h in self.histograms.items()},
        }


def emit_collection(coll: CounterCollection, dt: float) -> None:
    """One traceCounters tick for `coll`: a ``{group}Metrics`` event with
    values + rates, then one ``LatencyBand`` event per histogram that saw
    samples this interval (each histogram's interval rolls into its
    lifetime accumulator)."""
    from .trace import TraceEvent
    ev = TraceEvent(f"{coll.group}Metrics").detail(
        "Id", coll.role_id).detail("Elapsed", round(dt, 3))
    for name, c in coll.counters.items():
        ev.detail(name, c.value).detail(
            f"{name}PerSec", round(c.rate_and_roll(dt), 2))
    for name, h in coll.histograms.items():
        interval = h.roll()
        if interval.count == 0:
            continue           # idle op: no event
        TraceEvent("LatencyBand").detail("Group", coll.group).detail(
            "Id", coll.role_id).detail("Op", name).detail(
            "Count", interval.count).detail(
            "PerSec", round(interval.count / dt, 2) if dt > 0 else 0.0
        ).detail("Mean", round(interval.mean, 6)).detail(
            "P50", interval.percentile(0.50)).detail(
            "P95", interval.percentile(0.95)).detail(
            "P99", interval.percentile(0.99)).detail(
            "Max", round(interval.max, 6)).log()
    ev.log()
