"""Slow-task detection and the sampling profiler (a copy of
foundationdb_tpu/core/profiler.py; reference flow/Profiler.actor.cpp and
Net2's SlowTask trace events).

install_slow_task_detection times each callback the loop dispatches
(EventLoop.callback_hook) on the wall clock and logs a SlowTask event for
one that holds the loop past the threshold.  The event, its entry in the
loop's `slow_tasks` list (callback, wall ms) and the loop's
`slowest_callback` (callback, wall ms) are read by people and tests;
none of them reaches the run digest (core/trace.py UNFOLDED_TYPES), so
no wall-clock read decides anything a simulation folds.

SamplingProfiler samples the reactor thread's stack from a daemon thread
(sys._current_frames) and reports hot stacks; maybe_start_profiler starts
the process's one profiler when FDB_PROFILE=1.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import Counter
from typing import List, Optional, Tuple

from .trace import Severity, TraceEvent

SLOW_TASK_THRESHOLD_S = 0.25


def install_slow_task_detection(loop, threshold_s: Optional[float] = None
                                ) -> None:
    """Time each dispatched callback (idle sleeps and selector waits are
    not counted) and log a SlowTask event when one passes the threshold
    (SLOW_TASK_THRESHOLD_S unless given).  Idempotent per loop."""
    if threshold_s is None:
        threshold_s = SLOW_TASK_THRESHOLD_S
    if getattr(loop, "_slow_task_installed", False):
        return
    loop._slow_task_installed = True
    loop.slow_tasks = []
    loop.slowest_callback = ("", 0.0)
    slowest = [0.0]

    def timing_hook(fn):
        t0 = time.monotonic()
        fn()
        dt = time.monotonic() - t0
        if dt > slowest[0]:
            slowest[0] = dt
            loop.slowest_callback = (
                getattr(fn, "__qualname__", repr(fn))[:80],
                round(dt * 1e3, 1))
        if dt > threshold_s:
            name = getattr(fn, "__qualname__", repr(fn))[:80]
            ms = round(dt * 1e3, 1)
            loop.slow_tasks.append((name, ms))
            TraceEvent("SlowTask", Severity.Warn).detail(
                "DurationMs", ms).detail(
                "ThresholdMs", round(threshold_s * 1e3, 1)).detail(
                "Callback", name).log()

    loop.callback_hook = timing_hook


class SamplingProfiler:
    def __init__(self, interval_s: float = 0.01,
                 target_thread: Optional[int] = None) -> None:
        self.interval_s = interval_s
        self.target = target_thread or threading.main_thread().ident
        self.samples: Counter = Counter()
        self.total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # report() on the reactor thread against inserts on the sampler's.
        self._lock = threading.Lock()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fdb-profiler")
        self._thread.start()

    def _run(self) -> None:
        import sys
        while not self._stop.wait(self.interval_s):
            frame = sys._current_frames().get(self.target)
            if frame is None:
                continue
            stack = tuple(
                f"{fr.f_code.co_filename.rsplit('/', 1)[-1]}:"
                f"{fr.f_code.co_name}:{lineno}"
                for fr, lineno in traceback.walk_stack(frame))
            # Innermost first, capped: deep stacks share the loop's frames.
            with self._lock:
                self.samples[stack[:12]] += 1
                self.total += 1

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None

    def report(self, top: int = 10) -> List[Tuple[float, str]]:
        """[(fraction of samples, 'inner <- outer stack'), ...]"""
        with self._lock:
            snapshot = Counter(self.samples)
            total = self.total
        return [(n / max(total, 1), " <- ".join(stack[:5]))
                for stack, n in snapshot.most_common(top)]

    def log_report(self, top: int = 10) -> None:
        for frac, stack in self.report(top):
            TraceEvent("ProfilerHotStack").detail(
                "Fraction", round(frac, 4)).detail("Stack", stack).log()


# One profiler a process: only the first call with FDB_PROFILE=1 starts it.
_profiler: Optional[SamplingProfiler] = None


def maybe_start_profiler(spawn=None, dump_interval_s: float = 30.0
                         ) -> Optional[SamplingProfiler]:
    """Start the process's SamplingProfiler when FDB_PROFILE=1
    (idempotent); with `spawn`, also an actor that logs the hot stacks
    every `dump_interval_s` seconds."""
    import os
    global _profiler
    if os.environ.get("FDB_PROFILE") != "1":
        return None
    if _profiler is not None:
        return _profiler
    _profiler = SamplingProfiler()
    _profiler.start()
    if spawn is not None:
        async def _dump() -> None:
            from .scheduler import delay
            while True:
                await delay(dump_interval_s)
                _profiler.log_report()
        spawn(_dump(), "profiler.dump")
    return _profiler
