"""Thread offload for blocking work (a copy of
foundationdb_tpu/core/threadpool.py; reference flow/IThreadPool.h).

The reactor (core/scheduler.py EventLoop) is single-threaded; a synchronous
fsync or other long blocking call on it stalls every connection and
timer of the process (the reference routes such work through IThreadPool /
CoroFlow for the same reason).  `run_blocking(fn, *args)` runs `fn` on a
worker thread and resumes the awaiting actor on the reactor:

- REAL mode: a shared ThreadPoolExecutor per loop; completions post to a
  thread-safe queue and wake the reactor through a self-pipe registered
  with add_reader (the reactor may be parked in selector.select with no
  timers due — a plain call_soon from another thread would not wake it).
- SIM mode: the fn runs INLINE and completion is delivered through a
  zero-delay timer, preserving the simulator's determinism (reference
  CoroFlow adapts threaded interfaces back onto the deterministic net in
  simulation the same way).  Virtual cost can be charged with `sim_cost`.

Thread-safety contract: `fn` must not touch loop-owned state; callers are
responsible for not mutating the objects `fn` reads while it runs (every
current caller awaits the result before issuing dependent work).
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Callable

from .futures import Future, Promise
from .scheduler import EventLoop, get_event_loop

_MAX_WORKERS = 4


class LoopThreadPool:
    """Per-EventLoop offload pool; create via `pool_for(loop)`."""

    def __init__(self, loop: EventLoop) -> None:
        self.loop = loop
        self._executor = None
        self._done: collections.deque = collections.deque()
        self._wake_r = self._wake_w = None

    # -- real-mode plumbing --------------------------------------------------
    def _ensure_real(self) -> None:
        if self._executor is not None:
            return
        from concurrent.futures import ThreadPoolExecutor
        self._executor = ThreadPoolExecutor(
            max_workers=_MAX_WORKERS,
            thread_name_prefix="fdb-torch-threadpool")
        r, w = os.pipe()
        os.set_blocking(r, False)
        self._wake_r, self._wake_w = r, w
        self.loop.add_reader(r, self._drain)

    def _drain(self) -> None:
        try:
            while os.read(self._wake_r, 4096):
                pass
        except BlockingIOError:
            pass
        while self._done:
            promise, ok, value = self._done.popleft()
            if ok:
                promise.send(value)
            else:
                promise.send_error(value)

    def run(self, fn: Callable[..., Any], *args, sim_cost: float = 0.0
            ) -> Future:
        p: Promise = Promise()
        if self.loop.sim:
            # Deterministic: execute inline, deliver via the timer heap.
            try:
                value, ok = fn(*args), True
            except Exception as e:  # noqa: BLE001 — routed to the future
                value, ok = e, False
            def deliver():
                if ok:
                    p.send(value)
                else:
                    p.send_error(value)
            self.loop.call_at(self.loop.now() + sim_cost, deliver)
            return p.get_future()
        self._ensure_real()

        def work():
            try:
                result = (fn(*args), True)
            except Exception as e:  # noqa: BLE001 — routed to the future
                result = (e, False)
            self._done.append((p, result[1], result[0]))
            try:
                os.write(self._wake_w, b"x")
            except OSError:
                pass
        self._executor.submit(work)
        return p.get_future()

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        if self._wake_r is not None:
            self.loop.remove_reader(self._wake_r)
            os.close(self._wake_r)
            os.close(self._wake_w)
            self._wake_r = self._wake_w = None


def pool_for(loop: EventLoop = None) -> LoopThreadPool:
    loop = loop or get_event_loop()
    pool = getattr(loop, "_thread_pool", None)
    if pool is None:
        pool = loop._thread_pool = LoopThreadPool(loop)
    return pool


async def run_blocking(fn: Callable[..., Any], *args,
                       sim_cost: float = 0.0) -> Any:
    """Run `fn(*args)` off the reactor thread; await its result."""
    return await pool_for().run(fn, *args, sim_cost=sim_cost)


def current_thread_is_reactor() -> bool:
    return threading.current_thread() is threading.main_thread()
