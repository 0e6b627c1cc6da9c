"""The port's event loop, on virtual time (simulation) or on the wall
clock with a real-IO reactor, and the hook a caller's loop is installed
by (a copy of foundationdb_tpu/core/scheduler.py).

The reference runs all logic of a process on ONE network thread: a reactor
with a priority-ordered ready queue plus timers (reference
flow/Net2.actor.cpp Net2::run :1400, TaskPriority ordering), in simulation
on virtual time (reference fdbrpc/sim2.actor.cpp).  EventLoop keeps both:

  * single-threaded; all actors interleave only at awaits;
  * timers in a heap keyed (time, -priority, seq) -- seq makes ordering
    total and deterministic;
  * sim mode (the default): time jumps to the next timer when the ready
    queue drains;
  * real mode (`EventLoop(sim=False)`): time is the wall clock since the
    loop was made, and the loop waits on a selector for file descriptors
    (add_reader / add_writer: the sockets of rpc/real_network.py, the
    self-pipe of core/threadpool.py) until the next timer is due;
    run_forever serves until stop().

Device work runs inline on this thread: a Resolver role's call returns
once its batch is resolved on the card.

The hook: set_event_loop installs a loop, and now(), delay(), spawn() and
yield_now() go to it.  Any object with `now()` and `delay(seconds)` will
do for the supervisor's clock and its metrics actor (a caller may install
the reference's loop); with no loop installed, now() is monotonic wall
time and the others raise.

Left out: the run digest's fold of each dispatched task and the callback
hook of the reference's slow-task profiler, which belong to its
simulator's unseed check; and PollBackoff.
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from enum import IntEnum
from typing import Callable, List, Optional

from .error import err
from .futures import ActorTask, Future, Promise


class TaskPriority(IntEnum):
    """The reference's flow/network.h TaskPriority values the port's
    loop and its streams are handed (higher runs first)."""

    FailureMonitor = 8700
    ResolutionMetrics = 8700
    TLogPop = 8610
    TLogPeek = 8590
    TLogCommit = 8570
    ProxyGetRawCommittedVersion = 8565
    ProxyResolverReply = 8560
    ProxyCommit = 8540
    TLogConfirmRunning = 8510
    GetConsistentReadVersion = 8500
    DefaultPromiseEndpoint = 8000
    DefaultDelay = 7010
    DefaultYield = 7000
    DefaultEndpoint = 5000
    Low = 1


class EventLoop:
    """One logical process thread; the only scheduler of the port's
    actors.  `sim`: virtual time (True) or the wall clock with the
    real-IO reactor (False)."""

    def __init__(self, sim: bool = True, start_time: float = 0.0) -> None:
        self.sim = sim
        self._time = start_time
        self._epoch_real = _time.monotonic() - start_time
        self._heap: List = []  # (time, -priority, seq, fn)
        # Tie-break sequence for heap entries: an itertools.count, whose
        # __next__ is one C call (a __del__-driven broken promise may
        # schedule from whatever thread the collector runs on).
        self._seq_counter = itertools.count(1)
        self._tasks: set = set()
        self._stopped = False
        # The real-IO half (reference Net2: the reactor fused with the
        # task queue, Net2.actor.cpp:1400 Net2::run); real mode only.
        self._selector = None
        self._io_cbs: dict = {}   # fileobj -> [reader_cb, writer_cb]

    # -- real-IO reactor (real mode only) ------------------------------------
    def _sel(self):
        if self._selector is None:
            import selectors
            self._selector = selectors.DefaultSelector()
        return self._selector

    def _io_update(self, fileobj) -> None:
        import selectors
        sel = self._sel()
        cbs = self._io_cbs.get(fileobj)
        mask = 0
        if cbs is not None:
            if cbs[0] is not None:
                mask |= selectors.EVENT_READ
            if cbs[1] is not None:
                mask |= selectors.EVENT_WRITE
        try:
            if mask == 0:
                self._io_cbs.pop(fileobj, None)
                sel.unregister(fileobj)
            else:
                sel.modify(fileobj, mask, fileobj)
        except KeyError:
            if mask:
                sel.register(fileobj, mask, fileobj)

    def add_reader(self, fileobj, cb: Callable[[], None]) -> None:
        self._io_cbs.setdefault(fileobj, [None, None])[0] = cb
        self._io_update(fileobj)

    def remove_reader(self, fileobj) -> None:
        if fileobj in self._io_cbs:
            self._io_cbs[fileobj][0] = None
            self._io_update(fileobj)

    def add_writer(self, fileobj, cb: Callable[[], None]) -> None:
        self._io_cbs.setdefault(fileobj, [None, None])[1] = cb
        self._io_update(fileobj)

    def remove_writer(self, fileobj) -> None:
        if fileobj in self._io_cbs:
            self._io_cbs[fileobj][1] = None
            self._io_update(fileobj)

    def _poll_io(self, timeout: Optional[float]) -> bool:
        """Wait up to `timeout` for IO readiness and run the callbacks;
        whether any ran."""
        import selectors
        events = self._sel().select(timeout)
        ran = False
        for key, mask in events:
            cbs = self._io_cbs.get(key.fileobj)
            if cbs is None:
                continue
            if (mask & selectors.EVENT_READ) and cbs[0] is not None:
                cbs[0]()
                ran = True
            if (mask & selectors.EVENT_WRITE) and cbs[1] is not None:
                cbs[1]()
                ran = True
        return ran

    # -- time ---------------------------------------------------------------
    def now(self) -> float:
        if self.sim:
            return self._time
        return _time.monotonic() - self._epoch_real

    # -- scheduling primitives ---------------------------------------------
    def call_at(self, when: float, fn: Callable[[], None],
                priority: TaskPriority = TaskPriority.DefaultDelay) -> None:
        heapq.heappush(self._heap,
                       (when, -int(priority), next(self._seq_counter), fn))

    def call_soon(self, fn: Callable[[], None],
                  priority: TaskPriority = TaskPriority.DefaultYield) -> None:
        self.call_at(self.now(), fn, priority)

    def delay(self, seconds: float,
              priority: TaskPriority = TaskPriority.DefaultDelay) -> Future:
        p: Promise = Promise()
        self.call_at(self.now() + seconds, lambda: p.send(None), priority)
        return p.get_future()

    def yield_now(self, priority: TaskPriority = TaskPriority.DefaultYield
                  ) -> Future:
        return self.delay(0.0, priority)

    # -- actors -------------------------------------------------------------
    def spawn(self, coro, name: str = "") -> Future:
        """Start an actor; returns its Future. Cancelling the Future
        cancels it."""
        task = ActorTask(coro, self, name)
        self._tasks.add(task)
        self.call_soon(task._initial_step)
        return task.future

    def _task_done(self, task: ActorTask) -> None:
        self._tasks.discard(task)

    # -- running ------------------------------------------------------------
    def run_until(self, future: Future, timeout: Optional[float] = None
                  ) -> object:
        """Drive the loop until `future` resolves; returns its value or
        raises its error.  timed_out past `timeout` seconds of virtual
        time; internal_error when nothing is left to run and the future
        is still pending."""
        deadline = None if timeout is None else self.now() + timeout
        while not future.is_ready():
            if self._stopped:
                break
            if not self._step_once(deadline):
                if future.is_ready():
                    break
                if deadline is not None and (
                        not self._heap or self._heap[0][0] > deadline):
                    raise err("timed_out",
                              f"run_until timed out at t={self.now():.3f}")
                # Queue drained with no timeout: a deadlock, not a timeout.
                raise err("internal_error",
                          f"event loop drained at t={self.now():.3f} with "
                          "future still pending (deadlocked or orphaned "
                          "future)")
        self._stopped = False
        return future.get()

    def run_for(self, seconds: float) -> None:
        """Advance time by `seconds`, running what falls due (in real
        mode, the timers due by then; the wall clock is not waited on)."""
        end = self.now() + seconds
        while self._heap and self._heap[0][0] <= end:
            self._step_once(None)
        if self.sim and self._time < end:
            self._time = end

    def _step_once(self, deadline: Optional[float]) -> bool:
        """Run one scheduled callback (or, in real mode, the IO callbacks
        that became ready); False if nothing is due before `deadline`."""
        if self.sim:
            if not self._heap:
                return False
            when, _negprio, _seq, fn = self._heap[0]
            if deadline is not None and when > deadline:
                self._time = deadline
                return False
            heapq.heappop(self._heap)
            if when > self._time:
                self._time = when
            fn()
            return True
        # Real mode: wait for whichever comes first -- the next timer, the
        # deadline or IO readiness -- running IO as it arrives (reference
        # Net2::run).
        has_io = bool(self._io_cbs)
        while True:
            now = self.now()
            when = self._heap[0][0] if self._heap else None
            if when is not None and when <= now:
                break                       # a timer is due: run it below
            target = when
            if deadline is not None:
                target = deadline if target is None else min(target, deadline)
            if not has_io:
                if when is None:
                    return False            # no work at all
                if deadline is not None and when > deadline:
                    return False            # nothing before the deadline
                _time.sleep(when - now)
                break
            timeout = None if target is None else max(0.0, target - now)
            if self._poll_io(timeout):
                return True                 # IO callbacks ran
            if deadline is not None and self.now() >= deadline \
                    and (when is None or when > deadline):
                return False
            if when is None:
                continue                    # IO only: keep waiting
        _when, _negprio, _seq, fn = heapq.heappop(self._heap)
        fn()
        return True

    def stop(self) -> None:
        """Make the run_until or run_forever in progress return at its
        next step (run_until's future then raises internal_error if
        still pending)."""
        self._stopped = True

    def run_forever(self) -> None:
        """Serve until stop(), or until no timer and no IO source is left:
        the real-mode process main loop."""
        self._stopped = False
        while not self._stopped:
            if not self._step_once(None):
                if not self._io_cbs and not self._heap:
                    return
        self._stopped = False

    def drain(self, max_steps: int = 10_000_000) -> None:
        """Run until no work remains."""
        steps = 0
        while self._step_once(None):
            steps += 1
            if steps >= max_steps:
                raise err("internal_error",
                          "EventLoop.drain exceeded max_steps")

    def shutdown(self) -> None:
        """Close actors that were spawned but never stepped: a discarded
        loop can hold ActorTasks whose _initial_step never ran, and their
        coroutine objects would warn "never awaited" at collection.
        Started actors are left alone.  The selector of a real-mode loop
        is closed."""
        for task in list(self._tasks):
            if not task._started and not task._finished:
                task._finished = True
                try:
                    task.coro.close()
                except Exception:  # noqa: BLE001 -- teardown is best-effort
                    pass
        self._tasks.clear()
        if self._selector is not None:
            self._selector.close()
            self._selector = None
            self._io_cbs.clear()


# ---------------------------------------------------------------------------
# The installed loop (the reference's g_network)
# ---------------------------------------------------------------------------

_current = None


def set_event_loop(loop) -> None:
    """Install `loop` (or None to remove it).  A different port EventLoop
    being replaced is shut down (EventLoop.shutdown)."""
    global _current
    old, _current = _current, loop
    if isinstance(old, EventLoop) and old is not loop:
        old.shutdown()


def current_event_loop_or_none():
    """The installed loop, or None."""
    return _current


def get_event_loop():
    if _current is None:
        raise RuntimeError("no event loop installed (core.scheduler."
                           "set_event_loop)")
    return _current


def now() -> float:
    """The installed loop's time, or monotonic wall time without one."""
    if _current is not None:
        return _current.now()
    return _time.monotonic()


def delay(seconds: float, priority: TaskPriority = TaskPriority.DefaultDelay):
    """The installed loop's delay(seconds), for an actor of that loop to
    await.  The priority goes to a port EventLoop only."""
    loop = get_event_loop()
    if isinstance(loop, EventLoop):
        return loop.delay(seconds, priority)
    return loop.delay(seconds)


def yield_now(priority: TaskPriority = TaskPriority.DefaultYield) -> Future:
    return get_event_loop().yield_now(priority)


def spawn(coro, name: str = "") -> Future:
    return get_event_loop().spawn(coro, name)
