"""Futures, promises, streams and actor coroutines (a copy of
foundationdb_tpu/core/futures.py).

The reference builds everything on Flow's single-assignment Future/Promise
pairs and an actor compiler turning `ACTOR` functions into state machines
(reference: flow/flow.h, flow/actorcompiler/ActorCompiler.cs).  Python
native coroutines (`async def`) are the actors, driven by the event loop
in core/scheduler.py.  Semantics kept from the reference:

  * single-assignment: a Future is set exactly once (value or error);
  * broken_promise: if a Promise is dropped unset, waiters get the
    broken_promise error (flow/flow.h SAV semantics);
  * cancellation: cancelling the Future returned by an actor injects
    ActorCancelled into the coroutine at its current suspension point
    (mirrors actor cancellation on Future destruction);
  * streams: PromiseStream/FutureStream with end_of_stream.

An ActorTask carries the simulated process it runs on (set by
SimProcess.spawn, inherited by the actors it spawns): the SimNetwork
reads it as the source address of the requests the actor sends.

Left out: quorum and map_future, which nothing of the port calls.
"""

from __future__ import annotations

import inspect
from collections import deque
from typing import Any, Callable, Generic, Iterable, List, Optional, TypeVar

from .error import ActorCancelled, FdbError, err

T = TypeVar("T")

_PENDING = 0
_VALUE = 1
_ERROR = 2


class Future(Generic[T]):
    """Single-assignment asynchronous value; awaitable from actor coroutines."""

    __slots__ = ("_state", "_result", "_callbacks", "_source_task")

    def __init__(self) -> None:
        self._state = _PENDING
        self._result: Any = None
        self._callbacks: List[Callable[[Future], None]] = []
        # Actor task that will fulfill this future (for cancellation), if any.
        self._source_task: Optional["ActorTask"] = None

    # -- inspection ---------------------------------------------------------
    def is_ready(self) -> bool:
        return self._state != _PENDING

    def is_error(self) -> bool:
        return self._state == _ERROR

    def get(self) -> T:
        """Value if ready; raises if error or pending."""
        if self._state == _VALUE:
            return self._result
        if self._state == _ERROR:
            raise self._result
        raise err("internal_error", "Future.get() on pending future")

    @property
    def error(self) -> Optional[BaseException]:
        return self._result if self._state == _ERROR else None

    # -- resolution ---------------------------------------------------------
    def _send(self, value: T) -> None:
        if self._state != _PENDING:
            raise err("internal_error", "Future already set")
        self._state = _VALUE
        self._result = value
        self._fire()

    def _send_error(self, e: BaseException) -> None:
        if self._state != _PENDING:
            raise err("internal_error", "Future already set")
        self._state = _ERROR
        self._result = e
        self._fire()

    def _fire(self) -> None:
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def on_ready(self, cb: Callable[["Future"], None]) -> None:
        if self._state != _PENDING:
            cb(self)
        else:
            self._callbacks.append(cb)

    def remove_callback(self, cb: Callable[["Future"], None]) -> None:
        try:
            self._callbacks.remove(cb)
        except ValueError:
            pass

    # -- cancellation -------------------------------------------------------
    def cancel(self) -> None:
        """Cancel the actor computing this future (if any and still pending)."""
        if self._state == _PENDING and self._source_task is not None:
            self._source_task.cancel()

    # -- awaitable protocol -------------------------------------------------
    def __await__(self):
        if self._state == _PENDING:
            yield self
        if self._state == _ERROR:
            raise self._result
        if self._state == _PENDING:
            raise err("internal_error", "Future resumed while pending")
        return self._result


def ready_future(value: T = None) -> Future:
    f: Future = Future()
    f._send(value)
    return f


def error_future(e: BaseException) -> Future:
    f: Future = Future()
    f._send_error(e)
    return f


class Promise(Generic[T]):
    """The write end of a Future (single assignment).

    Dropping the last reference to an unset Promise breaks it: waiters get
    broken_promise (reference flow/flow.h SAV destruction semantics)."""

    __slots__ = ("_future", "_sent", "__weakref__")

    def __init__(self) -> None:
        self._future: Future = Future()
        self._sent = False

    def get_future(self) -> Future:
        return self._future

    def send(self, value: T = None) -> None:
        self._sent = True
        self._future._send(value)

    def send_error(self, e: BaseException) -> None:
        self._sent = True
        self._future._send_error(e)

    def is_set(self) -> bool:
        return self._sent

    def break_promise(self) -> None:
        if not self._sent and not self._future.is_ready():
            self._sent = True   # spent: later send/send_error must no-op
            self._future._send_error(err("broken_promise"))

    def __del__(self) -> None:
        try:
            self.break_promise()
        except Exception:  # pragma: no cover - interpreter shutdown
            pass


END_OF_STREAM = FdbError(1, "end_of_stream")


class PromiseStream(Generic[T]):
    """Multi-value FIFO stream (reference flow/flow.h PromiseStream/FutureStream).

    Values are buffered; each pop() returns a Future of the next value.
    send_error()/close() terminates the stream for all future pops."""

    __slots__ = ("_queue", "_waiters", "_closed_error")

    def __init__(self) -> None:
        self._queue: deque = deque()
        self._waiters: deque = deque()
        self._closed_error: Optional[BaseException] = None

    def send(self, value: T = None) -> None:
        if self._closed_error is not None:
            return
        while self._waiters:
            w = self._waiters.popleft()
            # Deliver only to a waiter some actor is actually awaiting
            # (it has a resume callback).  A pending-but-callback-less
            # waiter is ABANDONED: its consumer was cancelled after
            # pop() (ActorTask.cancel detaches the callback), e.g. a
            # stopped role's stream servers.  Delivering into it would
            # swallow exactly one message per cancelled consumer; the
            # re-run consumer then waits forever for a request whose
            # sender waits forever for a reply.
            if not w.is_ready() and w._callbacks:
                w._send(value)
                return
        self._queue.append(value)

    def send_error(self, e: BaseException) -> None:
        if self._closed_error is not None:
            return
        self._closed_error = e
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            if not w.is_ready():
                w._send_error(e)

    def close(self) -> None:
        self.send_error(END_OF_STREAM)

    def pop(self) -> Future:
        """Future of the next stream value.

        Await the returned future DIRECTLY (or via the async-for
        protocol).  Do not hold it across a combinator (e.g.
        `wait_any([pop_f, delay(t)])` and re-await after the timeout):
        send() treats a pending waiter with no attached consumer
        callback as abandoned-by-cancellation and drops it — the value
        is preserved for the NEXT pop(), but a dropped future re-awaited
        later never resolves."""
        f: Future = Future()
        if self._queue:
            f._send(self._queue.popleft())
        elif self._closed_error is not None:
            f._send_error(self._closed_error)
        else:
            self._waiters.append(f)
        return f

    def empty(self) -> bool:
        return not self._queue

    def break_buffered_replies(self) -> None:
        """Break the reply promise of every buffered-but-unserved request
        (the server died before popping them).  An explicit protocol —
        callers must not grope stream internals, or a rename silently
        reverts promise breaks to GC-timing dependence."""
        for req in self._queue:
            reply = getattr(req, "reply", None)
            if reply is not None and hasattr(reply, "send_error") and \
                    not reply.is_set():
                reply.send_error(err("broken_promise"))
        self._queue.clear()

    def __len__(self) -> int:
        return len(self._queue)

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.pop()
        except FdbError as e:
            if e.code == 1:  # end_of_stream
                raise StopAsyncIteration from None
            raise


FutureStream = PromiseStream  # reader alias


class AsyncVar(Generic[T]):
    """A variable you can wait on for changes (reference flow AsyncVar)."""

    __slots__ = ("_value", "_change")

    def __init__(self, value: T = None) -> None:
        self._value = value
        self._change: Future = Future()

    def get(self) -> T:
        return self._value

    def set(self, value: T) -> None:
        if value != self._value:
            self._value = value
            self.trigger()

    def trigger(self) -> None:
        old, self._change = self._change, Future()
        old._send(None)

    def on_change(self) -> Future:
        return self._change


class AsyncTrigger:
    """Edge trigger: on_trigger() futures resolve at each trigger()."""

    __slots__ = ("_inner",)

    def __init__(self) -> None:
        self._inner = AsyncVar(0)

    def trigger(self) -> None:
        self._inner.trigger()

    def on_trigger(self) -> Future:
        return self._inner.on_change()


_current_task: "Optional[ActorTask]" = None


def current_task() -> "Optional[ActorTask]":
    """The ActorTask whose coroutine body is executing right now (None
    between actor steps / in harness code)."""
    return _current_task


class ActorTask:
    """Drives one actor coroutine on the event loop (our ACTOR equivalent)."""

    __slots__ = ("coro", "future", "_loop", "_cancelled", "_waiting_on",
                 "_resume_cb", "name", "_finished", "_started", "process")

    def __init__(self, coro, loop, name: str = "") -> None:
        assert inspect.iscoroutine(coro), f"spawn() needs a coroutine, got {coro!r}"
        self.coro = coro
        self.future: Future = Future()
        self.future._source_task = self
        self._loop = loop
        self._cancelled = False
        self._finished = False
        self._started = False
        self._waiting_on: Optional[Future] = None
        self._resume_cb: Optional[Callable] = None
        self.name = name or getattr(coro, "__name__", "actor")
        # The simulated process this actor runs on (set by
        # SimProcess.spawn; inherited by the actors it spawns): the sim
        # network's source address.  None for harness and client actors.
        self.process = current_task().process \
            if current_task() is not None else None

    def _initial_step(self) -> None:
        if self._cancelled or self._finished:
            # Cancelled before first execution: like Flow, the body never runs.
            if not self._finished:
                self.coro.close()
                self._finish_cancel()
            return
        self._started = True
        self._step()

    def _step(self, send_value=None, throw_exc: Optional[BaseException] = None) -> None:
        """Advance the coroutine one suspension; hook its next awaited Future.

        Also drives post-cancellation cleanup: if the coroutine awaits during
        unwind (e.g. in a finally block) we keep re-hooking until it finishes."""
        global _current_task
        if self._finished:
            return
        self._waiting_on = None
        # Ambient actor context while the coroutine body runs: spawned
        # actors inherit this task's process, and the sim network reads it
        # as the source address of outgoing requests.
        prev_task, _current_task = _current_task, self
        try:
            try:
                if throw_exc is not None:
                    awaited = self.coro.throw(throw_exc)
                else:
                    awaited = self.coro.send(send_value)
            except StopIteration as stop:
                self._finish_value(stop.value)
                return
            except ActorCancelled as e:
                # Drop the traceback NOW: it pins the whole unwound frame
                # chain (and those frames' locals — e.g. held reply
                # promises) until cyclic GC happens to run, making
                # broken_promise delivery wall-clock dependent.  Clearing
                # it restores the reference semantics of Flow's SAV
                # destruction: refcounts free the frames immediately and
                # their promises break deterministically.
                e.__traceback__ = None
                del e
                self._finish_cancel()
                return
            except BaseException as e:  # noqa: BLE001 - actor errors propagate via future
                self._finish_error(e)
                return
        finally:
            _current_task = prev_task

        if not isinstance(awaited, Future):
            self._finish_error(err("internal_error",
                                   f"actor {self.name} awaited non-Future {awaited!r}"))
            return
        self._waiting_on = awaited

        def resume(fut: Future, task=self) -> None:
            # Defer resumption through the loop: deterministic ordering and no
            # reentrant callback stacks.
            task._loop.call_soon(lambda: task._on_future_ready(fut))

        self._resume_cb = resume
        awaited.on_ready(resume)

    def _on_future_ready(self, fut: Future) -> None:
        # Note: a cancelled-but-unfinished actor still resumes here so that
        # `finally:` blocks containing awaits run to completion.
        if self._finished:
            return
        if fut.is_error():
            self._step(throw_exc=fut.error)
        else:
            self._step(send_value=fut._result)

    def _finish_value(self, value) -> None:
        self._finished = True
        if not self.future.is_ready():
            self.future._send(value)
        self._loop._task_done(self)

    def _finish_error(self, e: BaseException) -> None:
        self._finished = True
        if not self.future.is_ready():
            self.future._send_error(e)
        self._loop._task_done(self)

    def _finish_cancel(self) -> None:
        self._finished = True
        if not self.future.is_ready():
            self.future._send_error(err("operation_cancelled"))
        self._loop._task_done(self)

    def cancel(self) -> None:
        """Cancel the actor. Its future resolves operation_cancelled now; the
        coroutine unwinds via ActorCancelled at its suspension point, and any
        awaits in `finally:` cleanup continue to be driven to completion."""
        if self._finished or self._cancelled:
            return
        self._cancelled = True
        waiting, self._waiting_on = self._waiting_on, None
        if waiting is not None and self._resume_cb is not None:
            waiting.remove_callback(self._resume_cb)
        if not self.future.is_ready():
            self.future._send_error(err("operation_cancelled"))
        if self._started:
            # _step handles a coroutine that awaits during unwind by re-hooking.
            self._loop.call_soon(lambda: self._step(throw_exc=ActorCancelled()))
        # else: _initial_step will observe _cancelled and close the coroutine.


# ---------------------------------------------------------------------------
# Combinators (reference flow/genericactors.actor.h)
# ---------------------------------------------------------------------------

def _combinator(futures: List[Future], on_each: Callable) -> Future:
    """Shared plumbing: attach one callback per input; when `out` resolves,
    deregister callbacks from still-pending inputs so long-lived futures
    (e.g. a shutdown signal awaited in a loop) don't accumulate closures."""
    out: Future = Future()
    cbs: List = [None] * len(futures)

    def cleanup() -> None:
        for f, cb in zip(futures, cbs):
            if not f.is_ready() and cb is not None:
                f.remove_callback(cb)

    for i, f in enumerate(futures):
        def cb(fut: Future, i=i) -> None:
            if out.is_ready():
                return
            on_each(out, i, fut)
            if out.is_ready():
                cleanup()
        cbs[i] = cb
    # Attach after all cbs are recorded (a ready future fires immediately);
    # stop as soon as out resolves so no callback lingers on later inputs.
    for f, cb in zip(futures, cbs):
        if out.is_ready():
            break
        f.on_ready(cb)
    return out


def wait_all(futures: Iterable[Future]) -> Future:
    """Resolves with list of values when all are ready; first error wins."""
    futures = list(futures)
    if not futures:
        return ready_future([])
    results: List[Any] = [None] * len(futures)
    remaining = [len(futures)]

    def on_each(out: Future, i: int, f: Future) -> None:
        if f.is_error():
            out._send_error(f.error)
            return
        results[i] = f._result
        remaining[0] -= 1
        if remaining[0] == 0:
            out._send(results)

    return _combinator(futures, on_each)


def wait_any(futures: Iterable[Future]) -> Future:
    """Resolves with (index, value) of the first ready future (choose/when)."""
    futures = list(futures)
    if not futures:
        return error_future(err("internal_error", "wait_any of empty list"))

    def on_each(out: Future, i: int, f: Future) -> None:
        if f.is_error():
            out._send_error(f.error)
        else:
            out._send((i, f._result))

    return _combinator(futures, on_each)


def swallow(f: Future) -> Future:
    """Resolve (with None) when `f` resolves, success OR error — for racing
    fallible futures inside wait_any/wait_all without error propagation.
    Inspect `f` itself afterwards for the outcome."""
    out: Future = Future()
    f.on_ready(lambda fut: out._send(None) if not out.is_ready() else None)
    return out
