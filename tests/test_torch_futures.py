"""The port's event loop and futures (foundationdb_tpu_torch/core/
scheduler.py EventLoop, core/futures.py) against the JAX package's
(foundationdb_tpu/core/): seeded actor programs run under each loop must
give the same trace of (virtual time, event), exactly."""

import random
from types import SimpleNamespace

import pytest

from foundationdb_tpu.core import error as ref_error
from foundationdb_tpu.core import futures as ref_futures
from foundationdb_tpu.core import scheduler as ref_scheduler
from foundationdb_tpu_torch.core import error as port_error
from foundationdb_tpu_torch.core import futures as port_futures
from foundationdb_tpu_torch.core import scheduler as port_scheduler


def ns(futures, scheduler, error, make_loop):
    return SimpleNamespace(
        loop=make_loop(), Promise=futures.Promise,
        PromiseStream=futures.PromiseStream, AsyncVar=futures.AsyncVar,
        AsyncTrigger=futures.AsyncTrigger, wait_all=futures.wait_all,
        wait_any=futures.wait_any, swallow=futures.swallow,
        ready_future=futures.ready_future, error_future=futures.error_future,
        FdbError=error.FdbError, ActorCancelled=error.ActorCancelled,
        err=error.err, TaskPriority=scheduler.TaskPriority)


def ref_ns():
    return ns(ref_futures, ref_scheduler, ref_error,
              lambda: ref_scheduler.EventLoop(sim=True))


def port_ns():
    return ns(port_futures, port_scheduler, port_error,
              port_scheduler.EventLoop)


def program(n, seed: int) -> list:
    """One seeded actor program: delays and sub-actors, wait_all and
    wait_any, a PromiseStream's order and its end, cancellation mid-wait
    with an await in the cancelled actor's cleanup, AsyncVar.on_change,
    an AsyncTrigger, broken promises, error and ready futures, swallow,
    same-time callbacks at different priorities, and run_until's
    timeout.  Returns the trace of (virtual time, event)."""
    r = random.Random(seed)
    loop = n.loop
    trace = []

    def log(*event):
        trace.append((round(loop.now(), 9), event))

    def d():
        return r.choice([0.0, 0.001, 0.0025, 0.01, 0.1, 0.5])

    async def worker(i, steps):
        for s in steps:
            await loop.delay(s)
            log("worker", i, s)
        return i * 10

    async def parent():
        kids = [loop.spawn(worker(i, [d() for _ in range(r.randrange(1, 4))]))
                for i in range(r.randrange(2, 6))]
        got = await n.wait_all(kids)
        log("wait_all", tuple(got))
        idx, val = await n.wait_any([loop.delay(d() + 0.003),
                                     loop.spawn(worker(99, [d()]))])
        log("wait_any", idx, val)

    stream = n.PromiseStream()

    async def producer():
        for v in range(r.randrange(3, 9)):
            await loop.delay(d())
            stream.send(("v", v))
            log("sent", v)
        stream.close()
        log("closed")

    async def consumer():
        async for v in stream:
            log("recv", v)
        log("end_of_stream")

    async def victim():
        try:
            await loop.delay(5.0)
            log("victim woke")
        except n.ActorCancelled:
            log("victim cancelled")
            await loop.delay(0.002)
            log("victim cleaned up")
            raise

    async def canceller(f):
        await loop.delay(d() + 0.004)
        f.cancel()
        log("cancel sent")
        try:
            await f
        except n.FdbError as e:
            log("cancelled future", e.name)

    var = n.AsyncVar(0)

    async def watcher():
        for _ in range(3):
            await var.on_change()
            log("var", var.get())

    async def setter():
        for v in (1, 1, 2, 3, 4):
            await loop.delay(d() + 0.001)
            var.set(v)
            log("set", v)

    trig = n.AsyncTrigger()

    async def triggered():
        await trig.on_trigger()
        log("triggered")

    async def broken():
        p = n.Promise()
        f = p.get_future()
        del p
        try:
            await f
        except n.FdbError as e:
            log("broken", e.name)
        try:
            await n.error_future(n.err("not_committed"))
        except n.FdbError as e:
            log("error_future", e.name)
        log("ready", await n.ready_future(7))
        p2 = n.Promise()
        sw = n.swallow(p2.get_future())
        loop.call_soon(lambda: p2.send_error(n.err("timed_out")))
        await sw
        log("swallowed", p2.get_future().is_error())
        trig.trigger()

    for pri in r.sample([n.TaskPriority.DefaultDelay,
                         n.TaskPriority.DefaultYield,
                         n.TaskPriority.DefaultEndpoint,
                         n.TaskPriority.Low], 4):
        loop.call_at(0.25, lambda p=pri: log("call_at", int(p)), pri)

    futs = [loop.spawn(parent()), loop.spawn(producer()),
            loop.spawn(consumer()), loop.spawn(watcher()),
            loop.spawn(setter()), loop.spawn(triggered()),
            loop.spawn(broken())]
    v = loop.spawn(victim())
    futs.append(loop.spawn(canceller(v)))
    loop.run_until(n.wait_all(futs), timeout=60.0)
    log("all done")
    never = n.Promise()
    try:
        loop.run_until(never.get_future(), timeout=r.choice([0.5, 1.25]))
    except n.FdbError as e:
        log("run_until", e.name)
    loop.run_for(0.75)
    log("run_for")
    loop.drain()
    log("drained")
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_event_loop_traces_match(seed):
    want = program(ref_ns(), seed)
    got = program(port_ns(), seed)
    assert got == want
    events = {e[0] for _, e in got}
    assert {"victim cancelled", "victim cleaned up", "broken",
            "end_of_stream", "run_until", "triggered"} <= events


def test_run_until_deadlock_and_cancel_before_start():
    """A drained loop with its future pending raises internal_error; an
    actor cancelled before its first step never runs its body."""
    for n in (ref_ns(), port_ns()):
        ran = []

        async def body():
            ran.append(1)
        f = n.loop.spawn(body())
        f.cancel()
        with pytest.raises(n.FdbError) as e:
            n.loop.run_until(f)
        assert e.value.name == "operation_cancelled" and not ran
        n.loop.drain()
        assert not ran
        with pytest.raises(n.FdbError) as e:
            n.loop.run_until(n.Promise().get_future())
        assert e.value.name in ("internal_error", "broken_promise")


def test_hook_serves_the_port_loop_and_a_reference_loop():
    """set_event_loop installs either package's loop: now() and delay()
    follow it; with none installed now() is wall time and delay()
    raises."""
    port_scheduler.set_event_loop(None)
    with pytest.raises(RuntimeError):
        port_scheduler.delay(1.0)
    for loop in (port_scheduler.EventLoop(),
                 ref_scheduler.EventLoop(sim=True)):
        port_scheduler.set_event_loop(loop)
        try:
            f = port_scheduler.delay(0.5)
            loop.run_until(f)
            assert port_scheduler.now() == loop.now() == 0.5
        finally:
            port_scheduler.set_event_loop(None)


def test_stop_ends_run_until():
    """stop() makes the port loop's run_until return at its next step:
    a future still pending then raises internal_error, and the loop runs
    again afterwards."""
    loop = port_scheduler.EventLoop()

    async def stopper():
        await loop.yield_now()
        await loop.delay(1.0)
        loop.stop()
    loop.spawn(stopper())
    held = port_futures.Promise()
    with pytest.raises(port_error.FdbError) as e:
        loop.run_until(held.get_future())
    assert e.value.name == "internal_error" and loop.now() == 1.0
    loop.call_soon(lambda: held.send(5))
    assert loop.run_until(held.get_future()) == 5
