"""The port's simulated network and process surface
(foundationdb_tpu_torch/rpc/network.py, sim.py, peer_metrics.py,
failure_monitor.py, server/failure.py) against the JAX package's: the
same scripted actors, sends and faults under the same DeterministicRandom
seed, in each package's own event loop, give the same delivery order and
times (tolerance 0), the same broken_promise replies, the same peer
tables and the same failure-monitor verdicts."""

from types import SimpleNamespace

import pytest

from foundationdb_tpu.core import error as ref_error
from foundationdb_tpu.core import futures as ref_futures
from foundationdb_tpu.core import rng as ref_rng
from foundationdb_tpu.core import scheduler as ref_scheduler
from foundationdb_tpu.rpc import endpoint as ref_endpoint
from foundationdb_tpu.rpc import failure_monitor as ref_fm
from foundationdb_tpu.rpc import sim as ref_sim
from foundationdb_tpu.server import failure as ref_failure
from foundationdb_tpu_torch.core import error as port_error
from foundationdb_tpu_torch.core import futures as port_futures
from foundationdb_tpu_torch.core import rng as port_rng
from foundationdb_tpu_torch.core import scheduler as port_scheduler
from foundationdb_tpu_torch.rpc import endpoint as port_endpoint
from foundationdb_tpu_torch.rpc import failure_monitor as port_fm
from foundationdb_tpu_torch.rpc import sim as port_sim
from foundationdb_tpu_torch.server import failure as port_failure

REF = SimpleNamespace(error=ref_error, futures=ref_futures, rng=ref_rng,
                      scheduler=ref_scheduler, endpoint=ref_endpoint,
                      fm=ref_fm, sim=ref_sim, failure=ref_failure)
PORT = SimpleNamespace(error=port_error, futures=port_futures, rng=port_rng,
                       scheduler=port_scheduler, endpoint=port_endpoint,
                       fm=port_fm, sim=port_sim, failure=port_failure)


class Req:
    """A request: its number, and the reply the network attaches."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.reply = None


@pytest.fixture(autouse=True)
def teardown():
    yield
    for m in (REF, PORT):
        m.sim.set_simulator(None)
        m.scheduler.set_event_loop(None)


def world(m, seed: int):
    loop = m.scheduler.EventLoop(sim=True)
    m.scheduler.set_event_loop(loop)
    m.rng.set_deterministic_random(m.rng.DeterministicRandom(seed))
    sim = m.sim.Simulator()
    m.sim.set_simulator(sim)
    return loop, sim


def outcome(f):
    if not f.is_ready():
        return "pending"
    if f.is_error():
        return ("error", f.error.name)
    return ("ok", f.get())


def script(m, seed: int, faults: str) -> tuple:
    """Three processes: `a` sends a request every millisecond to the
    echo and drop streams of `b` and `c` (drop answers nothing, so its
    reply breaks); the faults named in `faults` come at fixed times.
    Returns the (time, event) log, each send's outcome and time, every
    peer table and the network's message count."""
    loop, sim = world(m, seed)
    a = sim.new_process(name="a", machineid="m1", zoneid="z1")
    b = sim.new_process(name="b", machineid="m2", zoneid="z2")
    c = sim.new_process(name="c", machineid="m2", zoneid="z2")
    log = []
    streams = {}
    for p in (b, c):
        for kind in ("echo", "drop"):
            s = m.endpoint.RequestStream(f"{p.name}.{kind}")
            p.register(s)      # a token drawn from the seeded RNG
            streams[p.name, kind] = s

            async def serve(s=s, who=f"{p.name}.{kind}", kind=kind):
                async for req in s.queue:
                    log.append((loop.now(), "recv", who, req.n))
                    if kind == "echo":
                        req.reply.send(req.n * 10)
                    else:
                        req.reply = None       # dropped unanswered
            p.spawn(serve(), f"{p.name}.{kind}")
    sends = []

    async def client() -> None:
        for n in range(120):
            await m.scheduler.delay(0.001)
            target = ("b", "c")[n % 2], ("echo", "drop")[(n // 2) % 2]
            f = m.endpoint.RequestStream.at(
                streams[target].endpoint).get_reply(Req(n))
            t0 = loop.now()

            def done(f, n=n, t0=t0, target=target):
                sends.append((n, target, t0, loop.now(), outcome(f)))
            f.on_ready(done)
    a.spawn(client(), "client")
    # A harness sender (no process: the 0.0.0.0 sentinel).
    hf = []

    async def harness() -> None:
        for n in range(1000, 1030):
            await m.scheduler.delay(0.004)
            hf.append((n, loop.now(), m.endpoint.RequestStream.at(
                streams["b", "echo"].endpoint).get_reply(Req(n))))
    loop.spawn(harness())

    async def nemesis() -> None:
        steps = {
            "clog": [(0.010, lambda: sim.clog_pair(a, b, 0.020)),
                     (0.030, lambda: sim.clog_process(c, 0.015)),
                     (0.040, lambda: sim.unclog_process(c))],
            "gray": [(0.010, lambda: sim.gray_clog_pair(a, c, 0.004, 0.03)),
                     (0.025, lambda: sim.ungray_pair(a, c))],
            "partition": [(0.010, lambda: sim.partition(a, b)),
                          (0.050, lambda: sim.heal_pair(a, b)),
                          (0.060, lambda: sim.partition(a, c)),
                          (0.070, lambda: sim.heal())],
            "kill": [(0.020, lambda: sim.kill_process(c)),
                     (0.060, lambda: sim.reboot_process(b))],
        }
        t = 0.0
        for when, fn in [x for f in faults.split("+") for x in steps[f]]:
            await m.scheduler.delay(when - t)
            t = when
            log.append((loop.now(), "fault", when))
            fn()
    loop.spawn(nemesis())
    loop.run_for(0.5)
    tables = {ip: sim.network.peer_table(ip).to_doc()
              for ip in sorted(sim.network._peer_tables)}
    harness_out = [(n, t, outcome(f)) for n, t, f in hf]
    return (log, sorted(sends), harness_out, tables,
            sim.network.messages_sent,
            [(p.name, p.alive, p.epoch) for p in sim.processes.values()])


@pytest.mark.parametrize("faults", ["clog", "gray", "partition", "kill",
                                    "clog+gray+partition+kill"])
@pytest.mark.parametrize("seed", [1, 7])
def test_delivery_order_and_times_equal_the_reference(seed, faults):
    want = script(REF, seed, faults)
    got = script(PORT, seed, faults)
    log, sends, harness, tables, sent, procs = got
    assert log == want[0]
    assert sends == want[1]
    assert harness == want[2]
    assert tables == want[3]
    assert (sent, procs) == want[4:]
    # The script reaches every outcome it is there for.
    outcomes = {o for *_x, o in sends}
    assert ("error", "broken_promise") in outcomes
    assert any(o[0] == "ok" for o in outcomes)


def test_dead_process_and_dropped_reply_break():
    """A request to a killed process, one to a stream stopped on a live
    process, and requests buffered unserved when their process dies, each
    answer broken_promise at the reference's times, and so does a reply
    its server drops.  A request its server holds when its process is
    killed breaks too, but the reference breaks it only when the cyclic
    collector runs (its clog re-check closure names itself, a cycle that
    holds the message), and the port as soon as the holder is gone."""
    import gc
    broken = ("error", "broken_promise")
    equal, held_out = [], []
    for m in (REF, PORT):
        loop, sim = world(m, 3)
        a, b, c = (sim.new_process(name=n) for n in ("a", "b", "c"))
        echo, gone, idle = (m.endpoint.RequestStream(n)
                            for n in ("echo", "gone", "idle"))
        for s in (echo, gone, idle):
            b.register(s)
        fs, t = {}, {}

        def send(name, stream, n):
            f = m.endpoint.RequestStream.at(stream.endpoint).get_reply(
                Req(n))
            f.on_ready(lambda f: t.setdefault(name, loop.now()))
            fs[name] = f

        async def client():
            await m.scheduler.delay(0.01)
            sim.network.unregister_stream(gone)
            send("stopped", gone, 1)
            send("buffered", idle, 2)    # nobody serves idle
            await m.scheduler.delay(0.01)
            sim.kill_process(b)
            send("dead", echo, 3)
            await m.scheduler.delay(0.01)
        loop.run_until(a.spawn(client()))
        loop.run_for(0.1)
        equal.append({k: (outcome(f), t.get(k)) for k, f in fs.items()})

        # The held and the dropped replies, on c.
        held, dropper = (m.endpoint.RequestStream(n)
                         for n in ("held", "dropper"))
        c.register(held)
        c.register(dropper)

        async def hold():
            mine = []
            async for req in held.queue:
                mine.append(req)         # never answered

        async def drop():
            async for req in dropper.queue:
                req.reply = None         # dropped unanswered
        c.spawn(hold())
        c.spawn(drop())
        fs.clear()
        send("held", held, 4)
        send("dropped", dropper, 5)
        gc.disable()
        try:
            loop.run_for(0.01)
            sim.kill_process(c)
            loop.run_for(0.1)
            before_gc = {k: outcome(f) for k, f in fs.items()}
            gc.collect()
            loop.run_for(0.1)
        finally:
            gc.enable()
        held_out.append((before_gc, {k: outcome(f) for k, f in fs.items()}))
    assert equal[1] == equal[0]
    assert all(v[0] == broken for v in equal[1].values())
    both_broken = {"held": broken, "dropped": broken}
    assert held_out[0] == ({"held": "pending", "dropped": broken},
                           both_broken)
    assert held_out[1] == (both_broken, both_broken)


def test_peer_metrics_and_failure_monitor_equal_the_reference():
    """The peer tables after the same samples, and the failure monitor:
    a waitFailure watcher on a process that dies returns at the
    reference's time, a status set flips its AsyncVar once."""
    from foundationdb_tpu.rpc.peer_metrics import PeerMetricsTable as RT
    from foundationdb_tpu_torch.rpc.peer_metrics import PeerMetricsTable as PT
    docs = []
    for cls in (RT, PT):
        t = cls("10.0.0.1")
        for i in range(40):
            t.sample_request("p%d" % (i % 3), nbytes=i * 7)
            if i % 5 == 0:
                t.sample_timeout("p%d" % (i % 3))
            elif i % 7 == 0:
                t.sample_disconnect("p%d" % (i % 3))
            else:
                t.sample_rtt("p%d" % (i % 3), 0.0001 * (i + 1), at=i * 0.5,
                             nbytes=i)
            if i % 11 == 0:
                t.sample_reconnect("p%d" % (i % 3))
        windows = [t.peer("p%d" % k).take_window() for k in range(3)]
        docs.append((t.to_doc(), windows,
                     t.collection.counter("Requests").value,
                     t.collection.histogram("PeerLatency").snapshot().count))
    assert docs[1] == docs[0]

    # The monitor's state machine under the same calls.
    out = []
    for m in (REF, PORT):
        loop, sim = world(m, 11)
        fm = m.fm.FailureMonitor()
        ep = m.endpoint.Endpoint(m.endpoint.NetworkAddress("10.0.0.9", 1),
                                 "t")
        seen = []

        async def observe():
            for _ in range(3):
                await fm.on_state_change(ep)
                seen.append((loop.now(), fm.is_failed(ep)))
        loop.spawn(observe())
        for when, failed in ((0.1, True), (0.2, True), (0.3, False),
                             (0.4, True)):
            loop.run_for(when - loop.now())
            fm.set_status(ep, failed)
        loop.run_for(0.1)
        out.append((seen, fm.is_failed(ep)))
    assert out[1] == out[0] == ([(0.1, True), (0.3, False), (0.4, True)],
                                True)

    # A waitFailure watcher on a role whose process dies (the holder
    # breaks what it holds as it ends, server/failure.py).
    out = []
    for m in (REF, PORT):
        loop, sim = world(m, 11)
        a, b = sim.new_process(name="a"), sim.new_process(name="b")
        wf = m.endpoint.RequestStream("wf")
        b.register(wf)
        b.spawn(m.failure.hold_wait_failure(wf))
        fm = m.fm.FailureMonitor()
        marks = {}

        class Iface:
            wait_failure = wf

        async def watch():
            await m.failure.wait_failure_of(Iface)
            marks["of"] = loop.now()
            fm.set_status(wf.endpoint, True)
        a.spawn(watch())
        loop.run_for(0.2)
        assert not fm.is_failed(wf.endpoint) and not marks
        sim.kill_process(b)
        loop.run_for(1.0)
        out.append((marks, fm.is_failed(wf.endpoint)))
    assert out[1] == out[0]
    assert out[1][1] is True


def test_wait_failure_client_returns_when_the_role_dies():
    """rpc/failure_monitor.py's heartbeat client over its server: alive,
    it re-arms and never returns; once the process dies, it returns (the
    port at once, the reference when its held request's cycle is
    collected)."""
    import gc
    out = []
    for m in (REF, PORT):
        loop, sim = world(m, 13)
        a, b = sim.new_process(name="a"), sim.new_process(name="b")
        wf = m.endpoint.RequestStream("wf")
        b.register(wf)
        b.spawn(m.fm.wait_failure_server(wf))
        done = a.spawn(m.fm.wait_failure_client(wf.endpoint, timeout=0.05))
        loop.run_for(0.5)
        alive = done.is_ready()
        sim.kill_process(b)
        gc.collect()
        loop.run_for(1.0)
        out.append((alive, outcome(done)))
    assert out[1] == out[0] == (False, ("ok", None))


def test_simulator_kill_reboot_clog_semantics():
    """new_process addresses, reboot (epoch, stale endpoints, the
    on_reboot hook), a process's own die(), kill_machine, kill_zone,
    reuse of a dead address, and clog_machine / unclog_machine, each
    observed as the reference observes it."""
    out = []
    for m in (REF, PORT):
        loop, sim = world(m, 5)
        procs = [sim.new_process(name=f"p{i}", machineid=f"m{i // 2}",
                                 zoneid=f"z{i // 3}") for i in range(6)]
        rebooted = []
        sim.on_reboot = lambda p: rebooted.append((loop.now(), p.name))
        s = m.endpoint.RequestStream("s")
        procs[1].register(s)
        ep_old = s.endpoint
        sim.reboot_process(procs[1])
        s2 = m.endpoint.RequestStream("s2")
        procs[1].register(s2)

        async def serve():
            async for req in s2.queue:
                req.reply.send("after")
        procs[1].spawn(serve())
        fa = m.endpoint.RequestStream.at(ep_old).get_reply(Req(1))
        fb = m.endpoint.RequestStream.at(s2.endpoint).get_reply(Req(2))
        loop.run_for(0.05)

        async def suicide():
            procs[2].die("io_error")
        procs[2].spawn(suicide())
        loop.run_for(0.05)
        sim.kill_machine("m2")
        sim.kill_zone("z0")
        reused = sim.new_process(name="again", address=procs[0].address)
        with pytest.raises(RuntimeError):
            sim.new_process(name="clash", address=reused.address)
        sim.clog_machine("m1", 0.5)
        clogged = dict(sim.network._clog_ip_until)
        sim.unclog_machine("m1")
        out.append((
            [(p.name, str(p.address), p.alive, p.epoch,
              p.locality.machineid, p.locality.zoneid)
             for p in sim.processes.values()],
            [p.name for p in sim.alive_processes()], rebooted,
            outcome(fa), outcome(fb), sorted(clogged.items()),
            dict(sim.network._clog_ip_until)))
    assert out[1] == out[0]
