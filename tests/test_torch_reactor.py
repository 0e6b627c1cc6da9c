"""The port's real-IO half (foundationdb_tpu_torch/core/scheduler.py
EventLoop(sim=False), core/threadpool.py, rpc/real_network.py,
rpc/transport.py) against the JAX package's, on real sockets.

This file opens loopback sockets (127.0.0.1, ports the kernel picks) and
starts child interpreters: the Resolver case runs chip_smoke.py's phase
26 at a small size on the CPU, a port Resolver role (device="cpu") in
another OS process on a RealNetwork, the parent's seeded stream sent
through its own, every reply held to an in-process port role's (which
tests/test_torch_resolver.py holds to the reference's role), then the
child killed and the next request failing with a transport error."""

import os
import socket
import struct
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from foundationdb_tpu.core import futures as ref_futures
from foundationdb_tpu.core import scheduler as ref_scheduler
from foundationdb_tpu.core import threadpool as ref_threadpool
from foundationdb_tpu_torch.core import futures as port_futures
from foundationdb_tpu_torch.core import scheduler as port_scheduler
from foundationdb_tpu_torch.core import threadpool as port_threadpool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(scheduler=ref_scheduler, futures=ref_futures,
                      threadpool=ref_threadpool)
PORT = SimpleNamespace(scheduler=port_scheduler, futures=port_futures,
                       threadpool=port_threadpool)


@pytest.fixture(autouse=True)
def no_loop():
    yield
    ref_scheduler.set_event_loop(None)
    port_scheduler.set_event_loop(None)


def socket_pair_case(m) -> list:
    """A writer callback pushes 64 chunks into one end of a socketpair
    (removing itself when done), a reader callback drains the other end;
    a timer fires in between.  The sequence of callback events."""
    loop = m.scheduler.EventLoop(sim=False)
    m.scheduler.set_event_loop(loop)
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    events, got = [], bytearray()
    chunks = [bytes([i]) * 1000 for i in range(64)]
    done = m.futures.Promise()

    def write():
        if chunks:
            a.send(chunks.pop(0))
            events.append("w")
        else:
            loop.remove_writer(a)
            events.append("w-off")

    def read():
        data = b.recv(1 << 16)
        got.extend(data)
        events.append("r")
        if len(got) == 64_000:
            loop.remove_reader(b)
            done.send(bytes(got))
    loop.add_writer(a, write)
    loop.add_reader(b, read)
    loop.call_at(loop.now() + 0.01, lambda: events.append("timer"))
    out = loop.run_until(done.get_future(), timeout=10.0)
    loop.run_until(loop.delay(0.02), timeout=10.0)
    a.close()
    b.close()
    assert out == b"".join(bytes([i]) * 1000 for i in range(64))
    return [e for e in events if e != "r"], events.count("r") > 0


def test_readers_and_writers_on_a_socketpair():
    want = socket_pair_case(REF)
    got = socket_pair_case(PORT)
    assert got == want
    assert got[0].count("w") == 64 and "timer" in got[0]


def timers_case(m) -> tuple:
    loop = m.scheduler.EventLoop(sim=False)
    m.scheduler.set_event_loop(loop)
    order = []

    async def sleeper(name, s):
        await m.scheduler.delay(s)
        order.append(name)
    t0 = time.monotonic()
    fs = [loop.spawn(sleeper(n, s)) for n, s in
          (("c", 0.06), ("a", 0.02), ("b", 0.04))]
    loop.run_until(m.futures.wait_all(fs), timeout=5.0)
    took = time.monotonic() - t0
    # run_forever: until stop(); then with nothing left it returns at once.
    loop.call_at(loop.now() + 0.03, loop.stop)
    t1 = time.monotonic()
    loop.run_forever()
    stopped_after = time.monotonic() - t1
    t2 = time.monotonic()
    loop.run_forever()
    idle = time.monotonic() - t2
    # A deadline with nothing left to run: timed_out.
    p = m.futures.Promise()
    try:
        loop.run_until(p.get_future(), timeout=0.03)
        timed_out = False
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        timed_out = getattr(e, "name", "") == "timed_out"
    return (order, took >= 0.06, stopped_after >= 0.03, idle < 0.02,
            timed_out, loop.now() >= 0.09)


def test_wall_clock_timers_run_forever_and_stop():
    want = timers_case(REF)
    got = timers_case(PORT)
    assert got == want == (["a", "b", "c"], True, True, True, True, True)


def blocking_case(m, sim: bool) -> tuple:
    loop = m.scheduler.EventLoop(sim=sim)
    m.scheduler.set_event_loop(loop)
    main = threading.current_thread()
    ran_on = []

    def work(x):
        ran_on.append(threading.current_thread() is main)
        if x < 0:
            raise ValueError("negative")
        return x * 2

    async def go():
        a = await m.threadpool.run_blocking(work, 21, sim_cost=0.5)
        t = loop.now()
        try:
            await m.threadpool.run_blocking(work, -1)
            b = None
        except ValueError as e:
            b = str(e)
        return a, b, t
    a, b, t = loop.run_until(loop.spawn(go()), timeout=10.0)
    m.threadpool.pool_for(loop).close()
    return a, b, (t == 0.5) if sim else True, ran_on


@pytest.mark.parametrize("sim", [True, False], ids=["sim", "real"])
def test_run_blocking(sim):
    want = blocking_case(REF, sim)
    got = blocking_case(PORT, sim)
    assert got == want
    # Inline on the reactor in simulation, on a worker thread for real.
    assert got[3] == [sim, sim]


def small_role_run(n_batches: int = 8, seed: int = 3):
    """phase 19's requests at a small size on the CPU (role_requests over
    a seeded contended stream) and an in-process port role's replies."""
    import chip_smoke as cs
    from foundationdb_tpu_torch.server import (
        Resolver, ResolveTransactionBatchRequest, ask)
    from foundationdb_tpu_torch.txn.types import (CommitTransactionRef,
                                                  KeyRange)
    rng = np.random.default_rng(seed)

    def k(i):
        return b"%015d" % i
    versions = [1000 * (i + 1) for i in range(n_batches)]
    txns = []
    for v in versions:
        ids = rng.integers(0, 500, size=(300, 3)).tolist()
        txns.append([CommitTransactionRef(
            read_conflict_ranges=[KeyRange(k(a), k(a) + b"\0")],
            write_conflict_ranges=[KeyRange(k(c), k(c) + b"\0")],
            read_snapshot=max(0, v - 1000 - b % 1500)) for a, b, c in ids])
    reqs = cs.role_requests(versions, txns)
    with cs.port_knobs(MAX_WRITE_TRANSACTION_LIFE_VERSIONS=cs.WINDOW):
        role = Resolver("r0", 0, backend="torch",
                        proxy_ids=list(cs.PROXIES), capacity=1 << 12,
                        delta_capacity=1 << 10, device="cpu")
        replies = [cs.reply_of_role(ask(
            role.resolve_batch, ResolveTransactionBatchRequest(
                r["prev"], r["version"], r["lrv"], r["txns"],
                txn_state_transactions=r["state"], proxy_id=r["proxy"])))
            for r in reqs]
    return reqs, replies


def test_resolver_in_another_process_over_tcp():
    """chip_smoke.wire_path on the CPU: the child's replies equal the
    in-process role's bit for bit (it raises otherwise), its launches come
    back over the network (none on the CPU), the killed child's next
    request fails with a transport error and the failure monitor marks
    it, both well inside this test's limit."""
    import chip_smoke as cs
    reqs, replies = small_role_run()
    assert sum(len(r[1]) for r in replies) > 0   # state txns broadcast
    t0 = time.monotonic()
    launches, fig = cs.wire_path("", reqs, replies, device="cpu",
                                 capacity=1 << 12, delta_capacity=1 << 10)
    assert time.monotonic() - t0 < 120.0
    assert set(launches) and not any(launches.values())
    assert fig["requests"] == len(reqs)
    assert fig["killed_request_error"] == "broken_promise"
    assert fig["killed_request_fail_s"] < 5.0
    assert fig["failure_monitor_marked_s"] < 5.0
    assert fig["request_frame_mb"] > 0 and fig["reply_frame_mb"] > 0


def test_resolver_child_failure_fails_the_run(tmp_path, monkeypatch):
    """A child that dies before it serves fails phase 26, and leaves no
    process behind."""
    import chip_smoke as cs
    monkeypatch.setattr(cs, "RESOLVER_CHILD_ARG", "--no-such-argument")
    reqs, replies = small_role_run(n_batches=2)
    with pytest.raises(AssertionError, match="exited"):
        cs.wire_path("", reqs, replies, device="cpu", capacity=1 << 12,
                     delta_capacity=1 << 10)


def test_real_network_round_trip_local_delivery_and_broken_promise():
    """Two RealNetworks in one process on one real-mode loop: a request
    crosses the socket (serde frames), a local one is delivered without
    serialization, an unknown token answers broken_promise, and a closed
    peer's pending reply breaks."""
    from foundationdb_tpu_torch.rpc.endpoint import Endpoint, RequestStream
    from foundationdb_tpu_torch.rpc.network import set_network
    from foundationdb_tpu_torch.rpc.real_network import (RealNetwork,
                                                         RealProcess)
    from foundationdb_tpu_torch.server.interfaces import (
        GetValueReply, GetValueRequest)
    loop = port_scheduler.EventLoop(sim=False)
    port_scheduler.set_event_loop(loop)
    server, client = RealNetwork(loop), RealNetwork(loop)
    set_network(client)
    try:
        proc = RealProcess(loop, server, name="srv")
        s, hold = RequestStream("get"), RequestStream("hold")
        proc.register(s)
        proc.register(hold)
        seen = []

        async def serve():
            async for req in s.queue:
                seen.append(type(req).__name__)
                req.reply.send(GetValueReply(value=req.key * 2,
                                             version=req.version))

        async def keep():
            held = []
            async for req in hold.queue:
                held.append(req)
        proc.spawn(serve())
        proc.spawn(keep())
        rep = loop.run_until(RequestStream.at(s.endpoint).get_reply(
            GetValueRequest(b"ab", 7)), timeout=10.0)
        assert (rep.value, rep.version, seen) == (b"abab", 7,
                                                  ["GetValueRequest"])
        bad = Endpoint(s.endpoint.address, "nothing:here")
        with pytest.raises(Exception) as e:
            loop.run_until(RequestStream.at(bad).get_reply(
                GetValueRequest(b"x", 1)), timeout=10.0)
        assert e.value.name == "broken_promise"
        # Local delivery (the server's own network) skips serde: the
        # request object itself arrives.
        set_network(server)
        req = GetValueRequest(b"zz", 3)
        rep = loop.run_until(RequestStream.at(s.endpoint).get_reply(req),
                             timeout=10.0)
        assert rep.value == b"zzzz"
        set_network(client)
        f = RequestStream.at(hold.endpoint).get_reply(GetValueRequest(b"h",
                                                                      1))
        loop.run_until(loop.delay(0.05), timeout=10.0)
        server.close()
        with pytest.raises(Exception) as e:
            loop.run_until(f, timeout=10.0)
        assert e.value.name == "broken_promise"
    finally:
        client.close()
        set_network(None)


SERVER = r"""
import sys
sys.path.insert(0, %(repo)r)
from foundationdb_tpu_torch.rpc.transport import (TcpTransport, TOKEN_KV_GET,
                                                  TOKEN_KV_SET,
                                                  pack_value_reply,
                                                  unpack_kv_set)
from foundationdb_tpu_torch.core.wire import Reader

store = {}
t = TcpTransport("127.0.0.1", 0)

def do_set(payload):
    k, v = unpack_kv_set(payload)
    store[k] = v
    return pack_value_reply(b"ok")

def do_get(payload):
    k = Reader(payload).bytes_()
    return pack_value_reply(store.get(k))

t.register(TOKEN_KV_SET, do_set)
t.register(TOKEN_KV_GET, do_get)
print("PORT %%d" %% t.address[1], flush=True)
import time
while True:
    time.sleep(1)
"""


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_tcp_transport_kv_round_trip_across_os_processes(server_pkg):
    """tests/test_tcp_transport.py's round trip with the port's
    TcpTransport as the client, against a port server and against the
    reference's (the frames are the same)."""
    code = SERVER % {"repo": REPO}
    if server_pkg == "reference":
        code = code.replace("foundationdb_tpu_torch", "foundationdb_tpu")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("PORT "), line
        port = int(line.split()[1])
        from foundationdb_tpu_torch.rpc.transport import (
            TOKEN_KV_GET, TOKEN_KV_SET, TcpTransport, pack_kv_get,
            pack_kv_set, unpack_value_reply)
        client = TcpTransport("127.0.0.1", 0)
        addr = ("127.0.0.1", port)
        try:
            for i in range(50):
                r = client.request(addr, TOKEN_KV_SET,
                                   pack_kv_set(b"k%03d" % i, b"v%03d" % i),
                                   span="s%d" % i)
                assert unpack_value_reply(r) == b"ok"
            for i in range(50):
                r = client.request(addr, TOKEN_KV_GET,
                                   pack_kv_get(b"k%03d" % i))
                assert unpack_value_reply(r) == b"v%03d" % i
            r = client.request(addr, TOKEN_KV_GET, pack_kv_get(b"missing"))
            assert unpack_value_reply(r) is None
            with pytest.raises(TimeoutError):
                client.request(addr, 0x999, b"", timeout=0.2)
            assert client.peer_metrics.peer(
                f"127.0.0.1:{port}").replies == 101
        finally:
            client.close()
    finally:
        proc.kill()
        proc.wait()


def test_tcp_transport_handshake_rejects_version_mismatch():
    from foundationdb_tpu_torch.rpc.transport import MAGIC, TcpTransport
    server = TcpTransport("127.0.0.1", 0)
    try:
        s = socket.create_connection(server.address)
        s.sendall(struct.pack("<IH", MAGIC, 999))   # wrong version
        s.settimeout(5.0)
        assert s.recv(16) == b""                    # closed on us
        s.close()
    finally:
        server.close()
