"""The port's storage server under data distribution, held against the
JAX package's (foundationdb_tpu/server/storage.py against
foundationdb_tpu_torch/server/storage.py) on the CPU.  Tolerance 0: all
of it is bytes and integers.

The same seeded mutation stream drives a replica of each package:
  * _apply with sets, clears, atomics and disownment fences
    (system_data.DISOWN_SHARD_PREFIX): equal rows at every version and
    equal shard states;
  * _shard_metrics over random spans and split thresholds, polled again
    after more writes (the incremental cache against a scan): equal
    totals and split keys;
  * _fetch_keys of a span from a source on a simulated process, with
    mutations and a fence pulled while the snapshot is in flight: equal
    rows, shard states and least read versions; and _remove_shard;
  * _fetch_shard's floor (a source behind min_version serves nothing
    until it reaches it, then a snapshot with the rows in between) and
    the stalled source (future_version after its bounded wait), as
    tests/test_data_distribution.py:164 and :199 hold the reference's.
"""

import random

import pytest

from foundationdb_tpu.core import scheduler as ref_sched
from foundationdb_tpu.core.futures import Promise as RefPromise
from foundationdb_tpu.rpc import sim as ref_sim
from foundationdb_tpu.server import interfaces as ref_if
from foundationdb_tpu.server import storage as ref_storage
from foundationdb_tpu.server import system_data as ref_sd
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core import scheduler as port_sched
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.futures import Promise as PortPromise
from foundationdb_tpu_torch.rpc import sim as port_sim
from foundationdb_tpu_torch.server import interfaces as port_if
from foundationdb_tpu_torch.server import storage as port_storage
from foundationdb_tpu_torch.server import system_data as port_sd
from foundationdb_tpu_torch.txn import types as pt

REF = {"sched": ref_sched, "sim": ref_sim, "if": ref_if, "t": rt,
       "storage": ref_storage, "sd": ref_sd, "promise": RefPromise}
PORT = {"sched": port_sched, "sim": port_sim, "if": port_if, "t": pt,
        "storage": port_storage, "sd": port_sd, "promise": PortPromise}
KEYS = [b"k%03d" % i for i in range(120)]


@pytest.fixture(autouse=True)
def clean_globals():
    yield
    for m in (REF, PORT):
        m["sim"].set_simulator(None)
        m["sched"].set_event_loop(None)


def loop_of(m):
    loop = m["sched"].EventLoop()
    m["sched"].set_event_loop(loop)
    return loop


def set_version(ss, v: int) -> None:
    if isinstance(ss.version, int):
        ss.version = v
    else:
        ss.version.set(v)


def version_of(ss) -> int:
    return ss.version if isinstance(ss.version, int) else ss.version.get()


def mutation_stream(seed: int, versions: range, fences: bool = True):
    """[(version, [(type, p1, p2)])]: sets, clears, atomic adds and, now
    and then, a disownment fence over a random span."""
    rng = random.Random(seed)
    out = []
    for v in versions:
        muts = []
        for _ in range(rng.randrange(1, 6)):
            r = rng.random()
            k = rng.choice(KEYS)
            if r < 0.55:
                muts.append((0, k, b"v%d-" % v + b"x" * rng.randrange(30)))
            elif r < 0.7:
                i = rng.randrange(len(KEYS) - 8)
                muts.append((1, KEYS[i], KEYS[i + rng.randrange(1, 8)]))
            elif r < 0.85:
                muts.append((2, k, bytes([rng.randrange(256)]) * 4))
            elif fences and r < 0.9:
                a, b = sorted(rng.sample(KEYS, 2))
                muts.append((0, port_sd.DISOWN_SHARD_PREFIX + a, b))
        out.append((v, muts))
    return out


def apply_stream(m, ss, stream) -> None:
    t = m["t"]
    for v, muts in stream:
        for typ, a, b in muts:
            ss._apply(t.Mutation(t.MutationType(typ), a, b), v)
        set_version(ss, v)


def states(ss) -> list:
    """The shard map, a fetch as ("fetching",)."""
    return [(b, e, st if st[0] != "fetching" else ("fetching",))
            for b, e, st in ss.shards.ranges()]


def rows(ss, version) -> list:
    return ss.data.range_read(b"", b"\xff", version, 1 << 30, 1 << 40)[0]


def server(m, name="ss", tag=0):
    return m["storage"].StorageServer(name, tag=tag, log_system=None)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_apply_and_disown_match_reference(seed):
    stream = mutation_stream(seed, range(10, 60))
    out = {}
    for name, m in (("ref", REF), ("port", PORT)):
        loop_of(m)
        ss = server(m)
        apply_stream(m, ss, stream)
        out[name] = ([rows(ss, v) for v in range(10, 60, 7)], states(ss),
                     ss.stats["mutations"])
    assert out["port"] == out["ref"]
    assert any(st[0] == "absent" for _b, _e, st in out["port"][1])


def metrics_of(m, ss, loop, begin, end, threshold):
    p = m["promise"]()
    req = m["if"].GetShardMetricsRequest(begin=begin, end=end,
                                         split_threshold=threshold, reply=p)
    r = ss._shard_metrics(req)
    if r is not None:                  # the reference's is a coroutine
        loop.run_until(loop.spawn(r))
    return p.get_future().get()


@pytest.mark.parametrize("seed", [4, 5])
def test_shard_metrics_match_reference(seed):
    rng = random.Random(seed)
    stream = mutation_stream(seed, range(10, 40), fences=False)
    more = mutation_stream(seed + 100, range(40, 55), fences=False)
    spans = [tuple(sorted(rng.sample(KEYS + [b"", b"\xff"], 2)))
             for _ in range(12)]
    thresholds = [rng.choice([50, 400, 2000, 1 << 30]) for _ in spans]
    out = {}
    for name, m in (("ref", REF), ("port", PORT)):
        loop = loop_of(m)
        ss = server(m)
        apply_stream(m, ss, stream)
        got = [metrics_of(m, ss, loop, b, e, t)
               for (b, e), t in zip(spans, thresholds)]
        apply_stream(m, ss, more)       # deltas into the cached spans
        got += [metrics_of(m, ss, loop, b, e, t)
                for (b, e), t in zip(spans, thresholds)]
        out[name] = got
    assert out["port"] == out["ref"]
    assert any(sk is not None for _t, sk in out["port"])


def serve_source(m, src):
    """`src` on a simulated process of its own, its streams served."""
    sim = m["sim"].Simulator()
    m["sim"].set_simulator(sim)
    proc = sim.new_process(name="src")
    src.run(proc)
    return proc


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_fetch_keys_and_remove_match_reference(seed):
    rng = random.Random(seed)
    base = mutation_stream(seed, range(10, 40), fences=False)
    during = mutation_stream(seed + 50, range(41, 50), fences=False)
    i = rng.randrange(80)
    begin, end = KEYS[i], KEYS[i + 30]
    fence_at = (begin, KEYS[i + 5])
    out = {}
    for name, m in (("ref", REF), ("port", PORT)):
        loop = loop_of(m)
        t = m["t"]
        src, dest = server(m, "src", 0), server(m, "dest", 1)
        apply_stream(m, src, base)
        # The destination holds an older tenure of the span (cleared under
        # the snapshot) and is at the move's version, behind the source.
        apply_stream(m, dest, base[:10])
        set_version(dest, 35)
        serve_source(m, src)
        p = m["promise"]()
        f = loop.spawn(dest._fetch_keys(m["if"].FetchKeysRequest(
            begin=begin, end=end, sources=[src.interface], min_version=35,
            reply=p)))
        # The fetch starts and its request to the source is in flight.
        loop.run_until(m["sched"].delay(1e-6))
        assert not p.get_future().is_ready()
        # Pulled while the snapshot is in flight: buffered above it, and a
        # fence newer than the move closes its span at completion.
        apply_stream(m, dest, during)
        dest._apply(t.Mutation(t.MutationType.SetValue,
                               m["sd"].DISOWN_SHARD_PREFIX + fence_at[0],
                               fence_at[1]), 50)
        set_version(dest, 50)
        loop.run_until(p.get_future(), timeout=30)
        loop.run_until(f, timeout=30)
        fetched = (rows(dest, 50), states(dest))
        rp = m["promise"]()
        r = dest._remove_shard(m["if"].RemoveShardRequest(
            begin=fence_at[1], end=end, reply=rp))
        if r is not None:
            loop.run_until(loop.spawn(r))
        out[name] = (fetched, rows(dest, 50), states(dest))
    assert out["port"] == out["ref"]
    (fetched_rows, fetched_states), _r, _s = out["port"]
    assert any(begin <= k < end for k, _v in fetched_rows)
    assert ("owned", 50) in [st for _b, _e, st in fetched_states]


def test_fetch_shard_floors_snapshot_at_min_version():
    """A source behind the MoveKeys phase-1 commit serves nothing until it
    reaches it, then a snapshot with the write in between (the
    reference's test_data_distribution.py:164, on the port)."""
    loop = loop_of(PORT)
    ss = server(PORT, "ss-test")
    ss.data.set(b"a", b"old", 5)
    set_version(ss, 5)
    p = PortPromise()
    f = loop.spawn(ss._fetch_shard(port_if.FetchShardRequest(
        begin=b"", end=b"\xff", min_version=10, reply=p)))
    loop.run_until(port_sched.delay(0.1))
    assert not p.get_future().is_ready(), \
        "snapshot served below the phase-1 floor"
    ss.data.set(b"b", b"in-between", 8)
    set_version(ss, 10)
    reply = loop.run_until(p.get_future(), timeout=5)
    loop.run_until(f, timeout=5)
    assert reply.version >= 10
    assert (b"b", b"in-between") in reply.data


def test_fetch_shard_stalled_source_raises_future_version():
    """A live source that cannot reach min_version answers future_version
    after its bounded wait, in both packages (the reference's
    test_data_distribution.py:199)."""
    out = {}
    for name, m in (("ref", REF), ("port", PORT)):
        loop = loop_of(m)
        ss = server(m, "ss-test")
        set_version(ss, 5)
        p = m["promise"]()
        f = loop.spawn(ss._fetch_shard(m["if"].FetchShardRequest(
            begin=b"", end=b"\xff", min_version=10, reply=p)))
        loop.run_until(f, timeout=30)
        fut = p.get_future()
        assert fut.is_error()
        out[name] = (fut.error.name, loop.now())
    assert out["port"] == out["ref"] == ("future_version", 1.0)


def test_fetch_failure_leaves_the_span_absent():
    """A fetch whose every source fails answers the error and leaves the
    span absent (data distribution rolls the move back); reads there
    answer wrong_shard_server."""
    loop = loop_of(PORT)
    src, dest = server(PORT, "src", 0), server(PORT, "dest", 1)
    set_version(src, 5)
    serve_source(PORT, src)
    p = PortPromise()
    f = loop.spawn(dest._fetch_keys(port_if.FetchKeysRequest(
        begin=b"k010", end=b"k020", sources=[src.interface],
        min_version=10, reply=p)))
    loop.run_until(f, timeout=30)
    assert p.get_future().is_error()
    assert dest.shards.lookup(b"k015") == ("absent", 0)
    r = port_if.Reply()
    dest.get_value(port_if.GetValueRequest(b"k015", 0, reply=r))
    assert isinstance(r.error, FdbError) and \
        r.error.name == "wrong_shard_server"
