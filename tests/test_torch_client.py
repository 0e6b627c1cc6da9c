"""The client on the port (foundationdb_tpu_torch/client/database.py,
the roles' actors and StaticCluster on the port's event loop) against the
JAX package's client on its SimCluster: the same seeded transactions
through each side's `database()`, with tolerance 0 on every read, error,
CommitTransactionRef that reaches a proxy, versionstamp and replica row.

Both sides have 2 resolvers (the reference's over its oracle, the port's
supervised sets on the CPU at capacity 2^10, delta 2^8), 2 commit
proxies, 1 GRV proxy, 2 TLogs and 4 storage servers in teams of 2, the
same shard and resolver boundaries and the same loaded keys.  Versions
differ (the reference's master reads its simulator's clock, whose network
adds latency the port's local delivery has none of), so a
read_snapshot is held to each side's own read version and a versionstamp
is read as the transaction it stamps."""

import random
from types import SimpleNamespace

import pytest
import torch

from foundationdb_tpu.core import error as ref_error
from foundationdb_tpu.core import futures as ref_futures
from foundationdb_tpu.core import scheduler as ref_scheduler
from foundationdb_tpu.core.knobs import client_knobs as ref_client_knobs
from foundationdb_tpu.server.cluster import SimCluster
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core import error as port_error
from foundationdb_tpu_torch.core import futures as port_futures
from foundationdb_tpu_torch.core import scheduler as port_scheduler
from foundationdb_tpu_torch.core.knobs import \
    client_knobs as port_client_knobs
from foundationdb_tpu_torch.server import StaticCluster
from foundationdb_tpu_torch.txn import types as pt

KEYS = sorted(bytes([i * 2]) + b"/%03d" % i for i in range(120))
FRESH = [b"n/%02d" % i for i in range(8)] + [b"\xc8/new%d" % i
                                             for i in range(4)]
BOUNDS = [b"", b"\x30", b"\x40", b"\x7f", b"\x80", b"\xa0", b"\xc0",
          b"\xf0", b"\xff"]
PROXIES = ["proxy0", "proxy1"]
CK = b"\xff\xff/transaction/conflicting_keys/"
ATOMICS = ["AddValue", "And", "Or", "Xor", "AppendIfFits", "Max", "Min",
           "ByteMin", "ByteMax", "MinV2", "AndV2", "CompareAndClear"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def sides(tmp_path):
    """(reference, port): each side's cluster, database and loop, with
    the commit requests each proxy received captured as they arrive."""
    from foundationdb_tpu.core.rng import (DeterministicRandom,
                                           set_deterministic_random)
    from foundationdb_tpu.rpc.sim import set_simulator
    set_deterministic_random(DeterministicRandom(7))
    made = []

    def make():
        ref, port = ref_side(), port_side(tmp_path / f"d{len(made)}")
        made.append(port)
        return ref, port
    yield make
    for p in made:
        p.c.close()
    set_simulator(None)
    ref_scheduler.set_event_loop(None)
    port_scheduler.set_event_loop(None)


def capture(streams) -> dict:
    got = {pid: [] for pid in streams}
    for pid, stream in streams.items():
        orig = stream.deliver

        def deliver(req, orig=orig, log=got[pid]):
            log.append(req.transaction)
            orig(req)
        stream.deliver = deliver
    return got


def ref_side():
    c = SimCluster(n_resolvers=2, n_storage=4, n_tlogs=2,
                   n_commit_proxies=2, replication=2,
                   conflict_backend="cpu")
    for ss in c.storage:
        for b, e, team in c.key_servers.ranges():
            if ss.tag in team:
                for k in KEYS:
                    if b <= k < e:
                        ss.data.set(k, b"base" + k, 0)
    s = common(ref_futures, ref_scheduler, ref_error, rt, c.loop)
    s.c, s.db, s.knobs = c, c.database(), ref_client_knobs()
    s.captured = capture({p.id: p.interface.commit
                          for p in c.commit_proxies})
    s.grv_metrics = c.grv_proxies[0].metrics

    async def settle():
        top = c.master.live_committed_version
        for ss in c.storage:
            await ss.version.when_at_least(top)
    s.settle = settle
    s.replicas = c.storage
    s.stop = lambda name: c.sim.kill_process(c.processes[name])
    return s


def port_side(datadir):
    loop = port_scheduler.EventLoop()
    c = StaticCluster(2, PROXIES, n_storage=4, n_tlogs=2, replication=2,
                      datadir=str(datadir), device="cpu", clock=loop.now,
                      capacity=1 << 10, delta_capacity=1 << 8)
    c.load(KEYS, [b"base" + k for k in KEYS])
    c.start(loop)
    s = common(port_futures, port_scheduler, port_error, pt, loop)
    s.c, s.db, s.knobs = c, c.database(), port_client_knobs()
    s.captured = capture({pid: p.interface.commit
                          for pid, p in c.plane.proxies.items()})
    s.grv_metrics = next(iter(c.plane.grv_proxies.values())).metrics

    async def settle():
        c.pull()
    s.settle = settle
    s.replicas = c.storage
    s.stop = c.stop_role
    return s


def common(futures, scheduler, error, types, loop):
    s = SimpleNamespace(
        loop=loop, types=types, FdbError=error.FdbError, err=error.err,
        wait_all=futures.wait_all, Promise=futures.Promise,
        delay=lambda t: scheduler.delay(t), now=loop.now,
        spawn=lambda coro: loop.spawn(coro))
    s.run = lambda coro, timeout=600.0: s.c.run_until(loop.spawn(coro),
                                                      timeout)
    return s


@pytest.fixture()
def knobs():
    saved = [(k, dict(vars(k))) for k in (ref_client_knobs(),
                                          port_client_knobs())]
    yield
    for k, v in saved:
        vars(k).update(v)


def both(make, scenario, *args):
    """Run `scenario(side, *args)` on each side; both results."""
    ref, port = make()
    return (ref.run(scenario(ref, *args)), port.run(scenario(port, *args)),
            ref, port)


async def rows_of(s) -> list:
    await s.settle()
    return [s.replicas[t].data.range_read(b"", b"\xff\xff", 1 << 62,
                                          1 << 30, 1 << 40)[0]
            for t in range(4)]


class Stamps:
    """Reads a side's versionstamps as (transaction, batch index): the
    versions a side's transactions committed at, in their order."""

    def __init__(self):
        self.of = {}

    def note(self, version, label):
        self.of[version] = label

    def stamp(self, st: bytes):
        return (self.of.get(int.from_bytes(st[:8], "big"), "?"),
                int.from_bytes(st[8:10], "big"))

    def norm(self, x):
        if isinstance(x, bytes):
            if x.startswith(b"vs/") and len(x) >= 13:
                return ("vs", self.stamp(x[3:13]), x[13:])
            if x.startswith(b"VS") and len(x) >= 12:
                return ("VS", self.stamp(x[2:12]), x[12:])
            return x
        if isinstance(x, (list, tuple)):
            return type(x)(self.norm(y) for y in x)
        return x


# ------------------------------------------------------ serial transactions
def txn_script(r, i) -> tuple:
    keys = KEYS + FRESH

    def rng():
        a, b = sorted(r.sample(BOUNDS + [r.choice(KEYS)], 2))
        return a, b
    ops = []
    for j in range(r.randrange(1, 11)):
        kind = r.choice(["get", "get", "snap", "range", "range", "set",
                         "set", "clear", "clear_range", "atomic", "atomic",
                         "vs_key", "vs_value", "rcr", "wcr", "get_vs",
                         "read_own"])
        k = r.choice(keys)
        if kind in ("get", "snap"):
            ops.append((kind, k))
        elif kind == "range":
            a, b = rng()
            ops.append((kind, a, b, r.choice([1, 3, 10, 1000]),
                        r.random() < 0.4, r.choice([0, 0, 40, 200]),
                        r.random() < 0.2))
        elif kind == "set":
            ops.append((kind, k, b"t%02d.%d" % (i, j)))
        elif kind == "clear":
            ops.append((kind, k))
        elif kind == "clear_range":
            a, b = sorted(r.sample(keys, 2))
            ops.append((kind, a, b))
        elif kind == "atomic":
            ops.append((kind, r.choice(ATOMICS), k,
                        bytes(r.randrange(256)
                              for _ in range(r.choice([1, 4, 8])))))
        elif kind == "vs_key":
            ops.append((kind, b"vs/" + bytes(10) + b"/%d.%d" % (i, j)))
        elif kind == "vs_value":
            ops.append((kind, k, b"VS" + bytes(10) + b"@%d" % i))
        elif kind in ("rcr", "wcr"):
            ops.append((kind,) + rng())
        elif kind == "read_own":
            ops.append((kind, r.choice(FRESH)))
        else:
            ops.append((kind,))
    return ops, ("commit" if r.random() < 0.75 else "reset")


async def run_serial(s, scripts) -> dict:
    """Every scripted transaction in turn: each op's result or error
    name, the commit's outcome, the versionstamp futures' outcomes, the
    read after a reset; then every replica's rows."""
    stamps = Stamps()
    out, expect_rs = [], []
    ty = s.types
    for i, (ops, end) in enumerate(scripts):
        t = s.db.create_transaction()
        res, vs_futs = [], []
        for op in ops:
            kind = op[0]
            try:
                if kind in ("get", "snap", "read_own"):
                    if kind == "read_own":
                        t.set(op[1], b"own%d" % i)
                    res.append(await t.get(op[1], snapshot=kind == "snap"))
                elif kind == "range":
                    _, a, b, limit, rev, lb, snap = op
                    res.append(await t.get_range(
                        a, b, limit=limit, reverse=rev, limit_bytes=lb,
                        snapshot=snap))
                elif kind == "set":
                    t.set(op[1], op[2])
                elif kind == "clear":
                    t.clear(op[1])
                elif kind == "clear_range":
                    t.clear(op[1], op[2])
                elif kind == "atomic":
                    t.atomic_op(ty.MutationType[op[1]], op[2], op[3])
                elif kind == "vs_key":
                    t.set_versionstamped_key(op[1], 3, b"x%d" % i)
                elif kind == "vs_value":
                    t.set_versionstamped_value(op[1], op[2], 2)
                elif kind == "rcr":
                    t.add_read_conflict_range(op[1], op[2])
                elif kind == "wcr":
                    t.add_write_conflict_range(op[1], op[2])
                else:
                    vs_futs.append(t.get_versionstamp())
                    res.append("vs")
            except s.FdbError as e:
                res.append(("error", e.name))
        if end == "commit":
            sends = bool(t.writes.mutations or t._extra_write_ranges)
            try:
                v = await t.commit()
                stamps.note(v, i)
                res.append(("committed", v == -1))
            except s.FdbError as e:
                res.append(("commit error", e.name))
            if sends:
                expect_rs.append(t._read_version.get().version
                                 if t.read_conflict_ranges else 0)
        else:
            t.reset()
            res.append(("reset", await t.get(KEYS[i])))
        for f in vs_futs:
            try:
                st = await f
                res.append(("stamp", stamps.stamp(st),
                            st[:8] == t.committed_version.to_bytes(8,
                                                                   "big")))
            except s.FdbError as e:
                res.append(("stamp error", e.name))
        out.append(stamps.norm(res))
    rows = await rows_of(s)
    return {"results": out, "rows": stamps.norm(rows),
            "expect_rs": expect_rs}


def refs_of(captured, types) -> list:
    out = []
    for pid in PROXIES:
        for t in captured[pid]:
            out.append((pid, [(r.begin, r.end) for r in
                              t.read_conflict_ranges],
                        [(r.begin, r.end) for r in t.write_conflict_ranges],
                        [(int(m.type), m.param1, m.param2)
                         for m in t.mutations],
                        t.report_conflicting_keys, t.tenant_id, t.tag))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_serial_transactions_match(sides, seed):
    r = random.Random(seed)
    scripts = [txn_script(r, i) for i in range(40)]
    ref, port = sides()
    want = ref.run(run_serial(ref, scripts))
    got = port.run(run_serial(port, scripts))
    assert got["results"] == want["results"]
    assert got["rows"] == want["rows"]
    assert refs_of(port.captured, pt) == refs_of(ref.captured, rt)
    # Each side's read_snapshot is its own read version (0 with no read
    # conflict range), one a transaction that reached a proxy.
    for side, res in ((ref, want), (port, got)):
        snaps = [t.read_snapshot for pid in PROXIES
                 for t in side.captured[pid]]
        assert sorted(snaps) == sorted(res["expect_rs"])
    n_commits = sum(1 for res in got["results"] for x in res
                    if x == ("committed", False))
    assert n_commits > 10
    flat = str(got["results"])
    for what in ("accessed_unreadable", "stamp", "reset"):
        assert what in flat, what


# ------------------------------------------- interleavings and the retry loop
async def interleavings(s) -> list:
    db, out = s.db, []
    k1, k2, k3 = KEYS[10], KEYS[70], KEYS[100]
    # A reads k; B reads and writes k and commits; A writes k and commits.
    a, b = db.create_transaction(), db.create_transaction()
    a.report_conflicting_keys = True
    await a.get(k1)
    await b.get(k1)
    b.set(k1, b"b")
    await b.commit()
    a.set(k1, b"a")
    try:
        await a.commit()
        out.append("a committed")
    except s.FdbError as e:
        out.append(("a", e.name))
        out.append(await a.get_range(CK, CK + b"\xff"))
        await a.on_error(e)
        out.append(("retry sees", await a.get(k1)))
        out.append(("rows survive on_error", await a.get(CK + k1)))
        a.set(k1, b"a2")
        await a.commit()
    # Three: A reads a range over k1..k2, B writes k2, C reads k3 and
    # writes k1; B and C commit, then A writes k3: A conflicts on the
    # range and on nothing else.
    a, b, c = (db.create_transaction() for _ in range(3))
    a.report_conflicting_keys = True
    out.append(await a.get_range(k1, k2 + b"\x00", limit=5))
    await c.get(k3)
    b.set(k2, b"B")
    c.set(k1, b"C")
    await b.commit()
    await c.commit()
    a.set(k3, b"A")
    try:
        await a.commit()
        out.append("a committed")
    except s.FdbError as e:
        out.append(("a", e.name, await a.get_range(CK, CK + b"\xff")))
    # A snapshot read does not conflict.
    a, b = db.create_transaction(), db.create_transaction()
    await a.get(k2, snapshot=True)
    b.set(k2, b"B2")
    await b.commit()
    a.set(k2, b"A2")
    out.append(("snapshot commit", await a.commit() > 0))
    # on_error's backoff, in the loop's time, up to DEFAULT_MAX_BACKOFF.
    t = db.create_transaction()
    waits = []
    for _ in range(10):
        t0 = s.now()
        await t.on_error(s.err("not_committed"))
        waits.append(round(s.now() - t0, 9))
    out.append(("backoff", waits))
    try:
        await t.on_error(s.err("key_too_large"))
    except s.FdbError as e:
        out.append(("not retryable", e.name))
    # run() retries to success; a non-retryable error is raised.
    attempts = [0]

    async def fn(t):
        attempts[0] += 1
        await t.get(k1)
        t.set(k1, b"run%d" % attempts[0])
        if attempts[0] < 3:
            raise s.err("not_committed")
        return attempts[0]
    out.append(("run", await db.create_transaction().run(fn)))

    async def bad(t):
        t.set(b"k" * 10001, b"v")
    try:
        await db.create_transaction().run(bad)
    except s.FdbError as e:
        out.append(("run raised", e.name))
    # A read-only commit returns -1; its versionstamp fails.
    t = db.create_transaction()
    await t.get(k1)
    f = t.get_versionstamp()
    out.append(("read-only", await t.commit()))
    for g in (f, t.get_versionstamp()):
        try:
            await g
        except s.FdbError as e:
            out.append(("vs", e.name))
    # transaction_too_old: a read version below the MVCC window.
    for i in range(3):
        await s.delay(3.0)
        t = db.create_transaction()
        t.set(k3, b"tick%d" % i)
        await t.commit()
    t = db.create_transaction()
    t.set_read_version(1)
    try:
        await t.get(k1)
    except s.FdbError as e:
        out.append(("old read", e.name))
    t = db.create_transaction()
    t.set_read_version(1)
    t.add_read_conflict_range(k1, k2)
    t.set(k1, b"old")
    try:
        await t.commit()
    except s.FdbError as e:
        out.append(("old commit", e.name))
    # The client's own checks.
    t = db.create_transaction()
    for call in (lambda: t.set(b"k" * 10001, b"v"),
                 lambda: t.set(k1, b"v" * 100001),
                 lambda: t.set(b"\xff/x", b"v"),
                 lambda: t.clear(b"\xff\xff"),
                 lambda: t.set_versionstamped_key(b"short", 0, b"v")):
        try:
            call()
            out.append("accepted")
        except s.FdbError as e:
            out.append(("check", e.name))
    for i in range(200):
        t.set(b"big/%03d" % i, b"v" * 99999)
    try:
        await t.commit()
    except s.FdbError as e:
        out.append(("big", e.name))
    out.append(await rows_of(s))
    return out


def test_interleavings_and_the_retry_loop(sides):
    want, got, _, _ = both(sides, interleavings)
    assert got == want
    flat = str(got)
    for what in ("not_committed", "transaction_too_old", "key_too_large",
                 "value_too_large", "key_outside_legal_range",
                 "transaction_too_large", "operation_failed",
                 "client_invalid_operation", "('read-only', -1)",
                 "('run', 3)"):
        assert what in flat, what
    rows = got[1]
    assert rows == [(CK + KEYS[10], b"\x01"), (CK + KEYS[10] + b"\x00",
                                                b"\x00")], rows
    three = next(x for x in got if x[:1] == ("a",) and len(x) == 3)
    assert three[1] == "not_committed" and three[2], three
    backoff = next(x for x in got if x[0] == "backoff")[1]
    assert backoff[:3] == [0.01, 0.02, 0.04] and backoff[-1] == 1.0


# --------------------------------------------------- GRV batching and lease
async def rw_txn(db, key):
    t = db.create_transaction()
    await t.get(key)
    t.set(key, b"x")
    return await t.commit()


async def grv_default(s):
    for i in range(5):
        await rw_txn(s.db, KEYS[i])


async def grv_lease_repeats(s):
    for i in range(6):
        await rw_txn(s.db, KEYS[i])


async def grv_floor(s):
    t = s.db.create_transaction()
    await t.get(KEYS[3])
    t.set(KEYS[3], b"v1")
    v = await t.commit()
    t2 = s.db.create_transaction()
    seen = await t2.get(KEYS[3])
    return seen, (await t2._ensure_read_version()) >= v


async def grv_expires(s):
    await rw_txn(s.db, KEYS[1])
    await s.delay(1.0)
    await rw_txn(s.db, KEYS[2])


async def grv_no_slide(s):
    for _ in range(10):
        t = s.db.create_transaction()
        await t.get(KEYS[5])
        await s.delay(0.2)


async def grv_batched(s):
    txns = [s.db.create_transaction() for _ in range(6)]
    versions = await s.wait_all([s.spawn(t._ensure_read_version())
                                 for t in txns])
    return len(set(versions))


async def grv_not_plain(s):
    await rw_txn(s.db, KEYS[7])
    t = s.db.create_transaction()
    t.tag = "hot"
    await t.get(KEYS[8])
    t2 = s.db.create_transaction()
    t2.debug_id = "dbg-1"
    await t2.get(KEYS[8])


GRV_CASES = [(grv_default, {}), (grv_lease_repeats, {"GRV_LEASE_S": 5.0}),
             (grv_floor, {"GRV_LEASE_S": 5.0}),
             (grv_expires, {"GRV_LEASE_S": 0.5}),
             (grv_no_slide, {"GRV_LEASE_S": 0.5}),
             (grv_batched, {"GRV_BATCH_ENABLED": True}),
             (grv_not_plain, {"GRV_LEASE_S": 5.0,
                              "GRV_BATCH_ENABLED": True})]


@pytest.mark.parametrize("case", range(len(GRV_CASES)),
                         ids=[c[0].__name__ for c in GRV_CASES])
def test_grv_batching_and_lease(sides, knobs, case):
    scenario, settings = GRV_CASES[case]
    ref, port = sides()
    for s in (ref, port):
        for k, v in settings.items():
            setattr(s.knobs, k, v)
    want = ref.run(scenario(ref))
    got = port.run(scenario(port))
    assert got == want
    assert port.db.grv_stats == ref.db.grv_stats
    for name in ("TxnStarted", "ClientBatchedGrvRequests"):
        assert port.grv_metrics.counter(name).value == \
            ref.grv_metrics.counter(name).value, name
    if scenario is grv_batched:
        assert got == 1 and port.db.grv_stats["requests"] == 1
        assert port.grv_metrics.counter("TxnStarted").value == 6
    if scenario is grv_lease_repeats:
        assert port.db.grv_stats["leased"] == 5
    if scenario is grv_no_slide:
        st = port.db.grv_stats
        assert 3 <= st["requests"] <= 9 and st["refreshes"] >= 2, st
    if scenario is grv_default:
        assert port.db.grv_stats["requests"] == 5


# ---------------------------------------------------------------- failover
async def failover(s):
    """Storage server 0 stopped: every read of its team's shards is
    answered by the other replica."""
    s.stop("ss0")
    out = []
    for k in KEYS[:40:3] + KEYS[100:]:
        t = s.db.create_transaction()
        out.append(await t.get(k))
        out.append(await t.get_range(k, k + b"\x01"))
    t = s.db.create_transaction()
    out.append(len(await t.get_range(b"", b"\x80", limit=1000)))
    t.set(KEYS[0], b"after")
    await t.commit()
    t = s.db.create_transaction()
    out.append(await t.get(KEYS[0]))
    return out


def test_failover_to_the_other_replica(sides):
    want, got, ref, port = both(sides, failover)
    assert got == want
    assert want[0] == b"base" + KEYS[0] and want[-1] == b"after"
    # The stopped replica was demoted in the latency ordering.
    slow = port.c.storage[0].interface.get_value
    assert port.db._replica_latency[id(slow)] > 0.05


class StubSSI:
    """A replica answering every read `latency` seconds after it
    arrives, on either side's loop."""

    def __init__(self, s, stream_cls, value, latency):
        self.stream = stream_cls("stub")
        self.value, self.latency, self.s = value, latency, s

    async def serve(self):
        async for req in self.stream.queue:
            self.s.spawn(self.answer(req))

    async def answer(self, req):
        await self.s.delay(self.latency)
        req.reply.send(self.value)


class StubReq:
    reply = None


async def hedged(s, slow, fast):
    db = s.db
    db._replica_latency[db._replica_key(fast)] = 0.06
    t0 = s.now()
    first = await db.read_replica([slow, fast], lambda x: x.stream,
                                  lambda: StubReq())
    took = s.now() - t0
    t1 = s.now()
    second = await db.read_replica([slow, fast], lambda x: x.stream,
                                   lambda: StubReq())
    return first, took < 1.0, second, s.now() - t1 < 0.05


def test_hedged_reads(sides):
    """tests/test_hedged_reads.py's race on both sides: the slow replica
    is preferred, the hedge after HEDGE_REQUEST_DELAY wins, and the
    laggard is demoted for the next read."""
    from foundationdb_tpu.rpc.endpoint import RequestStream as RefStream
    from foundationdb_tpu_torch.rpc.endpoint import RequestStream
    ref, port = sides()
    results = []
    for s, cls in ((ref, RefStream), (port, RequestStream)):
        slow = StubSSI(s, cls, b"from-slow", 10.0)
        fast = StubSSI(s, cls, b"from-fast", 0.005)
        if s is ref:
            for stub, name in ((slow, "slowss"), (fast, "fastss")):
                proc = s.c.sim.new_process(name=name)
                proc.register(stub.stream)
                proc.spawn(stub.serve(), name)
        else:
            for stub in (slow, fast):
                s.spawn(stub.serve())
        results.append(s.run(hedged(s, slow, fast)))
    assert results[1] == results[0] == (b"from-fast", True, b"from-fast",
                                        True)


async def lost_reply(s):
    t = s.db.create_transaction()
    await t.get(KEYS[5])
    t.set(KEYS[5], b"lost?")
    f = s.spawn(t.commit())
    await s.delay(0.0005)
    for pid in PROXIES:
        s.stop(pid)
    try:
        await f
        return "committed"
    except s.FdbError as e:
        return e.name


def test_lost_commit_reply_is_unknown_result(sides):
    want, got, _, _ = both(sides, lost_reply)
    assert got == want == "commit_unknown_result"


async def parked_read(s, req_cls):
    """A read at a version the logs do not hold: the server holds it for
    STORAGE_FUTURE_VERSION_TIMEOUT of the loop's time, then answers
    future_version."""
    stream = s.replicas[0].interface.get_value
    t0 = s.now()
    try:
        await stream.get_reply(req_cls(key=KEYS[0], version=1 << 50))
        return "answered"
    except s.FdbError as e:
        return e.name, s.now() - t0 >= 1.0


def test_parked_read_answers_future_version(sides):
    from foundationdb_tpu.server.interfaces import GetValueRequest as RefReq
    from foundationdb_tpu_torch.server.interfaces import GetValueRequest
    ref, port = sides()
    want = ref.run(parked_read(ref, RefReq))
    got = port.run(parked_read(port, GetValueRequest))
    assert got == want == ("future_version", True)
    ss = port.replicas[0]
    assert not ss._parked            # the answered read left the set
    # A read parked when its server stops answers broken_promise.
    f = ss.interface.get_value.get_reply(
        GetValueRequest(key=KEYS[0], version=1 << 50))
    port.c.run_until(port.delay(0.01))
    assert len(ss._parked) == 1
    port.stop(ss.id)
    port.c.run_until(port.delay(0.01))
    assert f.is_error() and f.error.name == "broken_promise"
    assert not ss._parked


# --------------------------------------------------------------- workloads
@pytest.mark.parametrize("which", ["Cycle", "ReadWrite"])
def test_workloads(sides, which):
    from foundationdb_tpu.testing import workloads as ref_w
    from foundationdb_tpu_torch.testing import workloads as port_w
    config = ({"nodeCount": 50, "actorCount": 8, "testDuration": 0.02,
               "seed": 5} if which == "Cycle" else
              {"nodeCount": 200, "actorCount": 8, "testDuration": 0.02,
               "seed": 6})
    ref, port = sides()
    out = []
    for s, mod in ((ref, ref_w), (port, port_w)):
        cls = getattr(mod, which + "Workload")
        w = cls(s.c, s.db, dict(config))
        s.run(w.setup())
        s.run(w.start())
        out.append((s.run(w.check()), dict(w.metrics)))
    assert out[0][0] is True and out[1][0] is True
    key = "swaps" if which == "Cycle" else "operations"
    assert out[0][1][key] > 0 and out[1][1][key] > 0


# ---------------------------------------------------- phase 24 on the CPU
def test_chip_smoke_client_on_cpu():
    """chip_smoke.py phase 24 at a tiny size on the CPU: ReadWrite and
    Cycle through StaticCluster.database() with every check of the
    phase (read-back on both replicas, the ring, the oracle replay of
    the Cycle batches) but the launch counts."""
    import chip_smoke
    fig = chip_smoke.client_run(
        device="cpu", keyspace=2_000, rw_actors=16, rw_txns=4,
        cycle_nodes=200, cycle_actors=8, cycle_swaps=3,
        capacity=1 << 12, delta_capacity=1 << 10)
    assert fig["rw"]["committed"] == 16 * 4
    assert fig["cycle"]["swaps"] == 8 * 3
    assert fig["cycle"]["replayed_batches"] > 0
    assert fig["rw"]["range_read_txns"] > 0
