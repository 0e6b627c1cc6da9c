"""The port's Resolver role held against the reference's, request for request.

The reference's Resolver (foundationdb_tpu/server/resolver.py) runs its
_resolve_batch coroutine and its _serve_metrics / _serve_split /
_serve_heat loops on the conftest's simulated event loop; the port's
(foundationdb_tpu_torch/server/resolver.py) takes the same requests
through resolve_batch and its serve_* methods.  Both answer stub reply
objects that log what they are sent, in order.  The requests come from
one seeded stream: two proxies (and, once, a third nobody registered)
alternating on one version chain, batches delivered before their
predecessors (parked, then answered in chain order), resends of cached
batches and of batches below the trimmed cache, state transactions with
mutations on every proxy, report_conflicting_keys, tenant- and
tag-tagged aborts, and the heat, split and metrics requests between.
One more stream loses a reply: its send raises after the request has
woken the parked ones behind it, which must be answered all the same.

Required, with tolerance 0 (all the data is integers, enums and bytes):
the same replies in the same order, each field for field (committed,
conflicting_ranges, attribution_exact, state_transactions); the same
counters (TxnResolved, TxnConflicts, HeatConflictRanges,
HeatConservativeTxns, TxnResolvedDegraded); the same metrics, split and
heat answers and heat_status; the same version, state-transaction
bytes and reply caches.  HEAT_TELEMETRY_ENABLED runs on and off, and a
lowered MAX_WRITE_TRANSACTION_LIFE_VERSIONS raises the window floor so
that TOO_OLD verdicts appear; each package's knobs are set.

(a) both roles over their oracles (backend "cpu"); (b) the reference's
over its supervised TpuConflictSet on XLA:CPU against the port's over
its supervised TorchConflictSet on the CPU, capacity 2^12.  (b)'s
stream is point reads and writes of 6-byte keys in batches of at most
64 transactions: one shape bucket of the reference's compact step, so
its programs compile once.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.server import interfaces as ri
from foundationdb_tpu.server.resolver import Resolver as RefResolver
from foundationdb_tpu.txn import types as rt
from foundationdb_tpu_torch.core import scheduler as port_scheduler
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.core.trace import recent_events
from foundationdb_tpu_torch.server import interfaces as pi
from foundationdb_tpu_torch.server.notified import NotifiedVersion
from foundationdb_tpu_torch.server.resolver import Resolver
from foundationdb_tpu_torch.txn import types as pt

CAPACITY = 1 << 12
PROXIES = ["p0", "p1"]
COUNTERS = ("TxnResolved", "TxnConflicts", "HeatConflictRanges",
            "HeatConservativeTxns", "TxnResolvedDegraded")
TAGS = ["", "t/a", "t/b"]
STEP = 1_000
LIFE = 3_000          # the lowered MAX_WRITE_TRANSACTION_LIFE_VERSIONS


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU route is many small tensor operations, which a
    thread pool only slows down on a shared CPU while it takes cores from
    whatever else runs: one intra-op thread, restored after the test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def knobs():
    """Both packages' server knobs, set together with knobs.set and
    restored after the test."""
    regs = [ref_knobs(), server_knobs()]
    saved = [dict(k.__dict__) for k in regs]

    class Both:
        @staticmethod
        def set(name, value):
            for k in regs:
                setattr(k, name, value)

    yield Both
    for k, s in zip(regs, saved):
        for name, value in s.items():
            setattr(k, name, value)


# ---------------------------------------------------------------- the stream
def key(rng, n_keys: int) -> bytes:
    return b"k%05d" % int(rng.integers(0, n_keys))


def txn_spec(rng, prev: int, n_keys: int, ranges: bool) -> dict:
    """One transaction as plain data: 1-2 reads (a range now and then
    when `ranges`), 0-1 writes, a snapshot up to 4 batches behind, a
    mutation per write, and its identity."""
    reads = []
    for _ in range(int(rng.integers(1, 3))):
        b = key(rng, n_keys)
        if ranges and rng.random() < 0.25:
            reads.append((b, b + b"\xff"))
        else:
            reads.append((b, b + b"\x00"))
    writes, muts = [], []
    if rng.random() < 0.85:
        w = key(rng, n_keys)
        if ranges and rng.random() < 0.1:
            writes.append((w, w + b"\x05"))
            muts.append((int(rt.MutationType.ClearRange), w, w + b"\x05"))
        else:
            writes.append((w, w + b"\x00"))
            muts.append((int(rt.MutationType.SetValue), w,
                         b"v" * int(rng.integers(0, 9))))
    return {"reads": reads, "writes": writes, "muts": muts,
            "snap": max(prev - int(rng.integers(0, 4 * STEP)), 0),
            "report": bool(rng.random() < 0.3),
            "tenant": int(rng.integers(-1, 3)),
            "tag": TAGS[int(rng.integers(0, len(TAGS)))]}


def make_batches(seed: int, n: int, n_txns: int, n_keys: int,
                 ranges: bool) -> list:
    """n batches on one chain, alternating p0 / p1 (batch 7 comes from
    p2, which nobody registered).  A proxy's last_received_version is the
    version of its own previous batch; one or two txns of each batch are
    state transactions carrying one more mutation."""
    rng = np.random.default_rng(seed)
    out, prev, last = [], 0, {}
    for i in range(n):
        version = prev + STEP
        proxy = "p2" if i == 7 else PROXIES[i % 2]
        txns = [txn_spec(rng, prev, n_keys, ranges)
                for _ in range(int(rng.integers(n_txns // 2, n_txns + 1)))]
        state = sorted(set(int(t) for t in rng.integers(
            0, len(txns), size=int(rng.integers(1, 3)))))
        for t in state:
            txns[t]["muts"].append((int(rt.MutationType.SetValue),
                                    b"\xff/conf/%d" % i, b"x" * (t + 1)))
        out.append({"name": f"b{i}", "prev": prev, "version": version,
                    "lrv": last.get(proxy, 0), "proxy": proxy,
                    "txns": txns, "state": state,
                    "span": "dbg%d" % i if i % 5 == 0 else ""})
        last[proxy] = version
        prev = version
    return out


def build(types, spec: dict):
    return [types.CommitTransactionRef(
        read_conflict_ranges=[types.KeyRange(b, e) for b, e in t["reads"]],
        write_conflict_ranges=[types.KeyRange(b, e) for b, e in t["writes"]],
        mutations=[types.Mutation(types.MutationType(m), p1, p2)
                   for m, p1, p2 in t["muts"]],
        read_snapshot=t["snap"], report_conflicting_keys=t["report"],
        tenant_id=t["tenant"], tag=t["tag"]) for t in spec["txns"]]


class Stub:
    """A reply promise that logs (request name, value)."""

    def __init__(self, log: list, name: str) -> None:
        self.log, self.name = log, name

    def send(self, value) -> None:
        self.log.append((self.name, value))


class LostReply(Exception):
    """Raised by a Lost reply promise, with the request's name."""


class Lost(Stub):
    """A reply promise whose send raises: the reply is lost."""

    def send(self, value) -> None:
        raise LostReply(self.name)


# ---------------------------------------------------------------- the twins
def view(value):
    """A reply or served answer as plain comparable data."""
    if isinstance(value, (ri.ResolveTransactionBatchReply,
                          pi.ResolveTransactionBatchReply)):
        return ("reply", [int(c) for c in value.committed],
                {i: [tuple(r) for r in rs]
                 for i, rs in value.conflicting_ranges.items()},
                dict(value.attribution_exact),
                [(v, p, s, [(int(m.type), m.param1, m.param2) for m in ms],
                  int(verdict))
                 for v, p, s, ms, verdict in value.state_transactions])
    return value


class TwinRoles:
    """The reference's role on the sim loop and the port's, fed the same
    requests; every step compares what both answered and hold."""

    def __init__(self, loop, ref_kwargs: dict, port_kwargs: dict) -> None:
        self.loop = loop
        self.ref = RefResolver("r0", 0, proxy_ids=PROXIES, **ref_kwargs)
        self.port = Resolver("r0", 0, proxy_ids=PROXIES, **port_kwargs)
        self.ref_log, self.port_log = [], []
        # (name, actor) of each reference request; the names of the
        # requests whose lost reply the port's resolve_batch raised.
        self.ref_runs, self.port_lost = [], []
        self.batches = {}
        self.seen = 0
        for coro in (self.ref._serve_metrics(), self.ref._serve_split(),
                     self.ref._serve_heat()):
            loop.spawn(coro)
        loop.run_for(0.0)

    def _req(self, side: str, spec: dict, tag: str, lose: bool = False):
        mod, types, log = ((ri, rt, self.ref_log) if side == "ref"
                           else (pi, pt, self.port_log))
        key_ = (side, spec["name"])
        if key_ not in self.batches:        # a resend carries the same txns
            self.batches[key_] = build(types, spec)
        return mod.ResolveTransactionBatchRequest(
            prev_version=spec["prev"], version=spec["version"],
            last_received_version=spec["lrv"],
            transactions=self.batches[key_],
            txn_state_transactions=list(spec["state"]),
            proxy_id=spec["proxy"], span=spec["span"],
            reply=(Lost if lose else Stub)(log, spec["name"] + tag))

    def deliver(self, *specs, tag: str = "", lose=()) -> list:
        """Hand `specs` to both roles in this order; returns the names of
        the replies this step produced.  The requests named in `lose` get
        a reply promise whose send raises."""
        for spec in specs:
            name = spec["name"] + tag
            self.ref_runs.append((name, self.loop.spawn(
                self.ref._resolve_batch(self._req(
                    "ref", spec, tag, spec["name"] in lose)))))
        self.loop.run_for(0.0)
        for spec in specs:
            try:
                self.port.resolve_batch(self._req(
                    "port", spec, tag, spec["name"] in lose))
            except LostReply as e:
                self.port_lost.append(str(e))
        return self.check()

    def serve(self, kind: str, **fields) -> list:
        ref_cls, port_cls, stream, method = {
            "metrics": (ri.ResolutionMetricsRequest,
                        pi.ResolutionMetricsRequest, "metrics",
                        "serve_metrics"),
            "split": (ri.ResolutionSplitRequest, pi.ResolutionSplitRequest,
                      "split", "serve_split"),
            "heat": (ri.ResolverHeatRequest, pi.ResolverHeatRequest, "heat",
                     "serve_heat")}[kind]
        getattr(self.ref.interface, stream).deliver(
            ref_cls(reply=Stub(self.ref_log, kind), **fields))
        self.loop.run_for(0.0)
        getattr(self.port, method)(
            port_cls(reply=Stub(self.port_log, kind), **fields))
        return self.check()

    def check(self) -> list:
        ref, port = self.ref, self.port
        new = self.ref_log[self.seen:]
        assert [(n, view(v)) for n, v in self.port_log] == \
            [(n, view(v)) for n, v in self.ref_log]
        self.seen = len(self.ref_log)
        ref_lost = []
        for name, actor in self.ref_runs:
            if actor.is_ready() and actor.is_error():
                assert isinstance(actor.error, LostReply), actor.error
                ref_lost.append(name)
        assert self.port_lost == ref_lost
        for name in COUNTERS:
            assert port.metrics.counter(name).value == \
                ref.metrics.counter(name).value, name
        assert port.version.get() == ref.version.get()
        assert port.resolved_batches == ref.resolved_batches
        assert port.total_state_bytes == ref.total_state_bytes
        assert [(e[0], e[1], e[2]) for e in port.state_txns] == \
            [(e[0], e[1], e[2]) for e in ref.state_txns]
        assert {p: (i.last_version, i.last_received_version,
                    sorted(i.outstanding))
                for p, i in port.proxy_infos.items()} == \
            {p: (i.last_version, i.last_received_version,
                 sorted(i.outstanding))
             for p, i in ref.proxy_infos.items()}
        assert port._ranges_since_poll == ref._ranges_since_poll
        assert port.heat_status() == ref.heat_status()
        assert list(port.heat.ranges.items()) == \
            list(ref.heat.ranges.items())
        return [n for n, _ in new]


def run_scenario(twin: TwinRoles, batches: list) -> dict:
    """The request sequence both roles get; returns what it exercised."""
    b = batches
    assert twin.deliver(b[0]) == ["b0"]
    assert twin.deliver(b[1]) == ["b1"]
    assert twin.serve("metrics")
    assert twin.deliver(b[2]) == ["b2"]
    # b4 arrives before its predecessor: parked, then answered after b3.
    assert twin.deliver(b[4]) == []
    assert twin.port.parked() == 1
    assert twin.deliver(b[3]) == ["b3", "b4"]
    # A resend of the last batch: the cached reply, no resolve.
    resolved = twin.port.resolved_batches
    assert twin.deliver(b[4], tag="-resend") == ["b4-resend"]
    assert twin.port.resolved_batches == resolved
    assert twin.port_log[-1][1] is twin.port_log[-2][1]
    twin.serve("heat", top_k=4)
    twin.deliver(b[5])
    # b7 is the first request of p2, which nobody registered: it counts
    # from its arrival on (its last_received_version -1 holds back the
    # trim of the state transactions b6 would make), though parked.
    assert twin.deliver(b[7]) == []
    assert twin.deliver(b[6]) == ["b6", "b7"]
    # b0 was p0's; p0's last_received_version has passed it: trimmed from
    # the cache, so its resend gets no reply.
    assert twin.deliver(b[0], tag="-resend") == []
    # Behind b8: b9, a resend of b9 and b10.  b8's version wakes b9 and
    # its resend at once; they run in arrival order, so the resend finds
    # b9's reply in the cache.
    assert twin.deliver(b[9]) == []
    assert twin.deliver(b[9], tag="-resend") == []
    assert twin.deliver(b[10]) == []
    assert twin.port.parked() == 3
    # A resend of a cached batch while others wait: answered at once.
    assert twin.deliver(b[6], tag="-resend") == ["b6-resend"]
    assert twin.deliver(b[8]) == ["b8", "b9", "b9-resend", "b10"]
    assert twin.port_log[-2][1] is twin.port_log[-3][1]
    assert twin.port.parked() == 0
    for spec in b[11:]:
        twin.deliver(spec)
        twin.serve("metrics")
    for _ in range(3):      # the 8th poll decays the load samples
        twin.serve("metrics")
    for begin, end, fraction in ((b"", b"\xff", 0.5), (b"k00010", b"k00040",
                                                       0.3),
                                 (b"k00020", b"k00021", 0.9),
                                 (b"zz", b"zzz", 0.5)):
        twin.serve("split", begin=begin, end=end, fraction=fraction)
    twin.serve("heat", top_k=0)
    twin.serve("heat", top_k=32)
    codes = [int(c) for _, v in twin.port_log
             if isinstance(v, pi.ResolveTransactionBatchReply)
             for c in v.committed]
    return {"codes": codes,
            "state_broadcast": sum(
                len(v.state_transactions) for _, v in twin.port_log
                if isinstance(v, pi.ResolveTransactionBatchReply)),
            "reported": sum(
                len(v.conflicting_ranges) for _, v in twin.port_log
                if isinstance(v, pi.ResolveTransactionBatchReply))}


def check_coverage(twin: TwinRoles, seen: dict, heat_on: bool,
                   life: int) -> None:
    """The stream did exercise what it is for."""
    codes = seen["codes"]
    assert codes.count(0) > 0 and codes.count(2) > 0
    assert (codes.count(1) > 0) == (life == LIFE)
    assert seen["state_broadcast"] > 0 and seen["reported"] > 0
    assert twin.port.total_state_bytes > 0
    assert "p2" in twin.port.proxy_infos
    heat = twin.port.heat
    if heat_on:
        assert heat.total_conflicts > 0 and heat.tenants and heat.tags
        assert any(r for _, r in twin.port_log if isinstance(r, list))
    else:
        assert heat.total_conflicts == 0
        assert all(r == [] for n, r in twin.port_log if n == "heat")
    assert heat.total_load > 0
    events = recent_events("CommitDebug")
    assert {e["Location"] for e in events} >= {
        "Resolver.r0.resolveBatch", "Resolver.r0.afterResolve"}


@pytest.mark.parametrize("heat_on", [True, False])
@pytest.mark.parametrize("life", [LIFE, None])
def test_twin_roles_over_oracles(loop, knobs, heat_on, life):
    """(a) both roles over their oracles, the stream with range reads and
    range writes."""
    knobs.set("HEAT_TELEMETRY_ENABLED", heat_on)
    if life is not None:
        knobs.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", life)
    twin = TwinRoles(loop, {"backend": "cpu"}, {"backend": "cpu"})
    seen = run_scenario(twin, make_batches(11, 16, 40, 60, ranges=True))
    check_coverage(twin, seen, heat_on, life)
    assert twin.port.backend_status() == {}


@pytest.mark.parametrize("heat_on", [True, False])
def test_twin_roles_over_supervised_sets(loop, knobs, heat_on):
    """(b) the reference's role over its supervised TpuConflictSet on
    XLA:CPU, the port's over its supervised TorchConflictSet on the CPU:
    the same replies, counters and answers; neither set degraded."""
    knobs.set("HEAT_TELEMETRY_ENABLED", heat_on)
    knobs.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", LIFE)
    twin = TwinRoles(loop, {"backend": "tpu", "capacity": CAPACITY},
                     {"backend": "torch", "device": "cpu",
                      "capacity": CAPACITY})
    seen = run_scenario(twin, make_batches(12, 16, 64, 80, ranges=False))
    check_coverage(twin, seen, heat_on, LIFE)
    st, ref_st = twin.port.backend_status(), twin.ref.backend_status()
    assert st["degraded"] is False and st["degrades"] == 0
    assert st["device_batches"] == ref_st["device_batches"] == \
        twin.port.resolved_batches
    assert twin.port.conflict_set.device.device.type == "cpu"
    # Each batch took the compact point step.
    prof = twin.port.conflict_set.device.profile
    assert prof["compact_batches"] == twin.port.resolved_batches
    assert prof["general_batches"] == 0


def test_twin_roles_when_a_reply_is_lost(loop):
    """A request whose reply's send raises after its version has woken
    the parked requests behind it: the reference's actor fails alone and
    the woken ones still answer; the port's resolve_batch answers them
    too, then raises.  The chain goes on, and the proxy's resend of the
    lost batch is answered from the cache."""
    twin = TwinRoles(loop, {"backend": "cpu"}, {"backend": "cpu"})
    b = make_batches(13, 9, 30, 40, ranges=True)
    assert twin.deliver(b[0]) == ["b0"]
    assert twin.deliver(b[2]) == []
    assert twin.deliver(b[3]) == []
    assert twin.deliver(b[1], lose=("b1",)) == ["b2", "b3"]
    assert twin.port_lost == ["b1"]
    assert twin.port.parked() == 0
    assert twin.deliver(b[1], tag="-resend") == ["b1-resend"]
    for spec in b[4:]:
        assert twin.deliver(spec) == [spec["name"]]
    assert twin.port.resolved_batches == len(b)


def test_queue_wait_counts_from_arrival(loop):
    """A host that held a request before handing it over (the slowBatch
    sleep) passes its arrival time: QueueWait counts the hold, as the
    reference's does; a request handed over at once waits 0."""
    port_scheduler.set_event_loop(loop)
    try:
        role = Resolver("rq", 0, backend="cpu", proxy_ids=["p0"])
        log = []

        def req(prev, version):
            return pi.ResolveTransactionBatchRequest(
                prev_version=prev, version=version,
                last_received_version=0, transactions=[], proxy_id="p0",
                reply=Stub(log, str(version)))

        t_in = loop.now()
        loop.run_for(0.02)
        role.resolve_batch(req(0, 100), t_in)
        role.resolve_batch(req(100, 200))
    finally:
        port_scheduler.set_event_loop(None)
    wait = role.metrics.histogram("QueueWait").snapshot()
    assert (wait.count, wait.min, wait.max) == (2, 0.0, 0.02)
    assert [n for n, _ in log] == ["100", "200"]


def test_emit_heat_once(knobs):
    """emit_heat_once logs one HotConflictRange event per top-K conflict
    row, and none with heat telemetry off."""
    knobs.set("CONFLICT_HEAT_TOP_K", 2)
    role = Resolver("rh", 0, backend="cpu")
    for k, n in ((b"a", 3), (b"b", 1), (b"c", 2)):
        role.heat.record_conflict(k, k + b"\x00", weight=n)
    before = len(recent_events("HotConflictRange"))
    role.emit_heat_once()
    rows = recent_events("HotConflictRange")[before:]
    assert [(e["Begin"], e["Conflicts"]) for e in rows] == \
        [(b"a", 3), (b"c", 2)]
    assert all(e["Id"] == "rh" for e in rows)
    knobs.set("HEAT_TELEMETRY_ENABLED", False)
    role.emit_heat_once()
    assert len(recent_events("HotConflictRange")) == before + 2
    started = [e for e in recent_events("ResolverStarted")
               if e["Id"] == "rh"]
    assert started and started[-1]["Backend"] == "OracleConflictSet"


def test_parked_requests_dropped():
    """drop_parked forgets the parked requests unanswered; the chain goes
    on from where it was."""
    role = Resolver("rd", 100, backend="cpu", proxy_ids=["p0"])
    log = []

    def req(prev, version, name):
        return pi.ResolveTransactionBatchRequest(
            prev_version=prev, version=version, last_received_version=100,
            transactions=[], proxy_id="p0", reply=Stub(log, name))

    role.resolve_batch(req(300, 400, "c"))
    role.resolve_batch(req(200, 300, "b"))
    assert role.parked() == 2 and log == []
    assert role.drop_parked() == 2
    role.resolve_batch(req(100, 200, "a"))
    assert [n for n, _ in log] == ["a"] and role.version.get() == 200


def test_notified_version_wakes_in_reference_order(loop):
    """The port's continuations wake in the reference's futures' order:
    by threshold, then arrival."""
    from foundationdb_tpu.server.notified import NotifiedVersion as RefNV
    thresholds = [5, 3, 5, 9, 1, 3, 7, 20]
    ref, port = RefNV(2), NotifiedVersion(2)
    ref_order, port_order = [], []
    for i, t in enumerate(thresholds):
        ref.when_at_least(t).on_ready(lambda f, i=i: ref_order.append(i))
        port.when_at_least(t, lambda v, i=i: port_order.append(i))
    for v in (2, 4, 5, 9, 9, 15):
        ref.set(v)
        port.set(v)
        assert port_order == ref_order, v
    assert port.waiting() == 1
    with pytest.raises(AssertionError):
        port.set(3)


def test_role_needs_a_card_unless_told(monkeypatch):
    """The role's default set is the supervised torch set on `cuda`: with
    no card and no device named, construction raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Resolver("r0", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Resolver("r0", 0, backend="torch")
    role = Resolver("r0", 0, backend="torch", device="cpu",
                    capacity=1 << 10)
    assert role.conflict_set.device.device.type == "cpu"
