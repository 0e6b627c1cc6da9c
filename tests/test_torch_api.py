"""Heat-telemetry attribution of the port's conflict sets against the
reference's, exactly.

`ConflictSet.resolve_with_conflicts` returns the verdicts and the reported
conflict ranges, and leaves the batch's heat attribution in
`last_attribution` / `last_attribution_exact` when the
HEAT_TELEMETRY_ENABLED knob is on (foundationdb_tpu/conflict/api.py:56-82);
a resolver reads them after every batch (server/resolver.py:146-152).  On
seeded streams of small point and range batches that conflict, the port's
TorchConflictSet(device="cpu") is held against TpuConflictSet (JAX on the
CPU), ShardedTorchConflictSet on an 8-device CPU mesh against
ShardedTpuConflictSet on the conftest's 8 virtual devices, and the port's
oracle against the reference's, and the port's SupervisedConflictSet
against the reference's: verdicts, reported ranges and both
attribution dicts must be equal, with the knob on and with it off (then
both backends give {}; both oracles keep their exact attribution, which
neither package gates).  Each side's knob is set the reference's way, on its
own process-wide registry, and restored after the test.

The factory's cases: new_conflict_set's "torch", "torch-raw", "sharded",
"auto" and None against the reference's rules (conflict/api.py:113-170),
and the supervised sharded set through a degrade and a promotion.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu import txn as jt
from foundationdb_tpu.conflict.oracle import OracleConflictSet as JaxOracle
from foundationdb_tpu.conflict.supervisor import \
    SupervisedConflictSet as RefSupervised
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu.core.knobs import server_knobs as jax_knobs
from foundationdb_tpu.parallel.sharded_resolver import ShardedTpuConflictSet
from foundationdb_tpu.parallel.sharded_window import \
    make_conflict_mesh as jax_mesh
from foundationdb_tpu_torch.conflict.api import (
    ConflictSet, full_conservative_attribution, new_conflict_set)
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.supervisor import (
    BackendHealthMonitor, SupervisedConflictSet)
from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.parallel import (ShardedTorchConflictSet,
                                             make_conflict_mesh)
from foundationdb_tpu_torch.txn import types as pt

VERSIONS_PER_BATCH = 1_000_000
KEYS = 300
N_TXNS = 120


@pytest.fixture(params=[True, False], ids=["telemetry_on", "telemetry_off"])
def telemetry(request):
    """HEAT_TELEMETRY_ENABLED set on both packages' knobs, restored after."""
    sides = [jax_knobs(), server_knobs()]
    saved = [k.HEAT_TELEMETRY_ENABLED for k in sides]
    for k in sides:
        k.HEAT_TELEMETRY_ENABLED = request.param
    yield request.param
    for k, v in zip(sides, saved):
        k.HEAT_TELEMETRY_ENABLED = v


def key(i: int) -> bytes:
    return b"k%014d" % i


def batch_shapes(rng, kind: str, now: int):
    """N_TXNS txns of (reads, writes, snapshot, report): 1-3 reads and 0-2
    writes of hot keys ("point") or of ranges of up to 40 keys ("range"),
    snapshots up to three batches behind, every other txn a reporter."""
    def spans(k):
        out = []
        for _ in range(int(k)):
            a = int(rng.integers(0, KEYS))
            if kind == "point":
                out.append((key(a), key(a) + b"\x00"))
            else:
                out.append((key(a), key(a + 1 + int(rng.integers(0, 40)))))
        return out

    return [(spans(rng.integers(1, 4)), spans(rng.integers(0, 3)),
             int(max(now - rng.integers(0, 3 * VERSIONS_PER_BATCH), 0)),
             bool(i % 2)) for i in range(N_TXNS)]


def txns(mod, shapes):
    return [mod.CommitTransactionRef(
        read_conflict_ranges=[mod.KeyRange(b, e) for b, e in r],
        write_conflict_ranges=[mod.KeyRange(b, e) for b, e in w],
        read_snapshot=s, report_conflicting_keys=rep)
        for r, w, s, rep in shapes]


PLAN = ["point", "range", "point", "range", "range", "point"]


def drive(ref, port, seed: int, telemetry: bool, gated: bool = True,
          sample: int = None) -> int:
    """Both sets over PLAN's batches, compared after each; returns the
    number of CONFLICT verdicts seen.  `gated`: the set's attribution
    follows the knob (the oracles' exact one does not, in both
    packages).  `sample`: at most this many aborts a batch are
    attributed (the supervised sets' device path)."""
    rng = np.random.default_rng(seed)
    now, conflicts = 0, 0
    for kind in PLAN:
        now += VERSIONS_PER_BATCH
        shapes = batch_shapes(rng, kind, now)
        floor = max(now - 4 * VERSIONS_PER_BATCH, 0)
        want, want_ranges = ref.resolve_with_conflicts(txns(jt, shapes), now,
                                                       floor)
        got, got_ranges = port.resolve_with_conflicts(txns(pt, shapes), now,
                                                      floor)
        assert [int(v) for v in got] == [int(v) for v in want], kind
        assert got_ranges == want_ranges, kind
        assert port.last_attribution == ref.last_attribution, kind
        assert port.last_attribution_exact == ref.last_attribution_exact, kind
        n = sum(int(v) == int(pt.CommitResult.CONFLICT) for v in got)
        conflicts += n
        if telemetry or not gated:
            assert len(port.last_attribution) == min(n, sample or n), kind
        else:
            assert port.last_attribution == {} == port.last_attribution_exact
    return conflicts


def test_one_device_attribution_matches_reference(telemetry):
    """TorchConflictSet(device="cpu") against TpuConflictSet: the compact
    and the general path both leave the reference's conservative
    attribution (every read range of each conflicted txn, none exact)."""
    kw = dict(capacity=1 << 12, delta_capacity=1 << 10,
              gc_interval_batches=3)
    ref = TpuConflictSet(0, **kw)
    port = TorchConflictSet(0, device="cpu", **kw)
    assert port.last_attribution == {} == port.last_attribution_exact
    assert drive(ref, port, 11, telemetry) > 0
    if telemetry:
        assert not any(port.last_attribution_exact.values())


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(n_devices=8), make_conflict_mesh(["cpu"] * 8)


def test_sharded_attribution_matches_reference(meshes, telemetry):
    """ShardedTorchConflictSet against ShardedTpuConflictSet (kr=4, q=2)."""
    kw = dict(capacity=1 << 10, delta_capacity=1 << 9,
              gc_interval_batches=3)
    ref = ShardedTpuConflictSet(meshes[0], 0, **kw)
    port = ShardedTorchConflictSet(meshes[1], 0, **kw)
    assert drive(ref, port, 12, telemetry) > 0


def test_oracle_attribution_matches_reference(telemetry):
    """The port's oracle keeps the reference oracle's exact attribution,
    which neither package gates on the knob."""
    ref, port = JaxOracle(0), OracleConflictSet(0)
    assert drive(ref, port, 13, telemetry, gated=False) > 0
    assert all(port.last_attribution_exact.values())


def test_full_conservative_attribution():
    """The whole read set of every CONFLICT verdict, reporter or not; a
    fresh set has no attribution yet."""
    shapes = [([(b"a", b"b"), (b"c", b"d")], [], 0, False),
              ([], [(b"a", b"b")], 0, True), ([(b"e", b"f")], [], 0, True)]
    verdicts = [pt.CommitResult.CONFLICT, pt.CommitResult.CONFLICT,
                pt.CommitResult.COMMITTED]
    assert full_conservative_attribution(verdicts, txns(pt, shapes)) == {
        0: [(b"a", b"b"), (b"c", b"d")]}
    cs = ConflictSet()
    assert cs.last_attribution == {} == cs.last_attribution_exact


# ---------------------------------------------------------------------------
# The factory (conflict/api.py new_conflict_set) and the supervised sets
# ---------------------------------------------------------------------------

SMALL = dict(device="cpu", capacity=1 << 10)


def is_supervised_torch(cs, device_cls=TorchConflictSet):
    return (type(cs) is SupervisedConflictSet
            and type(cs.device) is device_cls
            and cs.device.device.type == "cpu" and not cs.degraded)


def test_factory_torch_is_supervised(monkeypatch):
    """"torch" wraps TorchConflictSet built with the caller's kwargs, and
    is bare with CONFLICT_BACKEND_SUPERVISED off."""
    cs = new_conflict_set("torch", 7, **SMALL)
    assert is_supervised_torch(cs)
    assert cs.device.capacity == 1 << 10 and cs.oldest_version == 7
    monkeypatch.setattr(server_knobs(), "CONFLICT_BACKEND_SUPERVISED", False)
    assert type(new_conflict_set("torch", **SMALL)) is TorchConflictSet


def test_factory_torch_raw_is_bare():
    cs = new_conflict_set("torch-raw", **SMALL)
    assert type(cs) is TorchConflictSet and cs.capacity == 1 << 10


def test_factory_sharded_is_supervised():
    """"sharded" and ShardedTorchConflictSet.supervised both wrap the
    sharded set over the given mesh."""
    mesh = make_conflict_mesh(["cpu"] * 2)
    kw = dict(capacity=1 << 10, delta_capacity=1 << 8)
    cs = new_conflict_set("sharded", mesh=mesh, **kw)
    assert is_supervised_torch(cs, ShardedTorchConflictSet)
    assert cs.device.n_shards == 2
    sup = ShardedTorchConflictSet.supervised(mesh, 5, **kw)
    assert is_supervised_torch(sup, ShardedTorchConflictSet)
    assert sup.oldest_version == sup.device.oldest_version == 5


def test_factory_auto(monkeypatch):
    """"auto": the oracle with no card, the supervised torch set with one
    (its device set asked for the CPU here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert type(new_conflict_set("auto", **SMALL)) is OracleConflictSet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert is_supervised_torch(new_conflict_set("auto", **SMALL))


@pytest.mark.parametrize("backend", ["torch", "sharded", "supervised"])
def test_factory_build_failure_raises(monkeypatch, backend):
    """A device set that cannot be built on a card (a kernel build
    failure, no memory) raises from the factory and from
    ShardedTorchConflictSet.supervised: the supervised set does not begin
    degraded on its CPU mirror."""
    def fail(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(TorchConflictSet, "__init__", fail)
    mesh = make_conflict_mesh(["cpu"] * 2)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        if backend == "torch":
            new_conflict_set("torch", device="cuda")
        elif backend == "sharded":
            new_conflict_set("sharded", mesh=mesh, capacity=1 << 10)
        else:
            ShardedTorchConflictSet.supervised(mesh, capacity=1 << 10)


def test_factory_none_reads_the_knob(monkeypatch):
    knobs = server_knobs()
    assert knobs.CONFLICT_SET_BACKEND == "torch"
    assert is_supervised_torch(new_conflict_set(None, **SMALL))
    monkeypatch.setattr(knobs, "CONFLICT_SET_BACKEND", "torch-raw")
    assert type(new_conflict_set(**SMALL)) is TorchConflictSet
    monkeypatch.setattr(knobs, "CONFLICT_SET_BACKEND", "cpu")
    assert type(new_conflict_set()) is OracleConflictSet
    monkeypatch.setattr(knobs, "CONFLICT_SET_BACKEND", "tpu")
    with pytest.raises(ValueError):
        new_conflict_set()


def test_supervised_attribution_matches_reference(telemetry):
    """The supervised sets of both packages: equal verdicts, reported
    ranges and attribution (exact for a sampled prefix of each batch's
    aborts, through the mirror), with the knob on and off."""
    kw = dict(capacity=1 << 12, delta_capacity=1 << 10,
              gc_interval_batches=3)
    ref = RefSupervised(lambda oldest_version=0:
                        TpuConflictSet(oldest_version, **kw))
    port = SupervisedConflictSet(lambda oldest_version=0: TorchConflictSet(
        oldest_version, device="cpu", **kw))
    sample = server_knobs().CONFLICT_ATTRIBUTION_SAMPLE
    assert drive(ref, port, 14, telemetry, sample=sample) > 0
    assert port.stats == ref.stats
    if telemetry:
        assert port.stats["exact_attribution"] > 0


def test_supervised_sharded_degrade_and_promotion():
    """The supervised sharded set through a degrade and a promotion whose
    replay rebuilds every shard from the mirror: verdicts the oracle's."""
    mesh = make_conflict_mesh(["cpu"] * 2)
    sup = ShardedTorchConflictSet.supervised(
        mesh, monitor=BackendHealthMonitor(reprobe_interval_s=0.0),
        capacity=1 << 10, delta_capacity=1 << 8, gc_interval_batches=3)
    oracle = OracleConflictSet(0)
    rng = np.random.default_rng(15)
    now = 0
    for i, kind in enumerate(PLAN + PLAN):
        now += VERSIONS_PER_BATCH
        if i == 4:
            sup.force_device_error = ["timeout"]
        batch = txns(pt, batch_shapes(rng, kind, now))
        floor = max(now - 4 * VERSIONS_PER_BATCH, 0)
        assert [int(v) for v in sup.resolve(batch, now, floor)] == \
            [int(v) for v in oracle.resolve(batch, now, floor)], i
    st = sup.status()
    assert (st["degrades"], st["promotions"], st["fallback_batches"]) == \
        (1, 1, 1)
    assert st["device_batches"] == 2 * len(PLAN) - 1
    assert is_supervised_torch(sup, ShardedTorchConflictSet)
