"""The JAX package's simulated cluster with its resolvers on the port.

server/resolver.py builds each resolver's conflict set through the JAX
package's new_conflict_set.  These tests patch that name at runtime (and
edit nothing of the JAX package) to the port's factory with
backend="torch": a SupervisedConflictSet over TorchConflictSet, on the CPU
here at capacity 2^10 with a 2^8 delta.  Each set the run builds installs
the simulation's event loop into the port's scheduler hook, so the
supervisor's health monitor reads virtual time and the set's metrics
actor sleeps on the simulation's reactor.

What they check: CycleTest.toml commits as many Cycle swaps as the
reference's run with its oracle at the same seed; a same-seed double run
of ChaosTest.toml (two resolvers, resolver attrition, recoveries that
build new sets) gives equal unseeds, digests and folds and an empty
nondeterminism audit; no set degrades or falls back; and the slowest port
call of each run costs under a quarter of the simulator's SlowTask
threshold in CPU time and takes under the threshold on the wall clock.
That bound is the point of the last check: the simulator times every
reactor callback on the wall clock and folds a SlowTask event into the
run digest when one passes SLOW_TASK_THRESHOLD_S, so a port call near the
threshold makes a double run diverge once load stretches it; a call that
costs a quarter of it leaves that stretch fourfold room.  The port runs
with one intra-op torch thread here (restored after each test): its plain
route is hundreds of small tensor operations a batch, which a thread pool
only slows down on a shared CPU.

The `cuda` variant runs CycleTest.toml once with the port on the card.
That machine has no jax; the simulator is host code that reaches the JAX
package's jax-importing ops/digest.py only for two constants (through
conflict/supervisor.py), which stand in for it there.
"""

import os
import sys
import time
import types

import pytest
import torch

try:
    import jax  # noqa: F401
except ImportError:
    import foundationdb_tpu.ops

    _digest = types.ModuleType("foundationdb_tpu.ops.digest")
    _digest.PREFIX_BYTES, _digest.DIGEST_BYTES = 31, 32
    sys.modules["foundationdb_tpu.ops.digest"] = _digest
    foundationdb_tpu.ops.digest = _digest

from foundationdb_tpu.core import scheduler as sim_scheduler  # noqa: E402
from foundationdb_tpu.core.profiler import SLOW_TASK_THRESHOLD_S  # noqa: E402
from foundationdb_tpu.rpc.sim import set_simulator  # noqa: E402
from foundationdb_tpu.server import resolver as sim_resolver  # noqa: E402
from foundationdb_tpu.testing import run_simulation  # noqa: E402
from foundationdb_tpu.testing.tester import _divergence_report  # noqa: E402
from foundationdb_tpu_torch import kernels  # noqa: E402
from foundationdb_tpu_torch.conflict import api as port_api  # noqa: E402
from foundationdb_tpu_torch.conflict.supervisor import \
    SupervisedConflictSet  # noqa: E402
from foundationdb_tpu_torch.conflict.torch_backend import \
    TorchConflictSet  # noqa: E402
from foundationdb_tpu_torch.core import scheduler as port_scheduler  # noqa: E402
from foundationdb_tpu_torch.txn import types as pt  # noqa: E402

SPECS = os.path.join(os.path.dirname(__file__), "specs")
SEED = 107
CAPACITY = 1 << 10
DELTA_CAPACITY = 1 << 8
SLOWEST_LIMIT_S = SLOW_TASK_THRESHOLD_S / 4


def spec(name: str) -> str:
    with open(os.path.join(SPECS, name)) as f:
        return f.read()


class PortSets:
    """Stands in for server/resolver.py's new_conflict_set: every resolver
    of a run gets the port's supervised set on `device`.  Records each set
    with its resolve count, and the slowest resolve by the CPU time of the
    process's threads (what the port costs: the supervisor's lanes do the
    work while the reactor waits) and by the wall clock (what the
    SlowTask detector reads, stretched by whatever else the box runs)."""

    def __init__(self, device: str) -> None:
        self.device = device
        self.sets = []
        self.slowest_s = 0.0
        self.slowest_wall_s = 0.0

    def __call__(self, backend=None, oldest_version=0, **kwargs):
        port_scheduler.set_event_loop(
            sim_scheduler.current_event_loop_or_none())
        cs = port_api.new_conflict_set(
            "torch", oldest_version, device=self.device, capacity=CAPACITY,
            delta_capacity=DELTA_CAPACITY)
        entry = [cs, 0]
        resolve = cs.resolve_with_conflicts

        def timed(*args, **kw):
            c0, t0 = time.process_time(), time.perf_counter()
            try:
                return resolve(*args, **kw)
            finally:
                self.slowest_s = max(self.slowest_s,
                                     time.process_time() - c0)
                self.slowest_wall_s = max(self.slowest_wall_s,
                                          time.perf_counter() - t0)
                entry[1] += 1

        cs.resolve_with_conflicts = timed
        self.sets.append(entry)
        return cs

    def check(self) -> int:
        """Every set stayed on the device and answered every batch there;
        returns the batches resolved."""
        assert self.sets, "no resolver was built"
        total = 0
        for cs, calls in self.sets:
            st = cs.status()
            assert isinstance(cs, SupervisedConflictSet)
            assert type(cs.device) is TorchConflictSet
            assert cs.device.device.type == self.device
            assert st["degraded"] is False, st
            assert (st["degrades"], st["fallback_batches"],
                    st["promotions"]) == (0, 0, 0), st
            assert st["device_batches"] == calls, st
            total += calls
        return total

    def check_slowest(self) -> None:
        """The slowest call costs under a quarter of the SlowTask
        threshold, and took under the threshold itself (printed: run
        with -s to read it)."""
        report = (self.slowest_s, self.slowest_wall_s)
        print(f"slowest port call: {1e3 * self.slowest_s:.1f} ms of CPU "
              f"time, {1e3 * self.slowest_wall_s:.1f} ms of wall time",
              flush=True)
        assert self.slowest_s < SLOWEST_LIMIT_S, report
        assert self.slowest_wall_s < SLOW_TASK_THRESHOLD_S, report


def warm(device: str) -> None:
    """One batch through a throwaway set, so no run pays the port's
    first-use cost (and, on the card, the kernels' build)."""
    cs = port_api.new_conflict_set("torch", device=device,
                                   capacity=CAPACITY,
                                   delta_capacity=DELTA_CAPACITY)
    k = b"warm"
    cs.resolve([pt.CommitTransactionRef(
        read_conflict_ranges=[pt.KeyRange(k, k + b"\x00")],
        write_conflict_ranges=[pt.KeyRange(k, k + b"\x00")])], 10)


@pytest.fixture()
def port_cluster(monkeypatch):
    """install(device) patches the resolver's factory to a fresh PortSets
    and returns it; one torch thread for the test; the hooks removed
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def install(device: str) -> PortSets:
        sets = PortSets(device)
        monkeypatch.setattr(sim_resolver, "new_conflict_set", sets)
        return sets

    try:
        yield install
    finally:
        torch.set_num_threads(threads)
        port_scheduler.set_event_loop(None)
        set_simulator(None)
        sim_scheduler.set_event_loop(None)


def test_cycle_on_the_port(port_cluster):
    """CycleTest.toml with every resolver on the port: Cycle's swaps equal
    the reference's run with its oracle at the same seed."""
    want = run_simulation(spec("CycleTest.toml"), SEED)
    warm("cpu")
    sets = port_cluster("cpu")
    got = run_simulation(spec("CycleTest.toml"), SEED)
    assert got.metrics["Cycle"]["swaps"] == want.metrics["Cycle"]["swaps"]
    assert got.metrics["Cycle"]["swaps"] > 0
    assert got.nondeterminism == []
    assert sets.check() > 0
    sets.check_slowest()


def test_chaos_double_run_on_the_port(port_cluster):
    """A same-seed double run of ChaosTest.toml with the resolvers on the
    port: equal unseeds, digests and folds, an empty audit, and each run's
    slowest port call within check_slowest's bounds."""
    warm("cpu")
    runs = []
    for _ in range(2):
        sets = port_cluster("cpu")
        runs.append((run_simulation(spec("ChaosTest.toml"), SEED), sets))
    (r1, s1), (r2, s2) = runs
    assert (r1.unseed, r1.digest, r1.folds) == \
        (r2.unseed, r2.digest, r2.folds), _divergence_report(r1, r2)
    assert r1.folds > 0
    assert r1.metrics == r2.metrics
    assert r1.metrics["Cycle"]["swaps"] > 0
    assert r1.nondeterminism == [] and r2.nondeterminism == []
    for sets in (s1, s2):
        assert sets.check() > 0
        assert len(sets.sets) > 2        # recoveries built new sets
        sets.check_slowest()


@pytest.mark.cuda
def test_cycle_on_the_card(port_cluster):
    """CycleTest.toml once with every resolver on the port on the card:
    no degrade, every batch on the device, the kernels launched, and
    Cycle's swaps equal to the reference's oracle run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    want = run_simulation(spec("CycleTest.toml"), SEED)
    warm("cuda")
    sets = port_cluster("cuda")
    kernels.reset_counts()
    got = run_simulation(spec("CycleTest.toml"), SEED)
    assert got.metrics["Cycle"]["swaps"] == want.metrics["Cycle"]["swaps"]
    assert sets.check() > 0
    assert sum(kernels.LAUNCHES.values()) > 0, kernels.LAUNCHES
