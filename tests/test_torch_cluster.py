"""The JAX package's simulated cluster with its resolvers on the port.

Two ways in, both at runtime, editing nothing of the JAX package:

  * sets: server/resolver.py builds each resolver's conflict set through
    the JAX package's new_conflict_set; PortSets patches that name to the
    port's factory with backend="torch";
  * roles: PortRoles patches the name Resolver in server/cluster.py and
    server/worker.py with a host (PortResolverHost, in this file only)
    that keeps the simulation's ResolverInterface and its streams, draws
    buggify("resolver.slowBatch") and sleeps as the reference's role does,
    and hands every request to the port's Resolver role
    (foundationdb_tpu_torch/server/resolver.py) over the port's
    supervised set.

Either way the set is a SupervisedConflictSet over TorchConflictSet, on
the CPU here at capacity 2^10 with a 2^8 delta.  Each set the run builds
installs the simulation's event loop into the port's scheduler hook, so
the supervisor's health monitor and the role read virtual time and their
metrics actors sleep on the simulation's reactor.

What they check: CycleTest.toml commits as many Cycle swaps as the
reference's run with its oracle at the same seed; a same-seed double run
of ChaosTest.toml (two resolvers, resolver attrition, recoveries that
build new sets) gives equal unseeds, digests and folds and an empty
nondeterminism audit; no set degrades or falls back; and the slowest port
call of each run costs under a quarter of the simulator's SlowTask
threshold in CPU time and takes under the threshold on the wall clock.
Each failing assertion names its check (check_slowest, the unseed and
digest comparison with the divergence report and each run's SlowTask
events, or check()), and every run records the simulator's SlowTask
events (their Callback and DurationMs) as the tracer logs them.
With the roles on the port, one reactor callback may resolve several
batches (a request and the parked ones it wakes): such a callback is held
under the threshold on the wall clock.
That bound is the point of the last check: the simulator times every
reactor callback on the wall clock and folds a SlowTask event into the
run digest when one passes SLOW_TASK_THRESHOLD_S, so a port call near the
threshold makes a double run diverge once load stretches it; a call that
costs a quarter of it leaves that stretch fourfold room.  The port runs
with one intra-op torch thread here (restored after each test): its plain
route is hundreds of small tensor operations a batch, which a thread pool
only slows down on a shared CPU.

The `cuda` variants run CycleTest.toml once with the port on the card,
each way.
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
from foundationdb_tpu.core import trace as sim_trace  # noqa: E402
from foundationdb_tpu.core.buggify import buggify as sim_buggify  # noqa: E402
from foundationdb_tpu.core.knobs import server_knobs as sim_knobs  # noqa: E402
from foundationdb_tpu.core.profiler import SLOW_TASK_THRESHOLD_S  # noqa: E402
from foundationdb_tpu.rpc.sim import set_simulator  # noqa: E402
from foundationdb_tpu.server import cluster as sim_cluster  # noqa: E402
from foundationdb_tpu.server import resolver as sim_resolver  # noqa: E402
from foundationdb_tpu.server import worker as sim_worker  # noqa: E402
from foundationdb_tpu.server.failure import hold_wait_failure  # noqa: E402
from foundationdb_tpu.server.interfaces import \
    ResolverInterface  # noqa: E402
from foundationdb_tpu.testing import run_simulation  # noqa: E402
from foundationdb_tpu.testing.tester import _divergence_report  # noqa: E402
from foundationdb_tpu_torch import kernels  # noqa: E402
from foundationdb_tpu_torch.conflict import api as port_api  # noqa: E402
from foundationdb_tpu_torch.conflict.supervisor import \
    SupervisedConflictSet  # noqa: E402
from foundationdb_tpu_torch.conflict.torch_backend import \
    TorchConflictSet  # noqa: E402
from foundationdb_tpu_torch.core import scheduler as port_scheduler  # noqa: E402
from foundationdb_tpu_torch.server.resolver import \
    Resolver as PortResolver  # noqa: E402
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
        # The simulator's SlowTask events of this run: (Callback,
        # DurationMs), recorded by the fixture's tracer hook.
        self.slow_tasks = []

    def __call__(self, backend=None, oldest_version=0, **kwargs):
        port_scheduler.set_event_loop(
            sim_scheduler.current_event_loop_or_none())
        cs = port_api.new_conflict_set(
            "torch", oldest_version, device=self.device, capacity=CAPACITY,
            delta_capacity=DELTA_CAPACITY)
        self.track_set(cs)
        return cs

    def track_set(self, cs) -> None:
        """Count and time every resolve_with_conflicts call of `cs`."""
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

    def check(self) -> int:
        """Every set stayed on the device and answered every batch there;
        returns the batches resolved."""
        assert self.sets, "check(): no resolver was built"
        total = 0
        for i, (cs, calls) in enumerate(self.sets):
            st = cs.status()
            assert isinstance(cs, SupervisedConflictSet), \
                f"check(): set {i} is a {type(cs).__name__}"
            assert type(cs.device) is TorchConflictSet, \
                f"check(): set {i} device is a {type(cs.device).__name__}"
            assert cs.device.device.type == self.device, \
                f"check(): set {i} on {cs.device.device}"
            assert st["degraded"] is False, f"check(): set {i} degraded {st}"
            assert (st["degrades"], st["fallback_batches"],
                    st["promotions"]) == (0, 0, 0), \
                f"check(): set {i} left the device {st}"
            assert st["device_batches"] == calls, \
                f"check(): set {i} device batches != {calls} calls {st}"
            total += calls
        return total

    def slow_task_report(self, label: str) -> str:
        """The run's SlowTask events, one line each."""
        lines = [f"  {label} SlowTask events: {len(self.slow_tasks)}"]
        lines += [f"    {cb} {ms} ms" for cb, ms in self.slow_tasks]
        return "\n".join(lines)

    def check_slowest(self) -> None:
        """The slowest call costs under a quarter of the SlowTask
        threshold, and took under the threshold itself (printed: run
        with -s to read it)."""
        report = (self.slowest_s, self.slowest_wall_s)
        print(f"slowest port call: {1e3 * self.slowest_s:.1f} ms of CPU "
              f"time, {1e3 * self.slowest_wall_s:.1f} ms of wall time",
              flush=True)
        assert self.slowest_s < SLOWEST_LIMIT_S, (
            f"check_slowest: slowest port call {1e3 * self.slowest_s:.1f} "
            f"ms of CPU time, limit {1e3 * SLOWEST_LIMIT_S:.1f} ms", report)
        assert self.slowest_wall_s < SLOW_TASK_THRESHOLD_S, (
            f"check_slowest: slowest port call "
            f"{1e3 * self.slowest_wall_s:.1f} ms of wall time, limit "
            f"{1e3 * SLOW_TASK_THRESHOLD_S:.1f} ms", report)


class PortResolverHost:
    """Stands in for server/resolver.py's Resolver: the simulation's
    ResolverInterface and streams, served by the port's role.  Per
    request it does what the reference's _resolve_batch does before the
    port's role takes over: note the arrival time, draw
    buggify("resolver.slowBatch") and sleep 0.02 s when it fires; the
    role's QueueWait runs from that arrival, as the reference's does.  When its process dies, the role's parked
    requests are dropped unanswered, as the reference's cancelled actors
    drop theirs.  Status readers reach the role's state through the
    interface's `role` backref."""

    def __init__(self, roles: "PortRoles", resolver_id: str = "r0",
                 recovery_version=0, backend=None, proxy_ids=None) -> None:
        port_scheduler.set_event_loop(
            sim_scheduler.current_event_loop_or_none())
        self.id = resolver_id
        self.role = PortResolver(
            resolver_id, recovery_version, backend="torch",
            proxy_ids=proxy_ids, device=roles.device, capacity=CAPACITY,
            delta_capacity=DELTA_CAPACITY)
        roles.track(self.role)
        self.interface = ResolverInterface(resolver_id)
        self.interface.role = self

    def __getattr__(self, name):
        return getattr(self.role, name)

    async def _resolve_batch(self, req) -> None:
        t_in = sim_scheduler.now()
        if sim_buggify("resolver.slowBatch"):
            await sim_scheduler.delay(0.02)
        self.role.resolve_batch(req, t_in)

    async def _serve(self) -> None:
        try:
            async for req in self.interface.resolve.queue:
                self._process.spawn(self._resolve_batch(req),
                                    f"{self.id}.resolveBatch")
        finally:
            self.role.drop_parked()

    async def _serve_each(self, stream, serve) -> None:
        async for req in stream.queue:
            serve(req)

    async def _emit_heat(self) -> None:
        while True:
            await sim_scheduler.delay(
                float(sim_knobs().METRICS_EMIT_INTERVAL))
            self.role.emit_heat_once()

    def run(self, process) -> None:
        self._process = process
        iface, role = self.interface, self.role
        for s in iface.streams():
            process.register(s)
        process.spawn(self._serve(), f"{self.id}.serve")
        process.spawn(self._serve_each(iface.metrics, role.serve_metrics),
                      f"{self.id}.resolutionMetrics")
        process.spawn(self._serve_each(iface.split, role.serve_split),
                      f"{self.id}.resolutionSplit")
        process.spawn(self._serve_each(iface.heat, role.serve_heat),
                      f"{self.id}.heatFeed")
        process.spawn(role.metrics.emit_loop(), f"{self.id}.metrics")
        process.spawn(self._emit_heat(), f"{self.id}.heatEmit")
        process.spawn(role.conflict_set.metrics.emit_loop(),
                      f"{self.id}.backendMetrics")
        process.spawn(hold_wait_failure(iface.wait_failure),
                      f"{self.id}.waitFailure")


class PortRoles(PortSets):
    """Stands in for the name Resolver in server/cluster.py and
    server/worker.py: every resolver of a run is a PortResolverHost on
    `device`.  Records each role's set with its resolve count and slowest
    call, as PortSets does, and the slowest resolve_batch call on the
    wall clock (one reactor callback)."""

    def __init__(self, device: str) -> None:
        super().__init__(device)
        self.roles = []
        self.slowest_callback_s = 0.0

    def __call__(self, resolver_id="r0", recovery_version=0, backend=None,
                 proxy_ids=None):
        return PortResolverHost(self, resolver_id, recovery_version,
                                backend, proxy_ids)

    def track(self, role) -> None:
        self.track_set(role.conflict_set)
        batch = role.resolve_batch

        def timed_batch(req, t_in=None):
            t0 = time.perf_counter()
            try:
                return batch(req, t_in)
            finally:
                self.slowest_callback_s = max(self.slowest_callback_s,
                                              time.perf_counter() - t0)

        role.resolve_batch = timed_batch
        self.roles.append(role)

    def check(self) -> int:
        """PortSets.check, and every role answered what its set resolved
        without degrading; returns the batches resolved."""
        total = super().check()
        assert sum(r.resolved_batches for r in self.roles) == total
        for role in self.roles:
            assert role.metrics.counter("TxnResolvedDegraded").value == 0
        assert sum(r.metrics.counter("TxnResolved").value
                   for r in self.roles) > 0
        return total

    def check_slowest(self) -> None:
        super().check_slowest()
        print(f"slowest resolve_batch callback: "
              f"{1e3 * self.slowest_callback_s:.1f} ms of wall time",
              flush=True)
        assert self.slowest_callback_s < SLOW_TASK_THRESHOLD_S, (
            f"check_slowest: slowest resolve_batch callback "
            f"{1e3 * self.slowest_callback_s:.1f} ms of wall time, limit "
            f"{1e3 * SLOW_TASK_THRESHOLD_S:.1f} ms")


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
    """install(device) patches the resolver's factory to a fresh PortSets,
    install(device, roles=True) the resolver role itself to a fresh
    PortRoles, and returns it; one torch thread for the test; the hooks
    removed after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    current = []
    tracer = sim_trace.get_tracer()
    emit = tracer.emit

    def emit_recording(event):
        if event.get("Type") == "SlowTask" and current:
            current[-1].slow_tasks.append((event.get("Callback"),
                                           event.get("DurationMs")))
        emit(event)

    monkeypatch.setattr(tracer, "emit", emit_recording)

    def install(device: str, roles: bool = False) -> PortSets:
        if roles:
            sets = PortRoles(device)
            monkeypatch.setattr(sim_cluster, "Resolver", sets)
            monkeypatch.setattr(sim_worker, "Resolver", sets)
        else:
            sets = PortSets(device)
            monkeypatch.setattr(sim_resolver, "new_conflict_set", sets)
        current.append(sets)
        return sets

    try:
        yield install
    finally:
        torch.set_num_threads(threads)
        port_scheduler.set_event_loop(None)
        set_simulator(None)
        sim_scheduler.set_event_loop(None)


_REFERENCE_SWAPS = {}


def reference_swaps() -> int:
    """Cycle's swaps in CycleTest.toml at SEED with the reference's own
    resolvers over its oracle (run once a process)."""
    if "cycle" not in _REFERENCE_SWAPS:
        want = run_simulation(spec("CycleTest.toml"), SEED)
        _REFERENCE_SWAPS["cycle"] = want.metrics["Cycle"]["swaps"]
    return _REFERENCE_SWAPS["cycle"]


def run_cycle(port_cluster, device: str, roles: bool) -> None:
    """CycleTest.toml with every resolver's set (roles: every resolver
    role) on the port: Cycle's swaps equal the reference's run with its
    oracle at the same seed; on the card, the kernels launched."""
    want = reference_swaps()
    warm(device)
    sets = port_cluster(device, roles)
    kernels.reset_counts()
    got = run_simulation(spec("CycleTest.toml"), SEED)
    assert got.metrics["Cycle"]["swaps"] == want, \
        (got.metrics, want, sets.slow_task_report("run"))
    assert got.metrics["Cycle"]["swaps"] > 0
    assert got.nondeterminism == [], got.nondeterminism
    assert sets.check() > 0
    if device == "cuda":
        assert sum(kernels.LAUNCHES.values()) > 0, kernels.LAUNCHES
    else:
        sets.check_slowest()


def run_chaos_twice(port_cluster, roles: bool) -> None:
    """A same-seed double run of ChaosTest.toml with the resolvers' sets
    (roles: the resolver roles) on the port: equal unseeds, digests and
    folds, an empty audit, and each run's slowest port call within
    check_slowest's bounds."""
    warm("cpu")
    runs = []
    for _ in range(2):
        sets = port_cluster("cpu", roles)
        runs.append((run_simulation(spec("ChaosTest.toml"), SEED), sets))
    (r1, s1), (r2, s2) = runs
    for sets in (s1, s2):
        print(sets.slow_task_report("run"), flush=True)
    assert (r1.unseed, r1.digest, r1.folds) == \
        (r2.unseed, r2.digest, r2.folds), "\n".join((
            "unseed/digest comparison:", _divergence_report(r1, r2),
            s1.slow_task_report("run1"), s2.slow_task_report("run2")))
    assert r1.folds > 0
    assert r1.metrics == r2.metrics, ("metrics comparison", r1.metrics,
                                      r2.metrics)
    assert r1.metrics["Cycle"]["swaps"] > 0
    assert r1.nondeterminism == [] and r2.nondeterminism == []
    for sets in (s1, s2):
        assert sets.check() > 0
        assert len(sets.sets) > 2        # recoveries built new sets
        sets.check_slowest()


def test_cycle_on_the_port(port_cluster):
    """CycleTest.toml with every resolver's set on the port."""
    run_cycle(port_cluster, "cpu", roles=False)


def test_cycle_with_port_roles(port_cluster):
    """CycleTest.toml with every resolver role on the port."""
    run_cycle(port_cluster, "cpu", roles=True)


def test_chaos_double_run_on_the_port(port_cluster):
    """The ChaosTest.toml double run with the resolvers' sets on the
    port."""
    run_chaos_twice(port_cluster, roles=False)


def test_chaos_double_run_with_port_roles(port_cluster):
    """The ChaosTest.toml double run with the resolver roles on the
    port."""
    run_chaos_twice(port_cluster, roles=True)


def test_sched_chaos_with_port_roles(port_cluster):
    """SchedChaosTest.toml once with every resolver role on the port (two
    resolvers, all three SCHED_* stages on, the swizzle nemesis and
    resolver attrition): the JAX package's GRV predictors are fed from
    the port roles' serve_heat through its ratekeeper.  Its workloads
    pass (the SchedRepairLoad audit included), and the reorder, repair
    and deferral counters of the run are non-zero; no role degrades."""
    from foundationdb_tpu.core import coverage
    marks = ("ProxyBatchReordered", "ProxyTxnRepaired",
             "ProxyTxnRepairCommitted", "GrvSchedDeferral")
    before = {m: coverage.hits(m) for m in marks}
    warm("cpu")
    roles = port_cluster("cpu", roles=True)
    got = run_simulation(spec("SchedChaosTest.toml"), SEED)
    assert got.nondeterminism == []
    assert got.metrics["SchedRepairLoad"]["acked"] > 0
    assert got.metrics["Cycle"]["swaps"] > 0
    fired = {m: coverage.hits(m) - before[m] for m in marks}
    assert all(n > 0 for n in fired.values()), fired
    assert roles.check() > 0
    assert sum(r.heat.feed_rows(8) != [] for r in roles.roles) > 0


@pytest.mark.cuda
def test_cycle_on_the_card(port_cluster):
    """CycleTest.toml once with every resolver's set on the port on the
    card: no degrade, every batch on the device, the kernels launched,
    and Cycle's swaps equal to the reference's oracle run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    run_cycle(port_cluster, "cuda", roles=False)


@pytest.mark.cuda
def test_cycle_on_the_card_with_port_roles(port_cluster):
    """CycleTest.toml once with every resolver role on the port on the
    card, as test_cycle_on_the_card checks it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    run_cycle(port_cluster, "cuda", roles=True)


def test_chip_smoke_coordinators_on_cpu():
    """chip_smoke.py's phase 30 at a small size on the CPU, on phase 28's
    cluster after its last kill: the quorum moved to three new
    coordinators (a new epoch through the five states, every old
    coordinator forwarded, every process following), a ReadWrite round,
    the old coordinators and the master killed, a recovery on the new
    quorum alone and a second round; every acknowledged write read back
    from every replica and every epoch's batches equal to a CPU plane's
    replay."""
    import chip_smoke
    from foundationdb_tpu_torch.server.master import RECOVERY_STATES
    with chip_smoke.recovery_cluster(
            device="cpu", keyspace=4_000, rw_actors=64, capacity=CAPACITY,
            delta_capacity=DELTA_CAPACITY) as run:
        rec = run.figures
        coord = chip_smoke.coord_run(run)
    assert rec["epochs"] == [1, 2, 3, 4, 5]
    # The move ends epoch 5; the kills end 6 (a recovery may take more
    # than one epoch to reach accepting_commits).
    assert coord["epochs"][:2] == [5, 6] and coord["epochs"][2] >= 7
    for step in ("commit_to_accepting", "kill_to_accepting"):
        assert coord[step]["states"] == list(RECOVERY_STATES)
        assert coord[step]["to_accepting_virtual_s"] > 0
    assert coord["old"] == ["coord0", "coord1", "coord2"]
    assert [r["committed"] for r in coord["rounds"]] == [64, 64]
    assert coord["readback_rows"] > 0
    assert coord["replayed_batches"] > 0


def test_chip_smoke_simulation_on_cpu():
    """chip_smoke.py's phase 31 on the CPU at test_torch_cluster's
    capacity, without the warm run: CycleTest, the ChaosTest double run
    (equal unseeds, digests, folds and metrics, an empty audit, a fault
    loop fired) and SerializabilityTest on the port's simulator, every
    set's batches equal to an oracle's replay."""
    import chip_smoke
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fig = chip_smoke.simulator_run(
            device="cpu", warm=False, capacity=CAPACITY,
            delta_capacity=DELTA_CAPACITY)
    finally:
        torch.set_num_threads(threads)
    runs = fig["runs"]
    assert [r["spec"] for r in runs] == list(chip_smoke.SIM_RUNS)
    chaos = [r for r in runs if r["spec"] == "ChaosTest"]
    assert chaos[0]["unseed"] == chaos[1]["unseed"]
    assert chaos[0]["digest"] == chaos[1]["digest"]
    assert all(r["batches"] > 0 and r["sets"] > 0 for r in runs)
    assert chaos[0]["metrics"]["ChaosNemesis"]["resolver_kills"] > 0
