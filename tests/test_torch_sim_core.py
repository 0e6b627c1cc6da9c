"""The simulator's core on the port against the JAX package's:
core/rng.py (DeterministicRandom's draws, unseed, RunDigest),
testing/tester.py load_spec, server/sim_fs.py DiskFaultProfile, and the
port's counterparts of tests/test_profiler.py and
tests/test_coverage_markers.py.

  * Every method of DeterministicRandom, called in a seeded order (numpy
    picks the method and its arguments), gives the reference's value,
    and unseed() is equal after every call.
  * RunDigest folds a seeded sequence of tasks and events to the
    reference's value, fold count and checkpoints.
  * load_spec, and the TOML-subset parser behind it, give the
    reference's dict for every file in tests/specs/.
  * One seeded stream of writes, syncs and reads on a file with a fault
    profile (io_error on each kind, a budget, bit rot, latency draws),
    then a power failure over un-synced writes: which operation raised,
    the durable image after each step and the injected counts equal the
    reference's for the same seed (its files are asynchronous and run on
    its simulated loop; the port's are synchronous).
  * SlowTask: a callback past the threshold logs the event and lands in
    the loop's slow_tasks; in sim mode it leaves the run digest as it
    would be without it, so no wall-clock read reaches a fold.

Integer, float and byte values: tolerance 0.
"""

import os
import time

import numpy as np
import pytest

from foundationdb_tpu.core import rng as ref_rng
from foundationdb_tpu.core import scheduler as ref_sched
from foundationdb_tpu.server import sim_fs as ref_fs
from foundationdb_tpu.testing import tester as ref_tester
from foundationdb_tpu_torch.core import coverage
from foundationdb_tpu_torch.core import rng as port_rng
from foundationdb_tpu_torch.core import scheduler as port_sched
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.core.profiler import (SamplingProfiler,
                                                  install_slow_task_detection)
from foundationdb_tpu_torch.core.trace import recent_events
from foundationdb_tpu_torch.server import sim_fs as port_fs
from foundationdb_tpu_torch.testing import tester as port_tester

SPECS = os.path.join(os.path.dirname(__file__), "specs")


@pytest.fixture()
def teardown():
    yield
    port_sched.set_event_loop(None)
    ref_sched.set_event_loop(None)
    port_rng.set_deterministic_random(port_rng.DeterministicRandom(1))
    ref_rng.set_deterministic_random(ref_rng.DeterministicRandom(1))


def _call(r, method: str, a: int, b: int):
    if method == "random01":
        return r.random01()
    if method == "random_int":
        return r.random_int(a, a + b)
    if method == "random_int64":
        return r.random_int64(-a << 20, (b << 33) + 1)
    if method == "random_unique_id":
        return r.random_unique_id()
    if method == "random_alpha_numeric":
        return r.random_alpha_numeric(a % 17)
    if method == "random_bytes":
        return r.random_bytes(a % 23)
    if method == "random_choice":
        return r.random_choice(list(range(b)))
    if method == "random_skewed_uint32":
        return r.random_skewed_uint32(a, a + b + 1)
    if method == "shuffle":
        lst = list(range(b))
        r.shuffle(lst)
        return lst
    if method == "coinflip":
        return r.coinflip()
    raise AssertionError(method)


METHODS = ("random01", "random_int", "random_int64", "random_unique_id",
           "random_alpha_numeric", "random_bytes", "random_choice",
           "random_skewed_uint32", "shuffle", "coinflip")


@pytest.mark.parametrize("seed", [0, 7, 107, 2 ** 40 + 3])
def test_draws_and_unseed_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    port, ref = port_rng.DeterministicRandom(seed), \
        ref_rng.DeterministicRandom(seed)
    assert port.unseed() == ref.unseed()
    for _ in range(400):
        method = METHODS[int(rng.integers(len(METHODS)))]
        a, b = int(rng.integers(0, 1000)), int(rng.integers(1, 50))
        assert _call(port, method, a, b) == _call(ref, method, a, b), method
        assert port.unseed() == ref.unseed(), method


def test_run_digest_and_run_unseed_equal_the_reference(teardown):
    rng = np.random.default_rng(26)
    port, ref = port_rng.reset_run_digest(), ref_rng.reset_run_digest()
    port_rng.set_deterministic_random(port_rng.DeterministicRandom(5))
    ref_rng.set_deterministic_random(ref_rng.DeterministicRandom(5))
    names = ("SlowTask", "TLogSpilled", "MasterRecoveryState", "")
    t = 0.0
    for _ in range(5000):
        t += float(rng.random()) * 1e-3
        if rng.random() < 0.7:
            seq = int(rng.integers(0, 1 << 40))
            port.fold_task(t, seq)
            ref.fold_task(t, seq)
        else:
            name = names[int(rng.integers(len(names)))]
            port.fold_event(name, round(t, 6))
            ref.fold_event(name, round(t, 6))
        assert (port.value, port.folds) == (ref.value, ref.folds)
    assert list(port.checkpoints) == list(ref.checkpoints)
    assert len(port.checkpoints) > 0
    port_rng.deterministic_random().random01()
    ref_rng.deterministic_random().random01()
    assert port_rng.run_unseed() == ref_rng.run_unseed()


@pytest.mark.parametrize("name", sorted(os.listdir(SPECS)))
def test_load_spec_equals_the_reference(name):
    path = os.path.join(SPECS, name)
    text = open(path).read()
    assert port_tester.load_spec(path) == ref_tester.load_spec(path)
    assert port_tester.load_spec(text) == ref_tester.load_spec(text)
    assert port_tester._parse_toml_subset(text) == \
        ref_tester._parse_toml_subset(text)


def _fault_script(seed: int):
    """A seeded stream of (op, argument) over two files."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(120):
        roll = rng.random()
        f = "wal" if rng.random() < 0.6 else "other"
        if roll < 0.5:
            ops.append(("write", f, int(rng.integers(0, 256)),
                        bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                                           dtype=np.uint8))))
        elif roll < 0.7:
            ops.append(("sync", f, 0, b""))
        elif roll < 0.9:
            ops.append(("read", f, int(rng.integers(0, 200)),
                        int(rng.integers(1, 60))))
        else:
            ops.append(("truncate", f, int(rng.integers(0, 300)), b""))
    return ops


def _run_port(seed, profile_kw, ops):
    port_rng.set_deterministic_random(port_rng.DeterministicRandom(seed))
    fs = port_fs.SimFileSystem()
    fs.set_fault_profile("wal", port_fs.DiskFaultProfile(**profile_kw))
    files = {n: fs.open(f"t.{n}") for n in ("wal", "other")}
    log = []
    for op, n, a, b in ops:
        f = files[n]
        try:
            if op == "write":
                f.write(a, b)
                out = None
            elif op == "sync":
                f.sync()
                out = None
            elif op == "read":
                out = f.read(a, b)
            else:
                f.truncate(a)
                out = None
            log.append((op, "ok", out, bytes(f.durable)))
        except FdbError as e:
            log.append((op, e.name, None, bytes(f.durable)))
    fs.power_fail_all()
    return log, {n: (bytes(f.durable), f.io_errors_injected)
                 for n, f in files.items()}, files["wal"].latency_spikes


def _run_ref(seed, profile_kw, ops):
    from foundationdb_tpu.core.error import FdbError as RefError
    ref_rng.set_deterministic_random(ref_rng.DeterministicRandom(seed))
    loop = ref_sched.EventLoop(sim=True)
    ref_sched.set_event_loop(loop)
    fs = ref_fs.SimFileSystem()
    fs.set_fault_profile("wal", ref_fs.DiskFaultProfile(**profile_kw))
    files = {n: fs.open(f"t.{n}") for n in ("wal", "other")}
    log = []

    async def go():
        for op, n, a, b in ops:
            f = files[n]
            try:
                if op == "write":
                    await f.write(a, b)
                    out = None
                elif op == "sync":
                    await f.sync()
                    out = None
                elif op == "read":
                    out = await f.read(a, b)
                else:
                    await f.truncate(a)
                    out = None
                log.append((op, "ok", out, bytes(f.durable)))
            except RefError as e:
                log.append((op, e.name, None, bytes(f.durable)))

    loop.run_until(loop.spawn(go()), timeout=1e6)
    for f in files.values():
        f.power_fail()
    return log, {n: (bytes(f.durable), f.io_errors_injected)
                 for n, f in files.items()}


@pytest.mark.parametrize("profile_kw", [
    dict(io_error_write_p=0.2, io_error_sync_p=0.3, io_error_read_p=0.1),
    dict(io_error_sync_p=1.0, max_io_errors=2),
    dict(bitrot_sync_p=0.7, latency_spike_p=0.4),
    dict(io_error_write_p=0.1, bitrot_sync_p=0.5, latency_spike_p=0.2,
         max_io_errors=3),
], ids=["io_errors", "budget", "bitrot", "mixed"])
def test_disk_faults_equal_the_reference(teardown, profile_kw):
    for seed in (3, 41):
        ops = _fault_script(seed)
        plog, pfinal, spikes = _run_port(seed, profile_kw, ops)
        rlog, rfinal = _run_ref(seed, profile_kw, ops)
        assert plog == rlog
        assert pfinal == rfinal
        assert any(x[1] != "ok" for x in plog) or \
            "bitrot_sync_p" in profile_kw
        if profile_kw.get("latency_spike_p"):
            assert spikes > 0


def test_slow_task_emits_trace_event(teardown):
    """A callback that holds the loop past the threshold logs a SlowTask
    event (the counterpart of tests/test_profiler.py's first case)."""
    loop = port_sched.EventLoop(sim=False)
    port_sched.set_event_loop(loop)
    install_slow_task_detection(loop, threshold_s=0.05)
    before = len(recent_events("SlowTask"))

    async def hog():
        time.sleep(0.12)        # blocks the loop on purpose
        return True

    assert loop.run_until(loop.spawn(hog(), "hog"), timeout=10)
    events = recent_events("SlowTask")
    assert len(events) > before
    assert events[-1]["DurationMs"] >= 100
    assert loop.slow_tasks and loop.slow_tasks[-1][1] >= 100


def test_slow_task_is_not_folded(teardown):
    """In sim mode a SlowTask changes nothing the run digest folds: a run
    whose callback blocks past the threshold ends with the digest of one
    that does not."""
    from foundationdb_tpu_torch.core.trace import TraceEvent

    def one_run(block_s: float):
        digest = port_rng.reset_run_digest()
        loop = port_sched.EventLoop(sim=True)
        port_sched.set_event_loop(loop)
        install_slow_task_detection(loop, threshold_s=0.05)

        async def actor():
            for i in range(5):
                await loop.delay(0.1)
                TraceEvent("Tick").detail("I", i).log()
                if i == 2 and block_s:
                    time.sleep(block_s)
            return True

        assert loop.run_until(loop.spawn(actor(), "actor"), timeout=10)
        port_sched.set_event_loop(None)
        return (digest.value, digest.folds), list(loop.slow_tasks)

    quiet, none = one_run(0.0)
    slow, some = one_run(0.08)
    assert none == [] and len(some) == 1
    assert slow == quiet


def test_sampling_profiler_catches_hot_function():
    prof = SamplingProfiler(interval_s=0.002)
    prof.start()

    def busy_function():
        x = 0
        deadline = time.monotonic() + 0.3
        while time.monotonic() < deadline:
            x += 1
        return x

    busy_function()
    prof.stop()
    assert prof.total > 20
    assert any("busy_function" in stack for _f, stack in prof.report())


def test_coverage_registry_and_hits():
    """The counterpart of tests/test_coverage_markers.py: the registry
    counts hits, lists missing markers, and its ledger names the
    reference's markers before they fire."""
    coverage.register("PortUnitTestOnlyMarker")
    assert not coverage.covered("PortUnitTestOnlyMarker")
    assert "PortUnitTestOnlyMarker" in coverage.missing()
    coverage.test_coverage("PortUnitTestOnlyMarker")
    coverage.test_coverage("PortUnitTestOnlyMarker")
    assert coverage.covered("PortUnitTestOnlyMarker")
    assert coverage.hits("PortUnitTestOnlyMarker") == 2
    assert "PortUnitTestOnlyMarker" not in coverage.missing()
    from foundationdb_tpu.core import coverage as ref_coverage
    ref_names = set(ref_coverage.report()) - {"UnitTestOnlyMarker"}
    assert ref_names <= set(coverage.report())
    for marker in ("ChaosCoordinatorRestart", "ChaosFatalDiskRestart",
                   "StorageIoErrorDeath", "TLogIoErrorDeath",
                   "DiskQueueCrcCaught", "BTreeSlotCrcCaught"):
        assert marker in coverage.report(), marker


def test_buggified_ambient_fault_profile(teardown):
    """With its BUGGIFY site firing, a fresh file gets the ambient
    profile of the knobs (latency spikes only, as the reference's
    from_knobs); an explicit rule still wins."""
    from foundationdb_tpu_torch.core.buggify import (enable_buggify,
                                                     force_buggify,
                                                     unforce_buggify)
    from foundationdb_tpu_torch.core.knobs import server_knobs
    enable_buggify(True)
    force_buggify("sim_fs.fault_profile")
    try:
        fs = port_fs.SimFileSystem()
        fs.set_fault_profile("bad", port_fs.DiskFaultProfile(
            io_error_write_p=1.0))
        ambient = fs.open("ambient.file").faults
        assert ambient == port_fs.DiskFaultProfile(
            latency_spike_p=server_knobs().SIM_DISK_LATENCY_SPIKE_P)
        assert ambient == port_fs.DiskFaultProfile.from_knobs()
        assert fs.open("bad.file").faults.io_error_write_p == 1.0
    finally:
        unforce_buggify()
        enable_buggify(False)
