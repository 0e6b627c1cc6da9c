"""The port's supervision layer held against the reference's, exactly.

Every case of tests/test_conflict_supervisor.py, run on twin supervised
sets: the reference's SupervisedConflictSet over TpuConflictSet (JAX on
the CPU) and the port's over TorchConflictSet(device="cpu"), both at
capacity 2^12.  Each case feeds both the same seeded stream and the same
injected faults (force_device_error, each package's own BUGGIFY sites and
knobs) and asserts, with tolerance 0 (all the data is integers and
enums), that the verdicts are equal batch for batch, equal to the oracle's
where the reference's case says so, and that the `stats` counts and the
status() fields both packages keep are equal key for key.  The three
health-monitor cases read only the port's state machine.

The reference's programs compile on XLA:CPU at first use of a shape; the
streams here keep to the shapes the reference's own tests use.
"""

import time

import pytest

from foundationdb_tpu.conflict.oracle import OracleConflictSet as RefOracle
from foundationdb_tpu.conflict.supervisor import \
    BackendHealthMonitor as RefMonitor
from foundationdb_tpu.conflict.supervisor import \
    SupervisedConflictSet as RefSupervised
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu.core import DeterministicRandom
from foundationdb_tpu.core.buggify import force_buggify as ref_force
from foundationdb_tpu.core.buggify import unforce_buggify as ref_unforce
from foundationdb_tpu.core.knobs import server_knobs as ref_knobs
from foundationdb_tpu.txn import CommitResult, CommitTransactionRef, KeyRange
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.supervisor import (
    BackendHealthMonitor, SupervisedConflictSet, host_digest)
from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
from foundationdb_tpu_torch.core.buggify import (force_buggify as port_force,
                                                 unforce_buggify as
                                                 port_unforce)
from foundationdb_tpu_torch.core.knobs import server_knobs
from foundationdb_tpu_torch.ops.digest import PREFIX_BYTES
from foundationdb_tpu_torch.txn import types as pt

from test_conflict_oracle import make_domain, random_txn

CAPACITY = 1 << 12
# status() fields both packages keep (device_profile is each backend's own).
STATUS_KEYS = ("degraded", "pending", "tripped", "consecutive_failures",
               "recheck_rate")


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


def force_buggify(site):
    """Pin a BUGGIFY site in both packages."""
    ref_force(site)
    port_force(site)


def unforce_buggify(site=None):
    ref_unforce(site)
    port_unforce(site)


def to_port(tr):
    """A reference CommitTransactionRef as the port's."""
    out = pt.CommitTransactionRef(
        read_conflict_ranges=[pt.KeyRange(r.begin, r.end)
                              for r in tr.read_conflict_ranges],
        write_conflict_ranges=[pt.KeyRange(w.begin, w.end)
                               for w in tr.write_conflict_ranges],
        read_snapshot=tr.read_snapshot)
    out.report_conflicting_keys = getattr(tr, "report_conflicting_keys",
                                          False)
    return out


def codes(verdicts):
    return [int(v) for v in verdicts]


def make_tpu(oldest_version=0):
    return TpuConflictSet(oldest_version, capacity=CAPACITY)


def make_torch(oldest_version=0):
    return TorchConflictSet(oldest_version, capacity=CAPACITY, device="cpu")


class Twin:
    """The reference's supervised set and the port's, driven in step.

    ref_make / port_make build each side's device set; monitor is
    "default" (each supervisor's own from the knobs), "never" (a re-probe
    never due) or a dict of BackendHealthMonitor arguments."""

    def __init__(self, monitor="default", ref_make=make_tpu,
                 port_make=make_torch):
        def mon(cls):
            if monitor == "default":
                return None
            if monitor == "never":
                return cls(reprobe_interval_s=1e9)
            return cls(**monitor)

        self.ref = RefSupervised(ref_make, monitor=mon(RefMonitor))
        self.port = SupervisedConflictSet(port_make,
                                          monitor=mon(BackendHealthMonitor))
        self.sides = (self.ref, self.port)

    def resolve(self, batch, now, new_oldest=None):
        """Resolve on both; the verdicts must be equal."""
        want = codes(self.ref.resolve(batch, now, new_oldest))
        got = codes(self.port.resolve([to_port(t) for t in batch], now,
                                      new_oldest))
        assert got == want, f"port diverges from the reference at {now}"
        return got

    def resolve_async(self, batch, now, new_oldest=None):
        return (self.ref.resolve_async(batch, now, new_oldest),
                self.port.resolve_async([to_port(t) for t in batch], now,
                                        new_oldest))

    @staticmethod
    def wait(handles):
        want, got = (codes(h.wait()) for h in handles)
        assert got == want
        return got

    def set_error(self, error):
        for s in self.sides:
            s.force_device_error = list(error) if isinstance(
                error, list) else error

    def revive(self):
        """Clear a sticky death and open the re-probe window, on both."""
        for s in self.sides:
            s._buggify_dead = False
            s.monitor.tripped_at = -1e12

    def check_counts(self):
        """stats and the shared status() fields equal key for key."""
        assert self.port.stats == self.ref.stats
        rs, ps = self.ref.status(), self.port.status()
        assert {k: ps[k] for k in STATUS_KEYS} == \
            {k: rs[k] for k in STATUS_KEYS}
        return ps


def random_stream(seed, n_batches, txns=(1, 10), make=None):
    """(batch, now, new_oldest) triples drawn as the reference's random
    parity tests draw them; make(rng, now) builds one txn."""
    rng = DeterministicRandom(seed)
    domain = make_domain()
    make = make or (lambda r, now: random_txn(r, domain, now, 4_000_000))
    now = 0
    out = []
    for _ in range(n_batches):
        now += rng.random_int(1, 2_000_000)
        batch = [make(rng, now) for _ in range(rng.random_int(*txns))]
        out.append((batch, now,
                    now - 5_000_000 if rng.coinflip() else None))
    return out


# ---------------------------------------------------------------------------
# 1. Parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [71, 72])
def test_supervised_matches_oracle_random(seed):
    twin = Twin()
    oracle = OracleConflictSet(0)
    for batch, now, new_oldest in random_stream(seed, 25):
        got = twin.resolve(batch, now, new_oldest)
        assert got == codes(oracle.resolve([to_port(t) for t in batch], now,
                                           new_oldest))
    st = twin.check_counts()
    assert st["device_batches"] > 0
    assert st["fallback_batches"] == 0


def random_long_key(rng) -> bytes:
    """Keys past the digest prefix, biased toward shared truncated
    prefixes so digest collisions occur (the reference test's)."""
    prefix = b"p%02d" % rng.random_int(0, 2)
    prefix = prefix + b"x" * (PREFIX_BYTES - len(prefix))
    tail_len = rng.random_int(1, 977)
    tail = bytes(rng.random_int(97, 122) for _ in range(min(tail_len, 8)))
    return prefix + tail * ((tail_len // len(tail)) + 1)


def random_long_txn(rng, now, window):
    """Truncated long keys, short keys and ranges straddling the
    truncation boundary (the reference test's)."""
    snap = now - rng.random_int(0, window)
    tr = CommitTransactionRef(read_snapshot=max(snap, 0))

    def key():
        if rng.random_int(0, 3) == 0:
            return b"s%03d" % rng.random_int(0, 30)
        return random_long_key(rng)

    for _ in range(rng.random_int(0, 3)):
        k = key()
        if rng.coinflip():
            tr.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        else:
            e = key()
            if k < e:
                tr.read_conflict_ranges.append(KeyRange(k, e))
    for _ in range(rng.random_int(0, 2)):
        k = key()
        tr.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    return tr


@pytest.mark.parametrize("seed", [81, 82, 83])
def test_long_key_parity_bit_identical(seed):
    """Keys past the digest prefix: the port's verdicts equal the
    reference's and the oracle's, through the exact recheck."""
    twin = Twin()
    oracle = RefOracle(0)
    stream = random_stream(
        seed, 25, txns=(1, 8),
        make=lambda rng, now: random_long_txn(rng, now, 4_000_000))
    for batch, now, new_oldest in stream:
        got = twin.resolve(batch, now, new_oldest)
        assert got == codes(oracle.resolve(batch, now, new_oldest))
    st = twin.check_counts()
    assert st["rechecked_batches"] > 0
    assert st["device_batches"] > 0


def test_digest_collision_commits_exactly():
    """Two truncated keys sharing the whole digest prefix: the
    non-conflicting reader commits, as in the oracle."""
    long_a = b"x" * (PREFIX_BYTES + 7)
    long_b = b"x" * PREFIX_BYTES + b"zzz"
    assert host_digest(long_a) == host_digest(long_b)
    twin = Twin()
    w = CommitTransactionRef(
        write_conflict_ranges=[KeyRange(long_a, long_a + b"\x00")])
    assert twin.resolve([w], 100) == [int(CommitResult.COMMITTED)]
    r_hit = CommitTransactionRef(
        read_snapshot=50,
        read_conflict_ranges=[KeyRange(long_a, long_a + b"\x00")])
    r_collide = CommitTransactionRef(
        read_snapshot=50,
        read_conflict_ranges=[KeyRange(long_b, long_b + b"\x00")])
    assert twin.resolve([r_hit, r_collide], 200) == [
        int(CommitResult.CONFLICT), int(CommitResult.COMMITTED)]
    twin.check_counts()


def test_taint_flags_short_key_reader_near_widened_insert():
    """A truncated write taints its widened digest region; a short-key
    read landing in it is rechecked and commits."""
    twin = Twin()
    long_w = b"x" * PREFIX_BYTES + b"\x00\x01" + b"tail"
    w = CommitTransactionRef(
        write_conflict_ranges=[KeyRange(long_w, long_w + b"\x00")])
    twin.resolve([w], 100)
    assert twin.check_counts()["taint_size"] > 0
    short_r = b"x" * PREFIX_BYTES
    r = CommitTransactionRef(
        read_snapshot=50,
        read_conflict_ranges=[KeyRange(short_r, short_r + b"\x00")])
    assert twin.resolve([r], 200) == [int(CommitResult.COMMITTED)]
    twin.check_counts()


def test_pipelined_async_waits_fold_in_order():
    """Waiting the last handle first folds its predecessors in order; each
    handle's verdicts equal the reference's and a serial oracle's."""
    rng = DeterministicRandom(9)
    domain = make_domain()
    oracle = RefOracle(0)
    twin = Twin()
    now = 0
    handles, batches = [], []
    for _ in range(6):
        now += 1_000_000
        batch = [random_txn(rng, domain, now, 3_000_000) for _ in range(5)]
        handles.append(twin.resolve_async(batch, now, now - 5_000_000))
        batches.append((batch, now))
    last = handles[-1][1].wait()
    for h, (batch, v) in zip(handles, batches):
        assert twin.wait(h) == codes(oracle.resolve(batch, v, v - 5_000_000))
    assert handles[-1][1].wait() is last
    twin.check_counts()


# ---------------------------------------------------------------------------
# 2. Robustness
# ---------------------------------------------------------------------------

def run_chaos_stream(twin, seed, n_batches, on_batch):
    """Identical streams through both sets and the oracle, `on_batch`
    injecting faults; verdicts equal on every batch."""
    rng = DeterministicRandom(seed)
    domain = make_domain()
    oracle = RefOracle(0)
    now = 0
    for i in range(n_batches):
        now += 1_000_000
        on_batch(i)
        batch = [random_txn(rng, domain, now, 4_000_000)
                 for _ in range(rng.random_int(1, 8))]
        got = twin.resolve(batch, now, now - 5_000_000)
        assert got == codes(oracle.resolve(batch, now, now - 5_000_000)), \
            f"divergence at batch {i}"


def test_buggify_backend_death_degrades_and_repromotes():
    """The device is BUGGIFY-killed at batch 8 and revived at 16: one
    degrade, one promotion, equal counts in both packages."""
    twin = Twin(monitor="never")

    def on_batch(i):
        if i == 8:
            force_buggify("conflict.device.dead")
        if i == 9:
            unforce_buggify("conflict.device.dead")
            assert all(s.degraded and s._buggify_dead for s in twin.sides)
        if i == 16:
            twin.revive()

    try:
        run_chaos_stream(twin, 17, 24, on_batch)
    finally:
        unforce_buggify()
    st = twin.check_counts()
    assert st["degrades"] == 1
    assert st["promotions"] == 1
    assert not st["degraded"]
    assert st["fallback_batches"] >= 7
    assert st["device_batches"] >= 16


def test_inflight_batches_survive_death():
    """Batches dispatched when the device dies replay through the mirror
    in dispatch order."""
    rng = DeterministicRandom(23)
    domain = make_domain()
    oracle = RefOracle(0)
    twin = Twin(monitor="never")
    now = 0
    handles, batches = [], []
    for _ in range(5):
        now += 1_000_000
        batch = [random_txn(rng, domain, now, 3_000_000) for _ in range(5)]
        handles.append(twin.resolve_async(batch, now, now - 5_000_000))
        batches.append((batch, now))
    twin.set_error("timeout")
    for h, (batch, v) in zip(handles, batches):
        assert twin.wait(h) == codes(oracle.resolve(batch, v, v - 5_000_000))
    st = twin.check_counts()
    assert st["degraded"]
    assert st["fallback_batches"] == 5


def test_transient_error_retried_with_backoff(knobs):
    """A transient error is retried and the batch lands on the device."""
    knobs.set("CONFLICT_DEVICE_RETRY_BACKOFF_S", 0.0)
    twin = Twin()
    twin.set_error(["operation_failed"])
    w = CommitTransactionRef(write_conflict_ranges=[KeyRange(b"a", b"b")])
    assert twin.resolve([w], 100) == [int(CommitResult.COMMITTED)]
    st = twin.check_counts()
    assert st["retries"] >= 1
    assert not st["degraded"]
    assert st["fallback_batches"] == 0


def test_deadline_guard_degrades_on_stall(knobs):
    """A device whose resolve stalls past CONFLICT_DEVICE_TIMEOUT_S is
    abandoned; the batch resolves through the mirror."""
    knobs.set("CONFLICT_DEVICE_TIMEOUT_S", 0.1)

    def stalling(oracle_cls):
        class StallingDevice(oracle_cls):
            def resolve(self, *a, **kw):
                time.sleep(0.5)
                return super().resolve(*a, **kw)

        return lambda oldest_version=0: StallingDevice(oldest_version)

    twin = Twin(monitor="never", ref_make=stalling(RefOracle),
                port_make=stalling(OracleConflictSet))
    w = CommitTransactionRef(write_conflict_ranges=[KeyRange(b"a", b"b")])
    r = CommitTransactionRef(read_snapshot=50,
                             read_conflict_ranges=[KeyRange(b"a", b"b")])
    assert twin.resolve([w], 100) == [int(CommitResult.COMMITTED)]
    assert all(s.degraded for s in twin.sides)
    assert twin.resolve([r], 200) == [int(CommitResult.CONFLICT)]
    twin.check_counts()


def test_promotion_rebuilds_history_from_mirror():
    """History written before the death and during it is visible to the
    promoted device (the rebuild replays the mirror)."""
    twin = Twin(monitor="never")
    w1 = CommitTransactionRef(write_conflict_ranges=[KeyRange(b"a", b"b")])
    twin.resolve([w1], 100)
    twin.set_error("timeout")
    w2 = CommitTransactionRef(write_conflict_ranges=[KeyRange(b"m", b"n")])
    twin.resolve([w2], 200)
    assert all(s.degraded for s in twin.sides)
    twin.set_error(None)
    twin.revive()
    r1 = CommitTransactionRef(read_snapshot=50,
                              read_conflict_ranges=[KeyRange(b"a", b"b")])
    r2 = CommitTransactionRef(read_snapshot=150,
                              read_conflict_ranges=[KeyRange(b"m", b"n")])
    r3 = CommitTransactionRef(read_snapshot=150,
                              read_conflict_ranges=[KeyRange(b"x", b"y")])
    assert twin.resolve([r1, r2, r3], 300) == [
        int(CommitResult.CONFLICT), int(CommitResult.CONFLICT),
        int(CommitResult.COMMITTED)]
    st = twin.check_counts()
    assert not st["degraded"]
    assert st["promotions"] == 1
    assert isinstance(twin.port.device, TorchConflictSet)


# ---------------------------------------------------------------------------
# 3. Health machinery
# ---------------------------------------------------------------------------

def test_slo_trip_does_not_skip_recheck_of_tripping_batch():
    """The batch that lands the final SLO strike is judged against the
    taint set before the degrade clears it."""
    twin = Twin(monitor=dict(latency_slo_s=1e-9, slo_strikes=2,
                             reprobe_interval_s=1e9))
    long_w = b"x" * PREFIX_BYTES + b"\x00\x01" + b"tail"
    w = CommitTransactionRef(
        write_conflict_ranges=[KeyRange(long_w, long_w + b"\x00")])
    assert twin.resolve([w], 100) == [int(CommitResult.COMMITTED)]
    st = twin.check_counts()
    assert st["taint_size"] > 0 and not st["degraded"]
    short_r = b"x" * PREFIX_BYTES
    r = CommitTransactionRef(
        read_snapshot=50,
        read_conflict_ranges=[KeyRange(short_r, short_r + b"\x00")])
    assert twin.resolve([r], 200) == [int(CommitResult.COMMITTED)]
    assert twin.check_counts()["degraded"]


def monitor_failure_threshold():
    t = [0.0]
    m = BackendHealthMonitor(failure_threshold=3, time_fn=lambda: t[0])
    m.record_failure()
    m.record_failure()
    assert not m.tripped
    m.record_success(0.01)                  # success resets the streak
    m.record_failure()
    m.record_failure()
    assert not m.tripped
    m.record_failure()
    assert m.tripped


def monitor_latency_slo_strikes():
    m = BackendHealthMonitor(latency_slo_s=0.1, slo_strikes=3,
                             time_fn=lambda: 0.0)
    for _ in range(2):
        m.record_success(0.5)
    assert not m.tripped
    m.record_success(0.01)                  # a fast batch resets strikes
    for _ in range(3):
        m.record_success(0.5)
    assert m.tripped


def monitor_reprobe_backoff():
    t = [0.0]
    m = BackendHealthMonitor(reprobe_interval_s=10.0, reprobe_max_s=1000.0,
                             time_fn=lambda: t[0])
    m.trip()
    assert not m.reprobe_due()
    t[0] = 11.0
    assert m.reprobe_due()
    m.record_probe_failure()                # backoff doubles: 20 s now
    t[0] = 25.0
    assert not m.reprobe_due()
    t[0] = 32.0
    assert m.reprobe_due()
    m.reset()
    assert not m.tripped and not m.reprobe_due()


@pytest.mark.parametrize("case", [monitor_failure_threshold,
                                  monitor_latency_slo_strikes,
                                  monitor_reprobe_backoff],
                         ids=["failure_threshold", "latency_slo_strikes",
                              "reprobe_backoff"])
def test_health_monitor(case):
    """The monitor's state machine alone (the port's only)."""
    case()


def test_monitor_clock_follows_an_installed_loop():
    """With a loop installed in the port's scheduler hook the monitor
    reads its time; without one, monotonic wall time."""
    from foundationdb_tpu_torch.core import scheduler

    class Loop:
        def now(self):
            return 1234.5

    m = BackendHealthMonitor()
    scheduler.set_event_loop(Loop())
    try:
        m.trip()
        assert m.tripped_at == 1234.5
    finally:
        scheduler.set_event_loop(None)
    m.record_probe_failure()
    assert abs(m.tripped_at - time.monotonic()) < 60


def test_resolve_with_conflicts_reports_ranges():
    """A reporting reader gets its conflicting ranges on the device path
    and on the mirror after a degrade; attribution equal in both
    packages."""
    twin = Twin(monitor="never")
    for fail_first in (False, True):
        if fail_first:
            twin.set_error("timeout")
        w = CommitTransactionRef(
            write_conflict_ranges=[KeyRange(b"k", b"l")])
        r = CommitTransactionRef(
            read_snapshot=50,
            read_conflict_ranges=[KeyRange(b"k", b"l")])
        r.report_conflicting_keys = True
        base = 1000 if fail_first else 0
        want = twin.ref.resolve_with_conflicts([w, r], base + 100)
        got = twin.port.resolve_with_conflicts([to_port(w), to_port(r)],
                                               base + 100)
        assert codes(got[0]) == codes(want[0]) == [
            int(CommitResult.COMMITTED), int(CommitResult.CONFLICT)]
        assert got[1] == want[1] == {1: [(b"k", b"l")]}
        assert twin.port.last_attribution == twin.ref.last_attribution
        assert twin.port.last_attribution_exact == \
            twin.ref.last_attribution_exact
    twin.check_counts()
