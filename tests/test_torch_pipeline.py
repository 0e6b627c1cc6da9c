"""The port's depth-N dispatch pipeline held against the reference's.

The supervisor cases of tests/test_conflict_pipeline.py (its :90-300 and
:377; the two at :313 and :339 test TpuConflictSet itself), run on the
twin supervised sets of test_torch_supervisor.py: the same seeded streams
and injected faults into both packages, verdicts equal batch for batch and
to the serial oracle's, `stats` / status() counts equal key for key,
tolerance 0.
"""

import time

import numpy as np
import pytest

from foundationdb_tpu.conflict.encoded import EncodedBatch as RefEncoded
from foundationdb_tpu.conflict.oracle import OracleConflictSet as RefOracle
from foundationdb_tpu.core import DeterministicRandom
from foundationdb_tpu.txn import CommitResult, CommitTransactionRef, KeyRange
from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.supervisor import (
    BackendHealthMonitor, SupervisedConflictSet)
from foundationdb_tpu_torch.txn import types as pt

from test_conflict_oracle import make_domain, random_txn
from test_torch_supervisor import (Twin, codes, force_buggify, knobs,  # noqa: F401
                                   to_port, unforce_buggify)


def drive_pipelined(twin, seed, n_batches, depth, on_batch=None):
    """Identical streams through both sets (async, up to `depth` handles
    outstanding) and the serial oracle; verdicts equal on every batch, in
    submission order.  Returns the delivered batch count."""
    rng = DeterministicRandom(seed)
    domain = make_domain()
    oracle = RefOracle(0)
    outstanding = []
    now = 0
    delivered = 0

    def deliver(handles, batch, v):
        nonlocal delivered
        want = codes(oracle.resolve(batch, v, v - 5_000_000))
        assert twin.wait(handles) == want, f"divergence at version {v}"
        delivered += 1

    for i in range(n_batches):
        now += 1_000_000
        if on_batch is not None:
            on_batch(i)
        batch = [random_txn(rng, domain, now, 4_000_000)
                 for _ in range(rng.random_int(1, 8))]
        outstanding.append(
            (twin.resolve_async(batch, now, now - 5_000_000), batch, now))
        while len(outstanding) >= depth:
            deliver(*outstanding.pop(0))
    while outstanding:
        deliver(*outstanding.pop(0))
    return delivered


# ---------------------------------------------------------------------------
# 1. Pipeline parity, healthy and under every BUGGIFY site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_parity_bit_identical(knobs, depth):
    knobs.set("CONFLICT_PIPELINE_DEPTH", depth)
    twin = Twin()
    assert drive_pipelined(twin, 100 + depth, 20, depth) == 20
    st = twin.check_counts()
    assert st["device_batches"] == 20
    assert st["fallback_batches"] == 0


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("site", ["timeout", "transient", "dead"])
def test_pipeline_parity_under_buggify(knobs, site, depth):
    """Each conflict.device.* site forced mid-stream at every depth: equal
    verdicts, no batch lost, one degrade and a promotion or more in both
    packages alike."""
    knobs.set("CONFLICT_PIPELINE_DEPTH", depth)
    knobs.set("CONFLICT_DEVICE_RETRY_BACKOFF_S", 0.0)
    site_seed = {"timeout": 1, "transient": 2, "dead": 3}[site]
    twin = Twin(monitor="never")

    def on_batch(i):
        if i == 6:
            force_buggify(f"conflict.device.{site}")
        if i == 10:
            unforce_buggify(f"conflict.device.{site}")
            twin.revive()

    try:
        n = drive_pipelined(twin, 17 * depth + site_seed, 18, depth,
                            on_batch=on_batch)
    finally:
        unforce_buggify()
    assert n == 18
    st = twin.check_counts()
    assert st["device_batches"] + st["fallback_batches"] == 18
    assert st["degrades"] >= 1
    assert st["promotions"] >= 1
    assert st["device_batches"] > 0


# ---------------------------------------------------------------------------
# 2. Mid-pipeline degrade: loss-free, strictly in submission order
# ---------------------------------------------------------------------------

def test_mid_pipeline_degrade_in_order_no_loss(knobs):
    """Six batches in flight at depth 6; the device dies after the first
    fold.  The other five replay through each mirror in submission order,
    equal to the oracle's."""
    knobs.set("CONFLICT_PIPELINE_DEPTH", 6)
    rng = DeterministicRandom(23)
    domain = make_domain()
    twin = Twin(monitor="never")
    oracle = RefOracle(0)

    seen = {id(s): [] for s in twin.sides}
    for s in twin.sides:
        orig = s._mirror.resolve_with_conflicts

        def spy(txns, now, new_oldest_version=None, orig=orig, out=seen[id(s)]):
            out.append(now)
            return orig(txns, now, new_oldest_version)

        s._mirror.resolve_with_conflicts = spy

    handles, batches = [], []
    now = 0
    for _ in range(6):
        now += 1_000_000
        batch = [random_txn(rng, domain, now, 3_000_000) for _ in range(5)]
        handles.append(twin.resolve_async(batch, now, now - 5_000_000))
        batches.append((batch, now))
    b0, v0 = batches[0]
    assert twin.wait(handles[0]) == codes(oracle.resolve(b0, v0,
                                                         v0 - 5_000_000))
    twin.set_error("timeout")
    for h, (batch, v) in list(zip(handles, batches))[1:]:
        assert twin.wait(h) == codes(oracle.resolve(batch, v, v - 5_000_000))
    st = twin.check_counts()
    assert st["degraded"]
    assert st["fallback_batches"] == 5
    ref_seen, port_seen = seen[id(twin.ref)], seen[id(twin.port)]
    assert port_seen == ref_seen == sorted(port_seen)
    assert len(port_seen) == 5


def test_pipelined_dispatch_failure_discards_later_device_verdicts(knobs):
    """A dispatch failure with batches in flight sends every unfolded
    batch, its predecessors included, through the mirror."""
    knobs.set("CONFLICT_PIPELINE_DEPTH", 4)
    twin = Twin(monitor="never")
    w = CommitTransactionRef(write_conflict_ranges=[KeyRange(b"a", b"b")])
    r = CommitTransactionRef(read_snapshot=50,
                             read_conflict_ranges=[KeyRange(b"a", b"b")])
    h0 = twin.resolve_async([w], 100)
    twin.set_error("timeout")
    h1 = twin.resolve_async([r], 200)
    h2 = twin.resolve_async([r], 300)
    assert twin.wait(h0) == [int(CommitResult.COMMITTED)]
    assert twin.wait(h1) == [int(CommitResult.CONFLICT)]
    assert twin.wait(h2) == [int(CommitResult.CONFLICT)]
    st = twin.check_counts()
    assert st["degraded"] and st["fallback_batches"] == 3


# ---------------------------------------------------------------------------
# 3. Depth bound, stall counter, occupancy surfacing
# ---------------------------------------------------------------------------

def test_depth_bound_enforced_and_stalls_counted(knobs):
    knobs.set("CONFLICT_PIPELINE_DEPTH", 2)
    rng = DeterministicRandom(31)
    domain = make_domain()
    twin = Twin()
    now = 0
    handles = []
    for _ in range(5):
        now += 1_000_000
        batch = [random_txn(rng, domain, now, 3_000_000) for _ in range(3)]
        handles.append(twin.resolve_async(batch, now))
        assert all(len(s._pending) <= 2 for s in twin.sides)
    st = twin.check_counts()
    assert st["pipeline_stalls"] == 3
    assert all(h.folded for h in handles[0] + handles[2])
    twin.wait(handles[-1])
    assert all(h.folded for pair in handles for h in pair)
    st = twin.check_counts()
    assert st["pipeline_stalls"] == 3
    for s in twin.sides:
        band = s.status()["latency_statistics"]["InflightDepth"]
        assert band["count"] == 5
        assert band["max"] == 2.0
        assert s.metrics.counters["PipelineStalls"].value == 3


def test_sync_resolve_never_stalls(knobs):
    """The resolver's synchronous path folds every batch at once: no
    stall, an in-flight depth of one."""
    knobs.set("CONFLICT_PIPELINE_DEPTH", 2)
    twin = Twin()
    for i in range(5):
        w = CommitTransactionRef(
            write_conflict_ranges=[KeyRange(b"k%d" % i, b"k%d\x00" % i)])
        assert twin.resolve([w], 100 * (i + 1)) == \
            [int(CommitResult.COMMITTED)]
    assert twin.check_counts()["pipeline_stalls"] == 0
    for s in twin.sides:
        assert s.metrics.histograms["InflightDepth"].max == 1.0


# ---------------------------------------------------------------------------
# 4. Encoded-batch dispatch (the bulk path)
# ---------------------------------------------------------------------------

def test_encoded_dispatch_parity(knobs):
    knobs.set("CONFLICT_PIPELINE_DEPTH", 2)
    twin = Twin()
    oracle = RefOracle(0)
    rng = DeterministicRandom(41)
    now = 0
    outstanding = []

    def deliver(hs, txns, v, bulk):
        want = codes(oracle.resolve(txns, v, v - 5_000_000))
        if bulk:
            for h in hs:
                assert np.array_equal(h.wait_codes(),
                                      np.asarray(want, dtype=np.int8))
        else:
            assert twin.wait(hs) == want

    for _ in range(6):
        now += 1_000_000
        txns = []
        for _t in range(8):
            k = b"p%05d" % rng.random_int(0, 40)
            kr = b"p%05d" % rng.random_int(0, 40)
            txns.append(CommitTransactionRef(
                read_snapshot=max(now - rng.random_int(0, 3_000_000), 0),
                read_conflict_ranges=[KeyRange(kr, kr + b"\x00")],
                write_conflict_ranges=[KeyRange(k, k + b"\x00")]))
        ptxns = [to_port(t) for t in txns]
        hs = (twin.ref.resolve_encoded_async(
                  RefEncoded.from_transactions(txns), now, now - 5_000_000,
                  transactions=txns),
              twin.port.resolve_encoded_async(
                  EncodedBatch.from_transactions(ptxns), now,
                  now - 5_000_000, transactions=ptxns))
        outstanding.append((hs, txns, now))
        if len(outstanding) > 2:
            deliver(*outstanding.pop(0), bulk=True)
    for hs, txd, vd in outstanding:
        deliver(hs, txd, vd, bulk=False)
    assert twin.check_counts()["device_batches"] == 6


def test_encoded_dispatch_requires_transactions():
    sup = Twin().port
    txns = [pt.CommitTransactionRef(
        write_conflict_ranges=[pt.KeyRange(b"a", b"a\x00")])]
    with pytest.raises(TypeError):
        sup.resolve_encoded_async(EncodedBatch.from_transactions(txns), 100)


# ---------------------------------------------------------------------------
# 5. The overlap mechanism itself (the port's pipeline; the reference's own
# test times the reference's)
# ---------------------------------------------------------------------------

def test_pipeline_overlaps_device_link_latency(knobs):
    """Idle latency on the device link (sleeps on dispatch and wait) is
    hidden at depth >= 2; verdicts stay equal to the oracle's."""

    class _LinkHandle:
        def __init__(self, results):
            self._results = results

        def wait(self):
            time.sleep(0.04)                # d2h link occupancy
            return self._results

    class SlowLinkDevice(OracleConflictSet):
        def resolve_async(self, txns, now, new_oldest_version=None):
            time.sleep(0.04)                # h2d link occupancy
            return _LinkHandle(
                super().resolve(txns, now, new_oldest_version))

    def run_at(depth):
        knobs.set("CONFLICT_PIPELINE_DEPTH", depth)
        sup = SupervisedConflictSet(
            lambda oldest_version=0: SlowLinkDevice(oldest_version),
            monitor=BackendHealthMonitor(reprobe_interval_s=1e9))
        w = [pt.CommitTransactionRef(
            write_conflict_ranges=[pt.KeyRange(b"a", b"b")])]
        t0 = time.monotonic()
        handles = [sup.resolve_async(w, 100 * (i + 1)) for i in range(8)]
        for h in handles:
            assert codes(h.wait()) == [int(CommitResult.COMMITTED)]
        dt = time.monotonic() - t0
        assert not sup.degraded
        return dt

    t1 = run_at(1)
    t3 = run_at(3)
    assert t1 > 0.55, f"depth-1 serialization lost? {t1:.3f}s"
    assert t3 < 0.75 * t1, (
        f"no pipeline overlap: depth3 {t3:.3f}s vs depth1 {t1:.3f}s")
