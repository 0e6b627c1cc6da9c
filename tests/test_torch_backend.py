"""TorchConflictSet (device="cpu", the plain-torch versions) against the JAX
TpuConflictSet and the CPU oracle, at state level.

Both backends resolve the same seeded point-key streams (the bench's
config-2 shape at a small size: 15-byte b"k%014d" keys, 2 reads + 1 write
per txn) and after EVERY batch the verdict codes and every device state
array must be equal element for element.  The streams cross merges,
rebases, _grow_delta (and its shrink back) and clear().  Every batch keeps
the same padded shapes (t_cap = r_pad = w_pad = u_pad = 256, lw = 16), so
XLA compiles the reference's step and merge once per process.
"""

import numpy as np
import pytest

from foundationdb_tpu.conflict.encoded import EncodedBatch as JaxBatch
from foundationdb_tpu.conflict.oracle import OracleConflictSet
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu.txn.types import CommitTransactionRef, KeyRange
from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
from foundationdb_tpu_torch.conflict.oracle import \
    OracleConflictSet as PortOracle
from foundationdb_tpu_torch.conflict.torch_backend import (
    TorchConflictSet, state_from_numpy, state_to_numpy)
from foundationdb_tpu_torch.ops.digest import encode_fixed

CAP = 1 << 12
DCAP = 1 << 10
VERSIONS_PER_BATCH = 1000
WINDOW = 5 * VERSIONS_PER_BATCH
STATE_KEYS = ("bk", "bv", "table", "size", "dk", "dv", "dtable", "dsize",
              "flag")


def key_matrix(kids: np.ndarray) -> np.ndarray:
    """b"k%014d" % kid as rows of a uint8[N, 16] matrix (last byte 0)."""
    mat = np.empty((kids.size, 16), dtype=np.uint8)
    mat[:, 0] = ord("k")
    mat[:, 15] = 0
    x = kids.astype(np.int64).copy()
    for d in range(14):
        mat[:, 14 - d] = 48 + x % 10
        x //= 10
    return mat


def gen_batch(rng, prev: int, n_txns: int, high: bool, reads: int = 2):
    """One batch: (port EncodedBatch, reference EncodedBatch, txn objects).
    high=True: zipf(1.2) keys over 1M (the bench's contended regime);
    else uniform over 100M."""
    n = n_txns * (reads + 1)
    if high:
        kids = rng.zipf(1.2, size=n) % 1_000_000
    else:
        kids = rng.integers(0, 100_000_000, size=n)
    mat = key_matrix(kids)
    snaps = np.maximum(prev - rng.integers(0, 2 * VERSIONS_PER_BATCH,
                                           size=n_txns), 0)
    nr = n_txns * reads
    begin = encode_fixed(mat[:, :15])
    end = encode_fixed(mat)
    cols = dict(
        n_txns=n_txns, t_snap=snaps.astype(np.int64),
        t_has_reads=np.full((n_txns,), reads > 0),
        r_txn=np.arange(nr, dtype=np.int32) // max(reads, 1),
        r_begin=begin[:, :nr], r_end=end[:, :nr],
        w_txn=np.arange(n_txns, dtype=np.int32),
        w_begin=begin[:, nr:], w_end=end[:, nr:], all_point=True)
    keys = [bytes(row[:15]) for row in mat]
    txns = []
    for t in range(n_txns):
        rk = keys[t * reads:(t + 1) * reads]
        wk = keys[nr + t]
        txns.append(CommitTransactionRef(
            read_conflict_ranges=[KeyRange(k, k + b"\x00") for k in rk],
            write_conflict_ranges=[KeyRange(wk, wk + b"\x00")],
            read_snapshot=int(snaps[t])))
    return EncodedBatch(**cols), JaxBatch(**cols), txns


def jax_state(cs: TpuConflictSet) -> dict:
    st = {k: np.asarray(getattr(cs, k)) for k in STATE_KEYS}
    st.update(version_base=cs.version_base, oldest_version=cs.oldest_version,
              d_cap=cs.d_cap, delta_bound=cs._delta_bound,
              batches_since_merge=cs._batches_since_merge)
    return st


def assert_same_state(jax_cs: TpuConflictSet, port: TorchConflictSet):
    got = state_to_numpy(port)
    want = jax_state(jax_cs)
    for k in STATE_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("version_base", "oldest_version", "d_cap"):
        assert got[k] == want[k], k
    assert port._delta_bound == jax_cs._delta_bound
    assert port._batches_since_merge == jax_cs._batches_since_merge


def run_stream(seed: int, plan, delta_capacity=DCAP, gc_interval=3):
    """Drive both backends and the port's oracle over `plan`, a list of
    (n_txns, high, reads) or "clear"; compare after every batch."""
    rng = np.random.default_rng(seed)
    ref = TpuConflictSet(0, capacity=CAP, delta_capacity=delta_capacity,
                         gc_interval_batches=gc_interval)
    port = TorchConflictSet(0, capacity=CAP, delta_capacity=delta_capacity,
                            gc_interval_batches=gc_interval, device="cpu")
    oracle = PortOracle(0)
    version = 1000
    resizes = []
    for step in plan:
        if step == "clear":
            ref.clear(version)
            port.clear(version)
            oracle.clear(version)
            assert_same_state(ref, port)
            continue
        n_txns, high, reads = step
        prev = version
        version += VERSIONS_PER_BATCH
        floor = max(version - WINDOW, 0)
        enc, jenc, txns = gen_batch(rng, prev, n_txns, high, reads)
        d_cap_before = port.d_cap
        want = ref.resolve_encoded_async(jenc, version, floor).wait_codes()
        got = port.resolve_encoded_async(enc, version, floor).wait_codes()
        if port.d_cap != d_cap_before:
            resizes.append((d_cap_before, port.d_cap))
        np.testing.assert_array_equal(got, want)
        verdicts = oracle.resolve(txns, version, floor)
        np.testing.assert_array_equal(got, [int(v) for v in verdicts])
        assert_same_state(ref, port)
    return ref, port, resizes


@pytest.mark.parametrize("seed,high", [(1, True), (2, False)])
def test_stream_matches_reference_and_oracle(seed, high):
    """A contended (zipf) and an uncontended (uniform) stream: merges on
    the delta bound and a 3-batch cadence, each rebasing; a clear()
    midway."""
    n = 120 if high else 80
    plan = [(n, high, 2)] * 6 + ["clear"] + [(n, high, 2)] * 4
    ref, port, _ = run_stream(seed, plan)
    assert port.profile["merges"] == ref.profile["merges"] >= 2
    assert port.version_base > 0          # at least one rebase happened


def test_stream_grows_and_shrinks_delta():
    """Batches of 256 writes need 514 delta slots: with a 256-slot delta
    the backend merges, grows the delta to 1024, and shrinks it back at
    the next merge -- in step with the reference."""
    plan = [(256, True, 1)] * 3 + [(80, True, 2)] * 2
    _, port, resizes = run_stream(3, plan, delta_capacity=256)
    assert (256, 1024) in resizes and (1024, 256) in resizes
    assert port.d_cap == 256


def test_pack_compact_byte_identical():
    rng = np.random.default_rng(4)
    for high in (True, False):
        enc, jenc, _ = gen_batch(rng, 5000, 100, high)
        got = TorchConflictSet._pack_compact(enc)
        want = TpuConflictSet._pack_compact(jenc)
        assert got["buf"].tobytes() == want["buf"].tobytes()
        for k in ("snap_off", "scalar_off", "nw", "caps", "shapes"):
            assert got[k] == want[k], k


def test_state_round_trip_mid_stream():
    """Load the reference's mid-stream state into a fresh port backend and
    continue both: they stay equal."""
    rng = np.random.default_rng(5)
    ref = TpuConflictSet(0, capacity=CAP, delta_capacity=DCAP)
    version = 1000
    for _ in range(3):
        prev, version = version, version + VERSIONS_PER_BATCH
        _, jenc, _ = gen_batch(rng, prev, 120, True)
        ref.resolve_encoded_async(jenc, version,
                                  max(version - WINDOW, 0)).wait_codes()
    port = TorchConflictSet(0, capacity=CAP, delta_capacity=DCAP,
                            device="cpu")
    state_from_numpy(port, jax_state(ref))
    assert_same_state(ref, port)
    for _ in range(3):
        prev, version = version, version + VERSIONS_PER_BATCH
        enc, jenc, _ = gen_batch(rng, prev, 120, True)
        floor = max(version - WINDOW, 0)
        want = ref.resolve_encoded_async(jenc, version, floor).wait_codes()
        got = port.resolve_encoded_async(enc, version, floor).wait_codes()
        np.testing.assert_array_equal(got, want)
        assert_same_state(ref, port)


def test_object_api_matches_reference_oracle():
    """resolve() on CommitTransactionRef objects through both packages'
    oracles and the port backend."""
    rng = np.random.default_rng(6)
    port = TorchConflictSet(0, capacity=CAP, delta_capacity=DCAP,
                            device="cpu")
    ref_oracle = OracleConflictSet(0)
    version = 1000
    for _ in range(3):
        prev, version = version, version + VERSIONS_PER_BATCH
        _, _, txns = gen_batch(rng, prev, 60, True)
        from foundationdb_tpu_torch.txn.types import (
            CommitTransactionRef as PortTxn, KeyRange as PortRange)
        port_txns = [PortTxn(
            read_conflict_ranges=[PortRange(r.begin, r.end)
                                  for r in t.read_conflict_ranges],
            write_conflict_ranges=[PortRange(w.begin, w.end)
                                   for w in t.write_conflict_ranges],
            read_snapshot=t.read_snapshot) for t in txns]
        got = port.resolve(port_txns, version, version - WINDOW)
        want = ref_oracle.resolve(txns, version, version - WINDOW)
        assert [int(v) for v in got] == [int(v) for v in want]


def test_varied_point_txns_match_reference():
    """Object-API batches whose txns read 0-2 and write 0-2 hot keys (txns
    without reads are never too old; empty read or write sets shift the
    start offsets _pack_compact ships): verdicts and state against the
    reference, verdicts against both oracles."""
    rng = np.random.default_rng(7)
    kw = dict(capacity=CAP, delta_capacity=DCAP, gc_interval_batches=3)
    ref, port = TpuConflictSet(0, **kw), TorchConflictSet(0, device="cpu",
                                                           **kw)
    ref_oracle, port_oracle = OracleConflictSet(0), PortOracle(0)
    from foundationdb_tpu_torch.txn import types as pt
    version = 1000
    for _ in range(6):
        prev, version = version, version + VERSIONS_PER_BATCH
        floor = max(version - WINDOW, 0)
        shapes = []
        for _t in range(120):
            keys = [b"k%014d" % int(k) for k in rng.integers(0, 150, 4)]
            nr, nw = (int(x) for x in rng.integers(0, 3, 2))
            snap = int(max(prev - rng.integers(0, 2 * VERSIONS_PER_BATCH),
                           0))
            shapes.append((keys[:nr], keys[2:2 + nw], snap))

        def txns(mod):
            return [mod.CommitTransactionRef(
                read_conflict_ranges=[mod.KeyRange(k, k + b"\x00")
                                      for k in r],
                write_conflict_ranges=[mod.KeyRange(k, k + b"\x00")
                                       for k in w],
                read_snapshot=s) for r, w, s in shapes]

        from foundationdb_tpu import txn as jt
        want = [int(v) for v in ref.resolve(txns(jt), version, floor)]
        got = [int(v) for v in port.resolve(txns(pt), version, floor)]
        assert got == want
        assert [int(v) for v in ref_oracle.resolve(txns(jt), version,
                                                   floor)] == want
        assert [int(v) for v in port_oracle.resolve(txns(pt), version,
                                                    floor)] == want
        assert_same_state(ref, port)
    assert port.profile["merges"] >= 1
