"""The general interval path of the port against the JAX package.

* make_resolve_step (conflict/fused.py) against foundationdb_tpu's
  make_resolve_step: the delta state, the sticky flag and the verdict
  buffer after one step, from the same seeded state and the same packed
  batch (with a flag in, and with a delta that overflows).
* TorchConflictSet(device="cpu") against TpuConflictSet on streams that
  mix compact point batches, range batches, keys over 31 bytes and point
  batches the compact layout rejects, crossing merges, a delta growth and
  clear(); codes and every state array are compared after each batch, and
  codes against the oracle wherever keys are at most 31 bytes (for longer
  keys the digest rounds range ends up, and both backends are
  conservative there).  A base overflow raises in both, at the same batch.

Every batch keeps t_cap = r_cap = w_cap = 256, so XLA compiles each
reference program once per delta capacity.  Integer data: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu import txn as jt
from foundationdb_tpu.conflict import fused as jf
from foundationdb_tpu.conflict.encoded import EncodedBatch as JaxBatch
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu.core.error import FdbError as JaxError
from foundationdb_tpu_torch.conflict import fused as tf
from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
from foundationdb_tpu_torch.core.error import FdbError
from foundationdb_tpu_torch.ops.digest import planar_to_rows
from foundationdb_tpu_torch.txn import types as pt

from test_torch_backend import assert_same_state, gen_batch
from test_torch_fused import CAP, DCAP, assert_equal, make_state, to_jax, \
    to_torch

VERSIONS_PER_BATCH = 1000
WINDOW = 5 * VERSIONS_PER_BATCH
KEYS = 400


def key(i: int, long: bool = False, tail: int = 0) -> bytes:
    """b"k%014d" (15 bytes); long keys put the id first and run to 40
    bytes, so their 31-byte digest prefixes still tell ids apart, except
    for keys of one id that differ only in `tail`."""
    if long:
        return b"%06d" % i + b"y" * 28 + b"%06d" % tail
    return b"k%014d" % i


def range_shapes(rng, n: int, prev: int, floor: int, kind: str):
    """Per txn (reads, writes, snapshot) as byte ranges.  kind: "range"
    (range and point reads and writes), "long" (the same over 40-byte
    keys) or "adjacent" (point writes of k and k + b"\\x00", which the
    compact layout rejects)."""
    out = []
    lng = kind == "long"
    adj = int(rng.integers(0, KEYS))
    for t in range(n):
        reads, writes = [], []
        for _ in range(int(rng.integers(0, 3))):
            a = int(rng.integers(0, KEYS))
            if kind == "adjacent" or rng.random() < 0.5:
                k = key(a, lng, int(rng.integers(0, 3)))
                reads.append((k, k + b"\x00"))
            else:
                reads.append((key(a, lng), key(a + int(rng.integers(1, 12)),
                                               lng)))
        for _ in range(int(rng.integers(0, 2)) + (kind == "adjacent")):
            a = int(rng.integers(0, KEYS))
            if kind == "adjacent":
                # Txns 0 and 1 write k and k + b"\x00"; all else points.
                k = key(adj) + b"\x00" if t == 1 else key(adj if t == 0
                                                          else a)
                writes.append((k, k + b"\x00"))
            elif rng.random() < 0.4:
                writes.append((key(a, lng), key(a + int(rng.integers(1, 8)),
                                                lng)))
            else:
                k = key(a, lng, int(rng.integers(0, 3)))
                writes.append((k, k + b"\x00"))
        snap = int(max(prev - rng.integers(0, 2 * VERSIONS_PER_BATCH), 0))
        if rng.random() < 0.05:
            snap = max(floor - 1, 0)             # too old
        out.append((reads, writes, snap))
    return out


def txns_of(shapes, mod):
    return [mod.CommitTransactionRef(
        read_conflict_ranges=[mod.KeyRange(b, e) for b, e in r],
        write_conflict_ranges=[mod.KeyRange(b, e) for b, e in w],
        read_snapshot=s) for r, w, s in shapes]


def batches_of(shapes):
    """(port EncodedBatch, reference EncodedBatch, port txn objects)."""
    port = txns_of(shapes, pt)
    enc = EncodedBatch.from_transactions(port)
    ref = JaxBatch.from_transactions(txns_of(shapes, jt))
    return enc, ref, port


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def general_batch(seed: int, now: int, oldest: int):
    """A range batch packed by the reference's _pack and stamped as its
    _dispatch does."""
    rng = np.random.default_rng(seed)
    shapes = range_shapes(rng, 120, now - 1000, oldest, "range")
    _, ref, _ = batches_of(shapes)
    packed = TpuConflictSet(0, capacity=CAP, delta_capacity=DCAP)._pack(ref)
    meta = packed["meta"]
    n = ref.n_txns
    meta[packed["snap_off"]:packed["snap_off"] + n] = ref.t_snap
    sc = packed["scalar_off"]
    meta[sc:sc + 2] = (now, oldest)
    return packed


@pytest.mark.parametrize("flag,live_d", [(0, 100), (1, 100), (0, DCAP - 30)])
def test_resolve_step_matches_reference(flag, live_d):
    st = make_state(21, live_d=live_d, flag=flag)
    packed = general_batch(22, now=7000, oldest=2500)
    caps = packed["caps"]
    j = to_jax(st)
    want = jf.make_resolve_step(CAP, DCAP, *caps)(
        j["bk"], j["bv"], j["table"], j["size"], j["dk"], j["dv"],
        j["dtable"], j["dsize"], j["flag"], jnp.asarray(packed["digests"]),
        jnp.asarray(packed["meta"]))
    t = to_torch(st)
    rounds = torch.zeros((1,), dtype=torch.int32)
    got = tf.make_resolve_step(CAP, DCAP, *caps)(
        t["bk"], t["bv"], t["table"], t["size"], t["dk"], t["dv"],
        t["dtable"], t["dsize"], t["flag"],
        torch.from_numpy(planar_to_rows(packed["digests"])),
        torch.from_numpy(packed["meta"].copy()), rounds_acc=rounds)
    for name, g, w in zip(("dk", "dv", "dsize", "flag", "out"), got, want):
        assert_equal(g, w, f"step {name}", planar=name == "dk")
    codes = got[4].numpy()[:120]
    assert {0, 1, 2} <= set(codes.tolist())
    assert int(rounds[0]) >= 2
    tail = got[4].numpy()[caps[0]:].view(np.int32)
    assert tail[0] == int(got[3][0]) == (1 if flag or live_d > 500 else 0)


def test_pack_general_matches_reference():
    """The general layout carries the reference's digests (as rows) and
    its metadata block, with the same offsets and caps."""
    rng = np.random.default_rng(23)
    enc, ref, _ = batches_of(range_shapes(rng, 150, 5000, 0, "range"))
    got = TorchConflictSet._pack(enc)
    want = TpuConflictSet(0, capacity=CAP)._pack(ref)
    assert not got["compact"] and not want["compact"]
    n_rows = want["digests"].shape[1]
    rows = got["buf"][:32 * n_rows].view(np.int32).reshape(n_rows, 8)
    np.testing.assert_array_equal(rows, planar_to_rows(want["digests"]))
    np.testing.assert_array_equal(got["meta"], want["meta"])
    for k in ("snap_off", "scalar_off", "nw", "caps"):
        assert got[k] == want[k], k


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

def run_mixed(seed: int, plan, capacity=CAP, delta_capacity=DCAP,
              gc_interval=3):
    """Drive both backends and the port's oracle over `plan`, a list of
    "point", "range", "long", "adjacent", "big" (a range batch of 256
    writers) or "clear"; compare after every batch."""
    rng = np.random.default_rng(seed)
    kw = dict(capacity=capacity, delta_capacity=delta_capacity,
              gc_interval_batches=gc_interval)
    ref = TpuConflictSet(0, **kw)
    port = TorchConflictSet(0, device="cpu", **kw)
    oracle = OracleConflictSet(0)
    version = 1000
    for kind in plan:
        if kind == "clear":
            for cs in (ref, port, oracle):
                cs.clear(version)
            assert_same_state(ref, port)
            continue
        prev, version = version, version + VERSIONS_PER_BATCH
        floor = max(version - WINDOW, 0)
        if kind == "point":
            enc, jenc, txns = gen_batch(rng, prev, 120, True)
        else:
            n = 256 if kind == "big" else 120
            shapes = range_shapes(rng, n, prev, floor,
                                  "range" if kind == "big" else kind)
            if kind == "big":
                shapes = [(r, w or [(key(i), key(i) + b"\x00")], s)
                          for i, (r, w, s) in enumerate(shapes)]
            enc, jenc, txns = batches_of(shapes)
        want = ref.resolve_encoded_async(jenc, version, floor).wait_codes()
        got = port.resolve_encoded_async(enc, version, floor).wait_codes()
        np.testing.assert_array_equal(got, want, err_msg=kind)
        if kind != "long":
            verdicts = oracle.resolve(txns, version, floor)
            np.testing.assert_array_equal(got, [int(v) for v in verdicts],
                                          err_msg=kind)
        else:
            oracle.resolve(txns, version, floor)
        assert_same_state(ref, port)
    return ref, port


def test_mixed_stream_matches_reference_and_oracle():
    plan = (["range", "point", "adjacent", "range", "long", "point",
             "range", "clear", "range", "adjacent", "point", "range"])
    ref, port = run_mixed(31, plan)
    assert port.profile["general_batches"] == 8
    assert port.profile["compact_batches"] == 3
    assert port.profile["merges"] == ref.profile["merges"] >= 2
    assert port.version_base > 0
    assert int(port.jacobi_rounds[0]) >= 9


def test_long_keys_are_conservative_like_the_reference():
    """Over 40-byte keys the port equals TpuConflictSet, which may abort
    where the oracle commits, never the other way round."""
    _, port = run_mixed(32, ["long"] * 4)
    assert port.profile["general_batches"] == 4


def test_general_batches_grow_the_delta(monkeypatch):
    """Batches of 256 range writers need 514 delta slots: with a 256-slot
    delta both backends grow the delta to 1024, shrink it back at the next
    merge and grow it again, in step (the state is compared after every
    batch)."""
    caps = []
    new_delta = TorchConflictSet._new_delta

    def spy(self):
        new_delta(self)
        caps.append(self.d_cap)

    monkeypatch.setattr(TorchConflictSet, "_new_delta", spy)
    run_mixed(33, ["big"] * 4, delta_capacity=256)
    assert caps[:4] == [256, 1024, 256, 1024]


def test_base_overflow_raises_like_the_reference():
    """A base too small for the merged window sets the sticky flag: both
    backends raise at the same batch, with equal state."""
    kw = dict(capacity=CAP, delta_capacity=DCAP, gc_interval_batches=1)
    ref, port = TpuConflictSet(0, **kw), TorchConflictSet(0, device="cpu",
                                                          **kw)
    version, raised = 1000, []
    for b in range(10):
        version += VERSIONS_PER_BATCH
        # 256 disjoint ranges: 512 new boundaries per batch, none GC'd.
        shapes = [([], [(key(1000 * b + 2 * i), key(1000 * b + 2 * i + 1))],
                   version - 1) for i in range(256)]
        enc, jenc, _ = batches_of(shapes)
        outcome = []
        for cs, batch, exc in ((ref, jenc, JaxError), (port, enc, FdbError)):
            try:
                cs.resolve_encoded_async(batch, version, 0).wait_codes()
                outcome.append(False)
            except exc:
                outcome.append(True)
        assert outcome[0] == outcome[1]
        raised.append(outcome[0])
        assert_same_state(ref, port)
    assert any(raised)
