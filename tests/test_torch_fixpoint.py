"""The intra-batch fixpoint on deep chains: the port's compact step
(device="cpu", the plain versions) against the reference's
make_resolve_step_compact, and the port's Jacobi round count against the
chain's depth.

A chain batch is built with numpy: txn i reads the key txn i - stride
writes (and one key no txn writes), so the batch holds `stride`
interleaved chains and its verdicts alternate along each.  Jacobi settles
one more txn of a chain per round, so the port must take exactly as many
rounds as the longest chain is deep; the codes and every state array must
equal the reference's (tolerance 0).  These pin the semantics that the
grid-wide CUDA fixpoint (csrc/intra_batch.cu) keeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict import fused as jf
from foundationdb_tpu.conflict.encoded import EncodedBatch as JaxBatch
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu.ops import digest as jd
from foundationdb_tpu_torch.conflict import fused as tf

from test_torch_backend import key_matrix
from test_torch_fused import CAP, DCAP, assert_equal, make_state, to_jax, \
    to_torch

NOW, OLDEST = 7000, 2500


def chain_batch(n_txns: int, stride: int, seed: int):
    """The packed, stamped batch (the reference's _pack_compact) of
    `stride` interleaved chains over n_txns txns.  Snapshots sit above
    every history version of make_state (< 6000) and above the floor, so
    no txn conflicts with history or is too old: every conflict is the
    chain's."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_txns)
    chain = 10_000 + rng.permutation(n_txns)      # the key txn t writes
    before = np.where(t >= stride, chain[np.maximum(t - stride, 0)],
                      20_000 + t)                 # its predecessor's key
    own = 30_000 + t                              # read, never written
    reads = np.stack([before, own], 1).ravel()
    kids = np.concatenate([reads, chain])
    mat = key_matrix(kids)
    begin, end = jd.encode_fixed(mat[:, :15]), jd.encode_fixed(mat)
    nr = 2 * n_txns
    enc = JaxBatch(
        n_txns=n_txns,
        t_snap=rng.integers(6500, NOW, size=n_txns).astype(np.int64),
        t_has_reads=np.ones(n_txns, bool),
        r_txn=np.arange(nr, dtype=np.int32) // 2, r_begin=begin[:, :nr],
        r_end=end[:, :nr], w_txn=t.astype(np.int32), w_begin=begin[:, nr:],
        w_end=end[:, nr:], all_point=True)
    packed = TpuConflictSet._pack_compact(enc)
    meta = packed["meta"]
    meta[packed["snap_off"]:packed["snap_off"] + n_txns] = enc.t_snap
    meta[packed["scalar_off"]:packed["scalar_off"] + 2] = (NOW, OLDEST)
    return packed


@pytest.mark.parametrize("n_txns,stride", [(100, 1), (100, 2), (90, 3),
                                           (2, 1)])
def test_chain_batch_matches_reference_and_rounds_equal_depth(n_txns,
                                                              stride):
    packed = chain_batch(n_txns, stride, seed=n_txns + stride)
    shapes = packed["shapes"]
    st = make_state(11)
    j = to_jax(st)
    want = jf.make_resolve_step_compact(CAP, DCAP, *shapes)(
        j["bk"], j["bv"], j["table"], j["size"], j["dk"], j["dv"],
        j["dtable"], j["dsize"], j["flag"], jnp.asarray(packed["buf"]))
    t = to_torch(st)
    step = tf.make_resolve_step_compact(CAP, DCAP, *shapes)
    buf = torch.from_numpy(packed["buf"].copy())
    # The round count, from the same halves the step composes.
    h = step.history(t["bk"], t["table"], t["dk"], t["dtable"], buf)
    rw = h["rw"]
    conf, rounds = tf.intra_batch_fixpoint(
        rw["hist"], rw["r_txn"], rw["r_live"], rw["r_slot"], rw["w_txn"],
        rw["w_ok"], rw["w_slot"], step.u_pad)
    got = step(t["bk"], t["bv"], t["table"], t["size"], t["dk"], t["dv"],
               t["dtable"], t["dsize"], t["flag"], buf)
    for name, g, w in zip(("dk", "dv", "dsize", "flag", "out"), got, want):
        assert_equal(g, w, f"step {name}", planar=name == "dk")
    for name in ("bk", "bv", "table", "size", "dtable"):
        assert_equal(t[name], j[name], name, planar=name == "bk")
    depth = -(-n_txns // stride)
    assert int(rounds[0]) == depth
    # Along each chain the verdicts alternate: its first txn commits.
    codes = got[4].numpy()[:n_txns]
    committed = ((np.arange(n_txns) // stride) % 2 == 0)
    assert np.array_equal(codes, np.where(committed, 2, 0))
    assert np.array_equal(conf.numpy()[:n_txns], (~committed).astype(
        np.int32))
