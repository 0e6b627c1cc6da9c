"""The port's conflict/fused.py against foundationdb_tpu/conflict/fused.py,
program by program, at state level: the compact point step, the sort-free
delta insert (_point_insert), the delta table and the merge; and the
general step's endpoint placement (one search over the batch) against the
reference's four searches.

States are made with numpy from a seed (sorted unique boundaries with the
all-keys boundary first, versions, MAX / NEG_INF padding) and handed to
both packages; every output array must be equal element for element.  The
cases cover an insert that overflows the delta (the old delta is kept and
the flag set), a sticky flag carried through, a merge that overflows the
base, and the merge's rebase at the int32 wrap edge.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict import fused as jf
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu.ops import digest as jd
from foundationdb_tpu.ops.rangemax import build_sparse_table as jax_table
from foundationdb_tpu_torch.conflict import fused as tf
from foundationdb_tpu_torch.ops.digest import planar_to_rows, rows_to_planar
from foundationdb_tpu_torch.ops.rangemax import NEG_INF

from test_torch_backend import gen_batch, key_matrix

# The shapes of tests/test_torch_backend.py's streams, so that one process
# running both compiles the reference's programs once.
CAP, DCAP = 1 << 12, 1 << 10
N_TXNS = 120
KEYSPACE = 6000


def key_digests(kids) -> np.ndarray:
    return jd.encode_fixed(key_matrix(np.asarray(kids))[:, :15])


def boundaries(rng, n: int, cap: int) -> np.ndarray:
    """All-keys boundary + n distinct point boundaries (begin or end of a
    b"k%014d" key), MAX-padded: planar uint32[8, cap]."""
    kids = rng.choice(KEYSPACE, size=n, replace=False)
    d = key_digests(kids)
    d[7] += rng.integers(0, 2, size=n).astype(np.uint32)   # some ends
    s = np.unique(jd.planar_to_s24(d))
    planar = s.view(np.uint8).reshape(-1, 32).view(">u4").astype(np.uint32).T
    out = jd.max_digest_block(cap)
    out[:, 0] = 0
    out[:, 1:1 + planar.shape[1]] = planar
    return out, 1 + planar.shape[1]


def make_state(seed: int, live_b: int = 600, live_d: int = 100,
               cap: int = CAP, d_cap: int = DCAP, flag: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    bk, size = boundaries(rng, live_b, cap)
    dk, dsize = boundaries(rng, live_d, d_cap)
    # Some delta boundaries repeat base ones (the merge's dedup).
    shared = rng.choice(np.arange(1, dsize), size=min(20, dsize - 1),
                        replace=False)
    cand = bk[:, 1:size][:, rng.choice(size - 1, size=shared.size,
                                       replace=False)]
    merged = np.unique(jd.planar_to_s24(np.concatenate(
        [dk[:, 1:dsize], cand], axis=1)))[:d_cap - 1]
    dk = jd.max_digest_block(d_cap)
    dk[:, 0] = 0
    planar = merged.view(np.uint8).reshape(-1, 32).view(">u4").astype(
        np.uint32).T
    dk[:, 1:1 + planar.shape[1]] = planar
    dsize = 1 + planar.shape[1]
    bv = np.full(cap, NEG_INF, np.int32)
    bv[:size] = rng.integers(0, 4000, size=size)
    dv = np.full(d_cap, NEG_INF, np.int32)
    dv[1:dsize] = rng.integers(4000, 6000, size=dsize - 1)
    dv[1:dsize][rng.random(dsize - 1) < 0.3] = NEG_INF
    return {"bk": bk, "bv": bv, "size": np.int32(size), "dk": dk, "dv": dv,
            "dsize": np.int32(dsize), "flag": np.int32(flag),
            "table": np.asarray(jax_table(jnp.asarray(bv))),
            "dtable": np.asarray(jax_table(jnp.asarray(dv)))}


def to_torch(st: dict) -> dict:
    out = {}
    for k, v in st.items():
        v = np.asarray(v)
        if k in ("bk", "dk"):
            out[k] = torch.from_numpy(planar_to_rows(v))
        else:
            out[k] = torch.from_numpy(np.array(v, np.int32).reshape(
                v.shape or (1,)))
    return out


def to_jax(st: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in st.items()}


def assert_equal(got: torch.Tensor, want, name: str, planar=False):
    got = rows_to_planar(got) if planar else got.numpy()
    want = np.asarray(want)
    assert got.shape == want.reshape(got.shape).shape, name
    np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=name)


# ---------------------------------------------------------------------------
# delta table and merge
# ---------------------------------------------------------------------------

def test_delta_table_step_matches_reference():
    st = make_state(1)
    want = np.asarray(jf.delta_table_step(jnp.asarray(st["dv"])))
    out = torch.zeros(want.shape, dtype=torch.int32)
    got = tf.delta_table_step(torch.from_numpy(st["dv"]), out=out)
    assert got is out
    assert_equal(got, want, "dtable")


def run_merge(st: dict, scalars, cap=CAP, d_cap=DCAP):
    j = to_jax(st)
    want = jf.make_merge_step(cap, d_cap)(
        j["bk"], j["bv"], j["size"], j["dk"], j["dv"], j["dsize"],
        j["flag"], jnp.asarray(np.asarray(scalars, np.int32)))
    t = to_torch(st)
    got = tf.make_merge_step(cap, d_cap)(
        t["bk"], t["bv"], t["table"], t["size"], t["dk"], t["dv"],
        t["dsize"], t["flag"], scalars)
    names = ("bk", "bv", "table", "size", "dk", "dv", "dsize", "flag")
    for name, g, w in zip(names, got, want):
        assert_equal(g, w, f"merge {name}", planar=name in ("bk", "dk"))
    # In place: the returned tensors are the state's own.
    assert all(g is t[n] for n, g in zip(names, got))
    return t


@pytest.mark.parametrize("seed,floor,rebase", [
    (2, 0, 0),            # overlay + dedup only
    (3, 3500, 1500),      # GC below the floor, rebase
    (4, 5000, 4000),      # GC drops most of the base
])
def test_merge_matches_reference(seed, floor, rebase):
    t = run_merge(make_state(seed), (floor, rebase))
    assert int(t["dsize"][0]) == 1 and int(t["flag"][0]) == 0


def test_merge_overflow_sets_sticky_flag():
    """A merged sequence longer than CAP is cut and flags the state; the
    flag given in stays set."""
    st = make_state(5, live_b=CAP - 40, live_d=DCAP - 20)
    t = run_merge(st, (0, 0))
    assert int(t["flag"][0]) == 1 and int(t["size"][0]) == CAP
    st = make_state(6, flag=1)
    assert int(run_merge(st, (0, 0))["flag"][0]) == 1


def test_merge_rebase_wraps_like_the_reference():
    """max(v - rebase, NEG_INF + 1) subtracts before it clamps: a boundary
    that sits just above NEG_INF wraps to a huge version, in the port as
    in the reference (bit for bit)."""
    st = make_state(7)
    st["bv"][0] = NEG_INF + 5
    st["dv"][0] = NEG_INF
    st["table"] = np.asarray(jax_table(jnp.asarray(st["bv"])))
    t = run_merge(st, (-(1 << 31) + 2, 100))
    assert int(t["bv"][0]) == (1 << 31) - 94


# ---------------------------------------------------------------------------
# the sort-free delta insert
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def jax_point_insert(d_cap: int, w_cap: int):
    return jax.jit(lambda dk, dv, ds, uk, ue, wu, wi, now: jf._point_insert(
        dk, dv, ds, uk, ue, wu, wi, now, d_cap, w_cap))


def insert_inputs(rng, u_pad: int, w_pad: int, n_keys: int):
    kids = np.sort(rng.choice(KEYSPACE, size=n_keys, replace=False))
    u_k = jd.max_digest_block(u_pad)
    u_k[:, :n_keys] = key_digests(kids)
    u_e = u_k.copy()
    u_e[7, :n_keys] += 1
    w_uid = rng.integers(0, n_keys, size=w_pad).astype(np.int32)
    w_ins = rng.random(w_pad) < 0.7
    return u_k, u_e, w_uid, w_ins


@pytest.mark.parametrize("n_keys,n_batches", [(30, 4), (100, 3)])
def test_point_insert_chain_matches_reference(n_keys, n_batches):
    """Successive inserts into one delta; with 100 keys a batch a later
    insert overflows, keeps the old delta and sets the flag."""
    rng = np.random.default_rng(n_keys)
    u_pad, w_pad, d_cap = 128, 96, 256
    fresh = tf.make_delta_state(d_cap, "cpu")
    dk, dv, ds = fresh.bk.clone(), fresh.bv.clone(), fresh.size.clone()
    flag = torch.zeros((1,), dtype=torch.int32)
    jk, jv, js = (jnp.asarray(rows_to_planar(dk)), jnp.asarray(dv.numpy()),
                  jnp.int32(1))
    jflag = 0
    fn = jax_point_insert(d_cap, u_pad)
    for b in range(n_batches):
        u_k, u_e, w_uid, w_ins = insert_inputs(rng, u_pad, w_pad, n_keys)
        now = 1000 * (b + 1)
        (jk, jv, js), ovf = fn(jk, jv, js, jnp.asarray(u_k),
                               jnp.asarray(u_e), jnp.asarray(w_uid),
                               jnp.asarray(w_ins), jnp.int32(now))
        jflag |= int(ovf)
        tail = torch.zeros((3,), dtype=torch.int32)
        bsize = torch.tensor([17], dtype=torch.int32)
        tf._point_insert(dk, dv, ds, torch.from_numpy(planar_to_rows(u_k)),
                         torch.from_numpy(planar_to_rows(u_e)),
                         torch.from_numpy(w_uid),
                         torch.from_numpy(w_ins.astype(np.int32)),
                         torch.tensor([now], dtype=torch.int32), flag,
                         bsize=bsize, tail=tail)
        assert_equal(dk, jk, f"dk {b}", planar=True)
        assert_equal(dv, jv, f"dv {b}")
        assert_equal(ds, js, f"dsize {b}")
        assert int(flag[0]) == jflag
        assert tail.tolist() == [jflag, int(js), 17]
    assert jflag == (n_keys == 100)


# ---------------------------------------------------------------------------
# the compact step
# ---------------------------------------------------------------------------

def packed_batch(seed: int, now: int, oldest: int):
    """A config-2-shaped batch (2 point reads + 1 point write per txn) over
    the state's keyspace, packed by the reference's _pack_compact and
    stamped (snapshots, now, oldest) as its _dispatch does; a few
    snapshots sit below the floor (too old)."""
    rng = np.random.default_rng(seed)
    _, jenc, _ = gen_batch(rng, now - 1000, N_TXNS, True)
    d = key_digests(rng.zipf(1.2, size=3 * N_TXNS) % KEYSPACE)
    e = d.copy()
    e[7] += 1
    nr = 2 * N_TXNS
    jenc.r_begin, jenc.w_begin = d[:, :nr], d[:, nr:]
    jenc.r_end, jenc.w_end = e[:, :nr], e[:, nr:]
    jenc.t_snap = rng.integers(oldest - 500, now, size=N_TXNS).astype(
        np.int64)
    packed = TpuConflictSet._pack_compact(jenc)
    meta = packed["meta"]
    meta[packed["snap_off"]:packed["snap_off"] + N_TXNS] = jenc.t_snap
    sc = packed["scalar_off"]
    meta[sc:sc + 2] = (now, oldest)
    return packed


@pytest.mark.parametrize("d_cap,flag,live_d", [
    (DCAP, 0, 100),
    (DCAP, 1, 100),      # sticky flag in
    (DCAP, 0, DCAP - 30),  # the insert overflows: old delta kept
])
def test_compact_step_matches_reference(d_cap, flag, live_d):
    st = make_state(11, live_d=live_d, d_cap=d_cap, flag=flag)
    packed = packed_batch(12, now=7000, oldest=2500)
    shapes = packed["shapes"]
    j = to_jax(st)
    want = jf.make_resolve_step_compact(CAP, d_cap, *shapes)(
        j["bk"], j["bv"], j["table"], j["size"], j["dk"], j["dv"],
        j["dtable"], j["dsize"], j["flag"], jnp.asarray(packed["buf"]))
    t = to_torch(st)
    step = tf.make_resolve_step_compact(CAP, d_cap, *shapes)
    got = step(t["bk"], t["bv"], t["table"], t["size"], t["dk"], t["dv"],
               t["dtable"], t["dsize"], t["flag"],
               torch.from_numpy(packed["buf"].copy()))
    for name, g, w in zip(("dk", "dv", "dsize", "flag", "out"), got, want):
        assert_equal(g, w, f"step {name}", planar=name == "dk")
    codes = got[4].numpy()[:N_TXNS]
    # The batch exercises every verdict.
    assert {0, 1, 2} <= set(codes.tolist())
    tail = got[4].numpy()[shapes[0]:].view(np.int32)
    assert tail[0] == int(got[3][0]) == (1 if flag or live_d > 500 else 0)


# ---------------------------------------------------------------------------
# the general step's endpoint placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [22, 23])
def test_general_step_places_endpoints_in_one_search(seed, monkeypatch):
    """GeneralStep places every endpoint of a range batch (reads' and
    writes', repeating across the two, and the MAX padding) with one
    searchsorted over the whole batch, and hands the fixpoint the spans
    of the reference's four searchsorted_left (fused.py:520-529)."""
    from test_torch_general import general_batch
    st = to_torch(make_state(21))
    packed = general_batch(seed, now=7000, oldest=2500)
    _, r_cap, w_cap = packed["caps"]
    planar = packed["digests"]
    n = planar.shape[1]
    calls, spans = [], {}
    search, fixpoint = tf.searchsorted, tf.interval_fixpoint

    def counted(table, queries, *args, **kw):
        calls.append(queries.shape[0])
        return search(table, queries, *args, **kw)

    def seen(*args, **kw):
        spans.update(zip(("r_pb", "r_pe", "w_pb", "w_pe"),
                         (args[3], args[4], args[7], args[8])))
        return fixpoint(*args, **kw)

    monkeypatch.setattr(tf, "searchsorted", counted)
    monkeypatch.setattr(tf, "interval_fixpoint", seen)
    step = tf.make_resolve_step(CAP, DCAP, *packed["caps"])
    step(st["bk"], st["bv"], st["table"], st["size"], st["dk"], st["dv"],
         st["dtable"], st["dsize"], st["flag"],
         torch.from_numpy(planar_to_rows(planar)),
         torch.from_numpy(packed["meta"].copy()))
    assert calls == [n]
    padded = np.concatenate([planar, jd.max_digest_block(step.u_cap - n)],
                            axis=1)
    universe = jnp.stack(jax.lax.sort([jnp.asarray(padded[lane])
                                       for lane in range(8)], num_keys=8))
    o = 2 * r_cap
    for name, (a, b) in (("r_pb", (0, r_cap)), ("r_pe", (r_cap, o)),
                         ("w_pb", (o, o + w_cap)), ("w_pe", (o + w_cap, n))):
        assert_equal(spans[name], jd.searchsorted_left(
            universe, jnp.asarray(planar[:, a:b])), name)
    s = jd.planar_to_s24(planar)
    assert np.intersect1d(s[:o], s[o:]).size > 1
    assert (planar == 0xFFFFFFFF).all(axis=0).any()
