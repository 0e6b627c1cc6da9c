"""_union_ranges and read_write_prep on their edge cases, on the CPU.

_union_ranges (conflict/window.py) merges a batch's write ranges by an
endpoint sweep.  Its plain version is held against the JAX package's
`_union_ranges` on adversarial inputs: one range, no valid range, only
empty ranges (b == e), valid ranges with begin > end (coverage goes below
0), one range covering every other, a chain of touching ranges, and ranges
whose coverage returns to 0 at fixed strides.  `sweep_model` is a numpy
model of the kernel wu_sweep (csrc/window.cu): tiles in ticket order, a
coverage chain and a chain of packed (starts, ends) pairs, each resolved
by a look-back that reads the 64-bit descriptor words as common.cuh
`look_back` does, with each predecessor's inclusive prefix published or
not as a seeded draw decides.  It is held equal to the plain version on
every case at tile sizes 1, 3, 8 and 64, as `search_top` in
test_torch_probe.py mirrors the probes' staging.  The model is checked
against the plain version only, never against k_sweep itself, which runs
at one 1,024-element tile: what tests the kernel are the cuda cases in
test_torch_kernels.py, at the tile edges and at 2^21 endpoints.

read_write_prep (conflict/fused.py) is held against the JAX block it
replaces (foundationdb_tpu/conflict/fused.py:324-371, written out below
with the reference's rank_count) on a batch whose first txn starts after
read 0, so reads before it belong to txn -1 and a live one among them
lands its hit on t_cap - 1, with too-old and padding txns, and n_r / n_w
at the pads and below them.

The cases are built without JAX (the cuda tests in test_torch_kernels.py
reuse them on a machine that has none); JAX is imported inside the tests
that call the reference.  Integer data: tolerance 0.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import fused
from foundationdb_tpu_torch.conflict import window as tw
from foundationdb_tpu_torch.ops import digest
from foundationdb_tpu_torch.ops.sort import sort_rows

W = 64
KEYSPACE = 3000


def keys(ids) -> np.ndarray:
    """b"k%014d" % id as digests, planar uint32[8, n]."""
    ids = np.asarray(ids, dtype=np.int64)
    mat = np.empty((ids.size, 15), dtype=np.uint8)
    mat[:, 0] = ord("k")
    x = ids.copy()
    for d in range(14):
        mat[:, 14 - d] = 48 + x % 10
        x //= 10
    return digest.encode_fixed(mat)


def _ranges(name: str, rng, w: int):
    """(begin ids, end ids, valid) of one named case."""
    a = rng.integers(0, KEYSPACE - 100, size=w)
    s = rng.integers(1, 40, size=w)
    valid = np.ones(w, bool)
    if name == "one":
        a, s = a[:1], s[:1]
        valid = valid[:1]
    elif name == "one_invalid":
        a, s, valid = a[:1], s[:1], ~valid[:1]
    elif name == "all_invalid":
        valid[:] = False
    elif name == "all_empty":
        s[:] = 0
        a[w // 2:] = a[:w - w // 2]          # duplicate empty ranges
    elif name == "begin_gt_end":
        s[::2] = -s[::2]                     # valid, begin > end
    elif name == "cover_all":
        a[0], s[0] = 0, KEYSPACE
    elif name == "touching_chain":
        a, s = 10 * rng.permutation(w), np.full(w, 10)
    elif name == "disjoint":                 # coverage 0 after every pair
        a, s = 10 * rng.permutation(w), np.full(w, 5)
    elif name == "groups_of_4":              # coverage 0 after every 8
        g = np.arange(w) // 4
        a = 100 * g + 10 * (np.arange(w) % 4)
        s = np.full(w, 20)
        perm = rng.permutation(w)
        a, s = a[perm], s[perm]
    elif name == "mixed":
        s[:8] = 0                            # empty
        s[8:12] = -3                         # begin > end
        a[12:16], s[12:16] = a[0:4], s[0:4]  # duplicate ranges
        a[16], s[16] = a[17] + s[17], 5      # touching
        valid = rng.random(w) < 0.8
    else:
        raise ValueError(name)
    return a, a + s, valid


UNION_CASES = ["one", "one_invalid", "all_invalid", "all_empty",
               "begin_gt_end", "cover_all", "touching_chain", "disjoint",
               "groups_of_4", "mixed"]


def union_case(name: str, w: int = W, seed: int = 0):
    """Planar begin / end uint32[8, w'] and a bool validity mask (w' is 1
    for the one-range cases)."""
    b, e, valid = _ranges(name, np.random.default_rng(seed), w)
    return keys(b), keys(e), valid


def rows(planar) -> torch.Tensor:
    return torch.from_numpy(digest.planar_to_rows(np.asarray(planar)))


def sorted_endpoints(b, e, valid):
    """The plain version's sorted sweep input: (s_rows, s_delta)."""
    v = torch.from_numpy(valid)
    w = v.shape[0]
    d = torch.cat([torch.where(v[:, None], rows(b), -1),
                   torch.where(v[:, None], rows(e), -1)])
    tie = torch.cat([torch.zeros(w, dtype=torch.int32),
                     torch.ones(w, dtype=torch.int32)])
    delta = torch.cat([v.to(torch.int32), -v.to(torch.int32)])
    s_rows, s_delta = sort_rows(d, tie=tie, payload=delta, impl="plain")
    return s_rows.numpy(), s_delta.numpy()


# common.cuh's descriptor words: the status from bit SHIFT up.
AGGREGATE, PREFIX = 1, 2
PAIR_SHIFT = 31


def look_back(desc, tile: int, shift: int, visible) -> int:
    """common.cuh look_back: walks back from tile - 1 summing the values
    of aggregates until it meets a prefix (tile 0 always has one); the
    value is masked below `shift` and the sum wraps there, as the kernel's
    V does (shift 32: a wrapping unsigned; 62: a packed pair)."""
    mask = (1 << shift) - 1
    prefix = 0
    for j in range(tile - 1, -1, -1):
        agg_word, incl_word = desc[j]
        word = incl_word if (j == 0 or visible(j)) else agg_word
        prefix = (prefix + (word & mask)) & mask
        if word >> shift == PREFIX:
            break
    return prefix


def sweep_model(s_rows, s_delta, w: int, tile: int, seed: int = 0):
    """wu_sweep's tiling in numpy: (mb, me, m_incl) from the sorted
    endpoints.  A model of the design, held to the plain version only; it
    can drift from the CUDA code without a CPU test failing."""
    rng = np.random.default_rng(seed)
    n2 = s_delta.shape[0]
    tiles = max(1, -(-n2 // tile))
    mb = np.full((w, 8), -1, np.int32)
    me = np.full((w, 8), -1, np.int32)
    m_incl = np.zeros(n2, np.int32)
    cov_desc, pair_desc = [], []
    m32, m62 = (1 << 32) - 1, (1 << 62) - 1

    def visible(j):                          # tile j's prefix published yet
        return bool(rng.integers(0, 2))

    for t in range(tiles):
        d = s_delta[t * tile:(t + 1) * tile].astype(np.int64)
        agg = int(d.sum()) & m32
        c0 = look_back(cov_desc, t, 32, visible) if t else 0
        cov_desc.append(((AGGREGATE << 32) | agg,
                         (PREFIX << 32) | ((c0 + agg) & m32)))
        cov = (c0 + np.cumsum(d)) & m32
        cov = np.where(cov >= 1 << 31, cov - (1 << 32), cov)
        start = (d > 0) & (cov == 1)
        end = (d < 0) & (cov == 0)
        pair = (int(start.sum()) << PAIR_SHIFT) | int(end.sum())
        pre = look_back(pair_desc, t, 62, visible) if t else 0
        pair_desc.append(((AGGREGATE << 62) | pair,
                          (PREFIX << 62) | ((pre + pair) & m62)))
        s_at, e_at = pre >> PAIR_SHIFT, pre & ((1 << PAIR_SHIFT) - 1)
        for k in range(d.shape[0]):
            i = t * tile + k
            if start[k]:
                if s_at < w:                 # past w: dropped
                    mb[s_at] = s_rows[i]
                s_at += 1
            elif end[k]:
                if e_at < w:
                    me[e_at] = s_rows[i]
                e_at += 1
            m_incl[i] = s_at
    return mb, me, m_incl


@pytest.mark.parametrize("name", UNION_CASES)
def test_union_ranges_edge_cases_match_reference(name):
    """The plain _union_ranges against the JAX package's, element for
    element: mb, me (MAX padded) and m_valid = iota(W) < m_incl[-1]."""
    import jax
    import jax.numpy as jnp
    from foundationdb_tpu.conflict import window as jw
    b, e, valid = union_case(name)
    mb, me, m_valid = jax.jit(jw._union_ranges)(
        jnp.asarray(b), jnp.asarray(e), jnp.asarray(valid))
    got_b, got_e, m_incl = tw._union_ranges(
        rows(b), rows(e), torch.from_numpy(valid.astype(np.int32)))
    np.testing.assert_array_equal(digest.rows_to_planar(got_b),
                                  np.asarray(mb))
    np.testing.assert_array_equal(digest.rows_to_planar(got_e),
                                  np.asarray(me))
    w = valid.shape[0]
    assert m_incl.shape == (2 * w,)
    np.testing.assert_array_equal(np.arange(w) < int(m_incl[-1]),
                                  np.asarray(m_valid))
    if name == "begin_gt_end":               # coverage goes below 0
        _, s_delta = sorted_endpoints(b, e, valid)
        assert np.cumsum(s_delta).min() < 0


@pytest.mark.parametrize("tile", [1, 3, 8, 64])
@pytest.mark.parametrize("name", UNION_CASES)
def test_sweep_model_equals_plain(name, tile):
    """wu_sweep's two-chain tiling gives the plain version's mb, me and
    m_incl at every tile size, with predecessors' prefixes published or
    not at random; the disjoint and groups_of_4 cases return coverage to
    0 exactly at tile edges (after every 2 and every 8 endpoints)."""
    b, e, valid = union_case(name)
    w = valid.shape[0]
    s_rows, s_delta = sorted_endpoints(b, e, valid)
    got = sweep_model(s_rows, s_delta, w, tile, seed=tile)
    want = tw._union_ranges(rows(b), rows(e),
                            torch.from_numpy(valid.astype(np.int32)))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
    if name in ("disjoint", "groups_of_4") and tile in (1, 8):
        cov = np.cumsum(s_delta)
        edges = np.arange(tile, s_delta.shape[0], tile)
        assert (cov[edges - 1] == 0).any()


# ---------------------------------------------------------------------------
# read_write_prep
# ---------------------------------------------------------------------------

def rw_case(seed: int = 0, t_cap: int = 64, r_pad: int = 203,
            w_pad: int = 101, u_pad: int = 37, full: bool = True,
            malformed: bool = False) -> dict:
    """read_write_prep's inputs (numpy int32) and the compact step's per-txn
    arrays they come from.  Txn 0 starts at read 3 (or at the pad, if that
    is less), so reads 0-2 belong to
    txn -1; txn 0 has no reads flag (never too old) and those reads hit,
    so hist[t_cap - 1] is set.  A quarter of the txns are too old, the last
    five are padding; n_r / n_w equal the pads when `full`.  `malformed`
    replaces the rank counts with arbitrary ones (out of range, not
    monotone, int32's extremes), which the kernel must treat as the plain
    version does."""
    rng = np.random.default_rng(seed)
    n_t = t_cap - 5
    first = min(3, r_pad)
    r_start = np.sort(rng.integers(first, r_pad + 1,
                                   size=t_cap)).astype(np.int32)
    r_start[0] = first
    w_start = np.sort(rng.integers(0, w_pad + 1, size=t_cap)).astype(np.int32)
    oldest = 1000
    t_snap = rng.integers(oldest - 300, oldest + 700,
                          size=t_cap).astype(np.int32)
    t_flags = np.ones(t_cap, np.uint8)
    t_flags[0] = 0
    t_snap[0] = oldest - 50                  # too old but for its flag
    n_r = r_pad if full else r_pad - 7
    n_w = w_pad if full else w_pad - 3
    scal = np.array([u_pad, n_r, n_w, n_t, oldest + 700, oldest], np.int32)
    r_uid = rng.integers(-3, u_pad + 3, size=r_pad).astype(np.int32)
    r_uid[:first] = 0
    w_uid = rng.integers(-3, u_pad + 3, size=w_pad).astype(np.int32)
    vmax_u = rng.integers(oldest - 200, oldest + 900,
                          size=u_pad).astype(np.int32)
    vmax_u[0] = oldest + 1000                # reads 0-2 hit
    c = {"r_start": r_start, "w_start": w_start, "t_snap": t_snap,
         "t_flags": t_flags, "scal": scal, "r_uid": r_uid, "w_uid": w_uid,
         "vmax_u": vmax_u, "shape": (t_cap, r_pad, w_pad, u_pad)}
    too_old, r_cnt, w_cnt = fused.txn_prep(
        *(torch.from_numpy(c[k]) for k in ("r_start", "w_start", "t_snap",
                                           "t_flags", "scal")),
        r_pad, w_pad)
    c.update(too_old=too_old.numpy(), r_cnt=r_cnt.numpy(),
             w_cnt=w_cnt.numpy())
    if malformed:
        ext = np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0,
                        -1], np.int32)
        for k, n in (("r_cnt", r_pad), ("w_cnt", w_pad)):
            x = rng.integers(-4, t_cap + 4, size=n).astype(np.int32)
            x[:4] = ext[:n]
            c[k] = x
    return c


def rw_port(c: dict, device="cpu", impl=None, offset: int = 0) -> dict:
    """read_write_prep on rw_case's inputs; with `offset`, the per-read and
    per-write inputs are views that many int32s into their buffers."""
    t = {k: torch.from_numpy(c[k]).to(device) for k in
         ("too_old", "t_snap", "scal", "vmax_u")}
    for k in ("r_uid", "w_uid", "r_cnt", "w_cnt"):
        buf = torch.zeros((offset + c[k].shape[0],), dtype=torch.int32,
                          device=device)
        buf[offset:] = torch.from_numpy(c[k]).to(device)
        t[k] = buf[offset:]
    return fused.read_write_prep(t["r_uid"], t["w_uid"], t["r_cnt"],
                                 t["w_cnt"], t["too_old"], t["t_snap"],
                                 t["scal"], t["vmax_u"], c["shape"][3],
                                 impl=impl)


def rw_reference(c: dict) -> dict:
    """foundationdb_tpu/conflict/fused.py:324-371 (the history maxima
    given as vmax_u), with the reference's rank_count."""
    import jax.numpy as jnp
    from foundationdb_tpu.ops.digest import rank_count
    t_cap, r_pad, w_pad, u_pad = c["shape"]
    _, n_r, n_w, n_t, _, oldest_rel = (int(x) for x in c["scal"])
    r_start, w_start = jnp.asarray(c["r_start"]), jnp.asarray(c["w_start"])
    t_snap, t_flags = jnp.asarray(c["t_snap"]), jnp.asarray(c["t_flags"])
    iota_t = jnp.arange(t_cap, dtype=jnp.int32)
    t_valid = iota_t < n_t
    t_has_reads = (t_flags & 1) != 0
    too_old = t_valid & t_has_reads & (t_snap < oldest_rel)
    r_txn = rank_count(jnp.where(t_valid, r_start, r_pad), r_pad) - 1
    w_txn = rank_count(jnp.where(t_valid, w_start, w_pad), w_pad) - 1
    iota_r = jnp.arange(r_pad, dtype=jnp.int32)
    r_valid = iota_r < n_r
    r_txn_c = jnp.clip(r_txn, 0, t_cap - 1)
    r_live = r_valid & ~too_old[r_txn_c]
    snap_r = t_snap[r_txn_c]
    r_uid_c = jnp.clip(jnp.asarray(c["r_uid"]), 0, u_pad - 1)
    hist_bits = r_live & (jnp.asarray(c["vmax_u"])[r_uid_c] > snap_r)
    r_scatter = jnp.where(r_live, r_txn, t_cap)
    hist = jnp.zeros((t_cap,), bool).at[r_scatter].max(hist_bits,
                                                       mode="drop")
    iota_w = jnp.arange(w_pad, dtype=jnp.int32)
    w_valid = iota_w < n_w
    w_txn_c = jnp.clip(w_txn, 0, t_cap - 1)
    w_base_ok = w_valid & ~too_old[w_txn_c]
    w_slot = jnp.clip(jnp.asarray(c["w_uid"]), 0, u_pad - 1)
    out = {"too_old": too_old, "r_txn": r_txn, "r_live": r_live,
           "r_slot": r_uid_c, "hist": hist, "w_txn": w_txn,
           "w_ok": w_base_ok, "w_slot": w_slot}
    return {k: np.asarray(v).astype(np.int32) for k, v in out.items()}


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_read_write_prep_matches_reference(seed, full):
    """txn -1 reads, too-old and padding txns, n_r / n_w at the pads or
    below them: txn_prep's too_old and read_write_prep's seven arrays
    equal the reference's."""
    c = rw_case(seed, full=full)
    want = rw_reference(c)
    got = rw_port(c)
    np.testing.assert_array_equal(c["too_old"], want["too_old"])
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert (want["r_txn"][:3] == -1).all() and want["r_live"][:3].all()
    assert want["hist"][-1] == 1
    assert want["too_old"].any() and not want["r_live"].all()
