"""window_gc and the general step's fixpoint with its codes, on the CPU.

window_gc (conflict/window.py): its plain version against the reference's
(foundationdb_tpu/conflict/window.py:219-240) at the edges: size 0, 1 and
cap, nothing dropped (a live NEG_INF version clamped with no rebase),
everything but row 0 dropped, runs of drops, the rebase's int32 wrap.  On
the card window_gc is one in-place launch that rewrites only the rows
below the old size, so the window's invariant -- rows past size are MAX
rows at NEG_INF -- is pinned here too, in both packages, after insert
chains (one overflowing), gcs and ShardedWindow steps.

interval_fixpoint (conflict/fused.py) given codes_out, t_valid, too_old and
w_valid also writes the verdict codes and returns the insert mask: on the
card the codes are the last phase of the fixpoint's own launch.  Its plain
version equals the fixpoint alone followed by general_codes, and the
reference's block (foundationdb_tpu/conflict/fused.py:531-566, written out
below with jnp: the lax.while_loop over the interval cover, then the
survivors, the insert mask and the codes).

The cases are built without JAX (the cuda tests in test_torch_kernels.py
reuse them); JAX is imported inside the reference functions.  Integer
data: tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import fused
from foundationdb_tpu_torch.conflict import window as tw
from foundationdb_tpu_torch.ops.rangemax import NEG_INF

# ---------------------------------------------------------------------------
# window_gc
# ---------------------------------------------------------------------------

GC_CASES = ["size_0", "size_1", "size_cap", "none_dropped",
            "all_but_row_0", "runs", "rebase_wrap", "random"]
MAX_LANE = np.uint32(0xFFFFFFFF)


def gc_state(cap: int, size: int, below, oldest: int, rebase: int,
             seed: int = 0) -> dict:
    """A window state of capacity cap (rows int32[cap, 8] holding the
    uint32 bits, bv int32[cap], size) with `size` live rows, sorted and
    unique (lane 0 the row index, the others random); row i's version is
    below `oldest` where below[i] (a bool array of `size`), else at or
    above it; rows past size MAX at NEG_INF.  Returns the state with
    oldest and rebase."""
    rng = np.random.default_rng(seed)
    rows = np.full((cap, 8), MAX_LANE, np.uint32)
    rows[:size, 0] = np.arange(size, dtype=np.uint32)
    rows[:size, 1:] = rng.integers(0, 1 << 32, size=(size, 7),
                                   dtype=np.uint64).astype(np.uint32)
    bv = np.full(cap, NEG_INF, np.int32)
    below = np.asarray(below, bool)
    bv[:size] = rng.integers(oldest, oldest + 1000, size=size)
    bv[:size][below] = rng.integers(max(oldest - 1000, NEG_INF), oldest,
                                    size=int(below.sum()))
    return {"bk": rows.view(np.int32), "bv": bv,
            "size": np.array([size], np.int32), "oldest": oldest,
            "rebase": rebase}


def runs_mask(rng, size: int, longest: int = 4) -> np.ndarray:
    """Alternating runs of versions below and above the floor, each 1 to
    `longest` long: a row is dropped wherever it and its predecessor are
    below, so drops fall all over the live rows."""
    out = np.zeros(size, bool)
    i, below = 0, bool(rng.integers(0, 2))
    while i < size:
        n = int(rng.integers(1, longest + 1))
        out[i:i + n] = below
        i += n
        below = not below
    return out


def gc_case(name: str, cap: int = 1 << 10, seed: int = 0) -> dict:
    """One named edge case of window_gc (gc_state's layout)."""
    rng = np.random.default_rng(seed + 13 * GC_CASES.index(name))
    if name == "size_0":
        return gc_state(cap, 0, [], 500, 100, seed)
    if name == "size_1":
        return gc_state(cap, 1, [True], 500, 100, seed)
    if name == "size_cap":
        return gc_state(cap, cap, rng.random(cap) < 0.5, 500, 300, seed)
    if name == "none_dropped":
        # Every version at or above a floor of NEG_INF; a live NEG_INF
        # version is clamped to NEG_INF + 1 even with no rebase.
        st = gc_state(cap, cap - 3, np.zeros(cap - 3, bool), NEG_INF, 0,
                      seed)
        st["bv"][[3, 17]] = NEG_INF
        return st
    if name == "all_but_row_0":
        size = 3 * cap // 4 + 1
        return gc_state(cap, size, np.ones(size, bool), 500, 200, seed)
    if name == "runs":
        size = cap - 7
        return gc_state(cap, size, runs_mask(rng, size), 500, 250, seed)
    if name == "rebase_wrap":
        # A version just above NEG_INF wraps to a huge one (the
        # subtraction comes before the clamp, in both packages).
        size = cap // 2 + 3
        st = gc_state(cap, size, runs_mask(rng, size), -(1 << 31) + 2000,
                      100, seed)
        st["bv"][0] = NEG_INF + 5
        st["bv"][size // 2] = NEG_INF + 50
        return st
    size = int(rng.integers(cap // 3, cap))
    return gc_state(cap, size, rng.random(size) < 0.6, 500, 400, seed)


def gc_port(c: dict, device="cpu", impl=None) -> tw.WindowState:
    """window_gc on a fresh copy of the case's state."""
    st = tw.WindowState(*(torch.from_numpy(c[k].copy()).to(device)
                          for k in ("bk", "bv", "size")))
    got = tw.window_gc(st, c["oldest"], c["rebase"], impl=impl)
    assert got is st
    return got


def gc_reference(c: dict):
    """The reference's window_gc on the case: (bk rows, bv, size)."""
    import jax.numpy as jnp
    from foundationdb_tpu.conflict import window as jw
    from foundationdb_tpu_torch.ops.digest import (planar_to_rows,
                                                   rows_to_planar)
    out = jw.window_gc(
        jw.WindowState(jnp.asarray(rows_to_planar(c["bk"])),
                       jnp.asarray(c["bv"]), jnp.asarray(c["size"][0])),
        jnp.int32(c["oldest"]), jnp.int32(c["rebase"]))
    return planar_to_rows(np.asarray(out.bk)), np.asarray(out.bv), int(
        out.size)


@pytest.mark.parametrize("name", GC_CASES)
def test_window_gc_edges_match_reference(name):
    """The plain window_gc equals the reference's, row for row."""
    c = gc_case(name)
    got = gc_port(c)
    bk, bv, size = gc_reference(c)
    np.testing.assert_array_equal(got.bk.numpy(), bk)
    np.testing.assert_array_equal(got.bv.numpy(), bv)
    assert int(got.size[0]) == size
    old = int(c["size"][0])
    if name == "none_dropped":
        assert size == old and int(got.bv[3]) == NEG_INF + 1
    if name == "all_but_row_0":
        assert size == 1
    if name in ("runs", "random", "rebase_wrap"):
        assert 1 < size < old
    if name == "rebase_wrap":
        assert int(got.bv[0]) == (1 << 31) - 94


def test_window_gc_is_in_place():
    """The state's own tensors are rewritten and returned."""
    c = gc_case("runs")
    st = tw.WindowState(*(torch.from_numpy(c[k].copy())
                          for k in ("bk", "bv", "size")))
    ptrs = [t.data_ptr() for t in st]
    got = tw.window_gc(st, c["oldest"], c["rebase"])
    assert got is st
    assert [t.data_ptr() for t in got] == ptrs
    assert int(got.size[0]) < int(c["size"][0])


def gc_model(c: dict, grid: int, tile: int = tw.GC_TILE):
    """A numpy model of wg_gc's in-place moves (csrc/window.cu k_gc) with
    `grid` blocks and tiles of `tile` elements: the keep bits from the
    original versions; then each chunk of grid * tile elements loads its
    kept rows (from the array as the earlier chunks left it) and stores
    them at their ranks; a row whose rank is its own index keeps its place
    and only its version is rewritten where the rebase changes it; then
    [total, size) refilled.  Returns (bk, bv, size)."""
    bk, bv = c["bk"].copy(), c["bv"].copy()
    sz = int(np.clip(c["size"][0], 0, bk.shape[0]))
    oldest = c["oldest"]
    above = bv[:sz] >= oldest
    keep = above.copy()
    keep[1:] |= above[:-1]
    keep[:1] = sz > 0
    dst = np.cumsum(keep) - 1
    total = int(keep.sum())

    def rebase(v):
        w = (int(v) - c["rebase"] + (1 << 31)) % (1 << 32) - (1 << 31)
        return max(w, NEG_INF + 1)

    span = grid * tile
    chunks = -(-(-(-sz // tile)) // grid)
    for ch in range(chunks):
        lo, hi = ch * span, min((ch + 1) * span, sz)
        loaded = [(i, bk[i].copy(), bv[i]) for i in range(lo, hi) if keep[i]]
        for i, row, v in loaded:
            d = dst[i]
            if d != i:
                bk[d], bv[d] = row, rebase(v)
            elif rebase(v) != v:
                bv[i] = rebase(v)
    bk[total:sz] = -1
    bv[total:sz] = NEG_INF
    return bk, bv, total


@pytest.mark.parametrize("grid,tile", [(1, 8), (3, 16), (5, 64)])
@pytest.mark.parametrize("name", GC_CASES)
def test_gc_model_matches_plain(name, grid, tile):
    """The chunked in-place move (gc_model) at tiles and grids that put
    many chunks over the case's rows equals the plain window_gc: a
    destination never lies past its source, so a chunk overwrites only
    rows already loaded."""
    c = gc_case(name)
    bk, bv, size = gc_model(c, grid, tile)
    want = gc_port(c)
    np.testing.assert_array_equal(bk, want.bk.numpy())
    np.testing.assert_array_equal(bv, want.bv.numpy())
    assert size == int(want.size[0])


def assert_tail_max(bk, bv, size, what: str) -> None:
    """Rows past size are MAX rows at NEG_INF (bk rows or planar)."""
    bk, bv, size = np.asarray(bk), np.asarray(bv), int(size)
    tail = bk[size:] if bk.shape[-1] == 8 else bk[:, size:]
    assert (tail.view(np.uint32) == MAX_LANE).all(), what
    assert (bv[size:] == NEG_INF).all(), what


@pytest.mark.parametrize("cap", [1 << 10, 128])
def test_rows_past_size_stay_max_through_inserts_and_gc(cap):
    """The invariant window_gc's kernel relies on, in both packages: after
    every insert (with cap 128 one overflows and keeps the old state) and
    every gc (with a rebase), rows past size are MAX rows at NEG_INF."""
    import jax.numpy as jnp
    from foundationdb_tpu.conflict import window as jw
    from test_torch_window import rows, write_ranges
    rng = np.random.default_rng(31)
    j = jw.make_window_state(cap, 0)
    p = tw.make_window_state(cap, 0, "cpu")
    base, overflows = 0, []
    for i in range(6):
        b, e, valid = write_ranges(rng)
        now = 1000 * (i + 1) - base
        j, j_ovf = jw.window_insert(j, jnp.asarray(b), jnp.asarray(e),
                                    jnp.asarray(valid), jnp.int32(now))
        tw.window_insert(p, rows(b), rows(e),
                         torch.from_numpy(valid.astype(np.int32)), now)
        overflows.append(bool(j_ovf))
        assert_tail_max(j.bk, j.bv, j.size, f"reference, insert {i}")
        assert_tail_max(p.bk, p.bv, p.size[0], f"port, insert {i}")
        if i % 2 == 1:
            floor = now - 1500
            j = jw.window_gc(j, jnp.int32(floor), jnp.int32(floor))
            tw.window_gc(p, floor, floor)
            base += floor
            assert_tail_max(j.bk, j.bv, j.size, f"reference, gc {i}")
            assert_tail_max(p.bk, p.bv, p.size[0], f"port, gc {i}")
        for got, want in zip(tw.window_state_to_numpy(p), j):
            np.testing.assert_array_equal(got, np.asarray(want))
    assert any(overflows) == (cap == 128)


def test_rows_past_size_stay_max_in_sharded_window():
    """The same on every shard of both packages' ShardedWindow (kr=4):
    spread steps, skewed steps until one shard overflows (every shard
    keeps its state), then a gc with rebase."""
    from foundationdb_tpu.parallel import sharded_window as jsw
    from foundationdb_tpu_torch.parallel import sharded_window as tsw
    from test_torch_sharded_window import CAP, batch
    rng = np.random.default_rng(37)
    ref = jsw.ShardedWindow(jsw.make_conflict_mesh(), capacity=CAP)
    port = tsw.ShardedWindow(tsw.make_conflict_mesh(["cpu"] * 8),
                             capacity=CAP)

    def check(what):
        for name, (bk, bv, size) in (
                ("reference", (np.asarray(ref.bk), np.asarray(ref.bv),
                               np.asarray(ref.size))),
                ("port", port.state_to_numpy())):
            for d in range(bk.shape[0]):
                assert_tail_max(bk[d], bv[d], size[d],
                                f"{name} shard {d}, {what}")

    version, overflowed = 0, False
    for i in range(12):
        version += 100
        args = batch(rng, version, lead=None if i < 2 else 0x01)
        _, want_ovf = ref.resolve_step(*args, version)
        _, got_ovf = port.resolve_step(*args, version)
        assert int(got_ovf[0]) == int(bool(want_ovf))
        check(f"step {i}")
        if bool(want_ovf):
            overflowed = True
            break
    assert overflowed
    version += 100
    for sw in (ref, port):
        sw.gc(version, version // 2)
    check("gc")


# ---------------------------------------------------------------------------
# interval_fixpoint with the codes
# ---------------------------------------------------------------------------

GCODES_CASES = ["mixed", "txn_minus_1", "too_old_writers", "none_valid",
                "all_valid", "t_cap_odd", "chain"]
FIX_KEYS = ("hist", "r_txn", "r_live", "r_pb", "r_pe", "w_txn", "w_ok",
            "w_pb", "w_pe")
CODE_KEYS = ("t_valid", "too_old", "w_valid")


def gcodes_case(name: str, seed: int = 0, t_cap: int = 64, r_cap: int = 256,
                w_cap: int = 128, log_u: int = 9) -> dict:
    """interval_fixpoint's columns (int32 numpy: hist, r_txn, r_live, r_pb,
    r_pe, w_txn, w_ok, w_pb, w_pe as general_prep and the endpoint
    placement give them) and the codes' inputs (t_valid, too_old, w_valid)
    for one named case, shapes under "shape": (t_cap, r_cap, w_cap,
    log_u).  Spans lie in [0, U - 8); txn -1 writes (which take txn 0's
    flags) span [U - 8, U), which no read reaches: a txn -1 write over a
    key txn 0 reads makes txn 0's verdict flip every round (the
    reference's while_loop, as the plain fixpoint, would never end).
    Reads and writes of live txns are sorted by txn."""
    if name == "t_cap_odd":
        t_cap, r_cap, w_cap = 37, 101, 53
    rng = np.random.default_rng(seed + 17 * GCODES_CASES.index(name))
    u = 1 << log_u
    n_t = {"none_valid": 0, "all_valid": t_cap}.get(name, t_cap - 5)
    n_r, n_w = r_cap - 9, w_cap - 5
    t_valid = (np.arange(t_cap) < n_t).astype(np.int32)
    too_old = ((rng.random(t_cap) < (0.5 if name == "too_old_writers"
                                     else 0.15)) & (t_valid != 0))
    if name == "all_valid":
        too_old[:] = False
    r_txn = np.full(r_cap, t_cap, np.int32)
    w_txn = np.full(w_cap, t_cap, np.int32)
    hi = max(n_t, 1)
    r_txn[:n_r] = np.sort(rng.integers(0, hi, n_r))
    w_txn[:n_w] = np.sort(rng.integers(0, hi, n_w))
    r_pb = rng.integers(0, u - 8, r_cap)
    r_pe = np.minimum(r_pb + rng.integers(0, 12, r_cap), u - 8)
    w_pb = rng.integers(0, u - 8, w_cap)
    w_pe = np.minimum(w_pb + rng.integers(0, 6, w_cap), u - 8)
    if name == "txn_minus_1":
        w_txn[:n_w // 4] = -1
        r_txn[:n_r // 8] = -1
    elif n_t:
        w_txn[:2] = -1
    w_pb[w_txn == -1] = u - 8
    w_pe[w_txn == -1] = u - 2
    if name == "chain":       # txn i reads inside the span txn i - 1 writes
        depth = min(24, n_r, n_w, n_t)
        stride = (u - 8) // (depth + 2)
        t = np.arange(depth)
        r_txn[:depth] = w_txn[:depth] = t
        r_pb[:depth], r_pe[:depth] = t * stride + 1, t * stride + 2
        w_pb[:depth], w_pe[:depth] = t * stride, (t + 1) * stride + 2
        r_txn[depth:n_r] = np.maximum(r_txn[depth:n_r], depth)
        w_txn[depth:n_w] = np.maximum(w_txn[depth:n_w], depth)
        far = (r_txn >= depth)
        r_pb[far] = r_pe[far] = u - 9          # empty spans
        too_old[:depth] = False
    clamp = lambda x: np.clip(x, 0, t_cap - 1)
    r_valid = (np.arange(r_cap) < n_r) & (rng.random(r_cap) < 0.95)
    w_valid = (np.arange(w_cap) < n_w) & (rng.random(w_cap) < 0.95)
    if name == "all_valid":
        r_valid[:n_r] = w_valid[:n_w] = True
    if name == "chain":
        r_valid[:depth] = w_valid[:depth] = True
    r_live = r_valid & ~too_old[clamp(r_txn)]
    w_ok = w_valid & ~too_old[clamp(w_txn)]
    hist = ((rng.random(t_cap) < 0.1) & (name != "chain")).astype(np.int32)
    cols = {"hist": hist, "r_txn": r_txn, "r_live": r_live, "r_pb": r_pb,
            "r_pe": r_pe, "w_txn": w_txn, "w_ok": w_ok, "w_pb": w_pb,
            "w_pe": w_pe, "t_valid": t_valid, "too_old": too_old,
            "w_valid": w_valid}
    out = {k: np.asarray(v).astype(np.int32) for k, v in cols.items()}
    out["shape"] = (t_cap, r_cap, w_cap, log_u)
    return out


def gcodes_port(c: dict, device="cpu", impl=None, offset: int = 0) -> dict:
    """interval_fixpoint with the codes on gcodes_case's columns; with
    `offset`, t_valid, w_txn and w_valid are views that many int32s into
    their buffers (as the metadata block's sections may lie: no 16-byte
    loads)."""
    def col(k):
        if offset and k in ("t_valid", "w_txn", "w_valid"):
            buf = torch.zeros((offset + c[k].shape[0],), dtype=torch.int32)
            buf[offset:] = torch.from_numpy(c[k])
            return buf.to(device)[offset:]
        return torch.from_numpy(c[k]).to(device)

    t = {k: col(k) for k in (*FIX_KEYS, *CODE_KEYS)}
    codes = torch.full((c["shape"][0],), 77, dtype=torch.int8, device=device)
    conf, rounds, w_ins = fused.interval_fixpoint(
        *(t[k] for k in FIX_KEYS), c["shape"][3], impl=impl,
        codes_out=codes, **{k: t[k] for k in CODE_KEYS})
    return {"conf": conf, "rounds": rounds, "codes": codes, "w_ins": w_ins}


@functools.lru_cache(maxsize=None)
def _general_block():
    """foundationdb_tpu/conflict/fused.py:531-566, jitted (the fixpoint's
    inputs as the reference names them: hist_conflicted, r_live, the
    spans, w_base_ok), with the while_loop's rounds counted."""
    import jax
    import jax.numpy as jnp
    from foundationdb_tpu.conflict.fused import (RES_COMMITTED, RES_CONFLICT,
                                                 RES_INVALID, RES_TOO_OLD)
    from foundationdb_tpu.ops.segtree import (build_min_table,
                                              interval_min_cover, range_min)

    def block(hist, r_txn, r_live, r_pb, r_pe, w_txn, w_ok, w_pb, w_pe,
              t_valid, too_old, w_valid, log_u):
        t_cap = hist.shape[0]
        hist_conflicted = hist != 0
        r_live, w_base_ok = r_live != 0, w_ok != 0
        t_valid, too_old, w_valid = t_valid != 0, too_old != 0, w_valid != 0
        w_txn_c = jnp.clip(w_txn, 0, t_cap - 1)
        r_scatter = jnp.where(r_live, r_txn, t_cap)

        def body(carry):
            conf, _, rounds = carry
            w_active = w_base_ok & ~conf[w_txn_c]
            cover = interval_min_cover(w_pb, w_pe, w_txn, w_active, log_u)
            m = range_min(build_min_table(cover), r_pb, r_pe)
            intra_hit = r_live & (m < r_txn)
            new_conf = hist_conflicted.at[r_scatter].max(intra_hit,
                                                         mode="drop")
            return new_conf, jnp.any(new_conf != conf), rounds + 1

        conflicted, _, rounds = jax.lax.while_loop(
            lambda c: c[1], body, (hist_conflicted, True, 0))
        survivor = t_valid & ~too_old & ~conflicted
        w_ins = w_valid & survivor[w_txn_c]
        codes = jnp.where(
            ~t_valid, RES_INVALID,
            jnp.where(too_old, RES_TOO_OLD,
                      jnp.where(conflicted, RES_CONFLICT, RES_COMMITTED))
        ).astype(jnp.int8)
        return conflicted, rounds, codes, w_ins

    return jax.jit(block, static_argnums=12)


def gcodes_reference(c: dict) -> dict:
    """The reference's fixpoint and codes (_general_block) on the case."""
    conf, rounds, codes, w_ins = _general_block()(
        *(c[k] for k in (*FIX_KEYS, *CODE_KEYS)), c["shape"][3])
    return {"conf": np.asarray(conf).astype(np.int32),
            "rounds": np.array([int(rounds)], np.int32),
            "codes": np.asarray(codes),
            "w_ins": np.asarray(w_ins).astype(np.int32)}


@pytest.mark.parametrize("name", GCODES_CASES)
def test_fixpoint_with_codes_matches_reference(name):
    """conf, rounds, codes and the insert mask equal the reference's; the
    call equals the fixpoint alone followed by general_codes; unaligned
    metadata views give the same."""
    c = gcodes_case(name)
    want = gcodes_reference(c)
    got = gcodes_port(c)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    t = {k: torch.from_numpy(c[k]) for k in (*FIX_KEYS, *CODE_KEYS)}
    acc = torch.zeros((1,), dtype=torch.int32)
    conf, rounds = fused.interval_fixpoint(*(t[k] for k in FIX_KEYS),
                                           c["shape"][3], rounds_acc=acc)
    codes = torch.empty((c["shape"][0],), dtype=torch.int8)
    w_ins = fused.general_codes(t["t_valid"], t["too_old"], conf, t["w_txn"],
                                t["w_valid"], codes)
    for k, v in (("conf", conf), ("rounds", rounds), ("codes", codes),
                 ("w_ins", w_ins)):
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert int(acc[0]) == int(rounds[0])
    for k, v in gcodes_port(c, offset=1).items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0)
    codes = set(want["codes"].tolist())
    if name == "none_valid":
        assert codes == {fused.RES_INVALID} and not want["w_ins"].any()
    if name in ("mixed", "too_old_writers"):
        assert {0, 1, 2} <= codes
    if name == "chain":
        assert want["rounds"][0] >= 24
    if name == "txn_minus_1":
        assert c["w_txn"][0] == -1 and c["r_txn"][0] == -1


@pytest.mark.parametrize("missing", CODE_KEYS)
def test_fixpoint_codes_need_their_inputs(missing):
    c = gcodes_case("mixed")
    t = {k: torch.from_numpy(c[k]) for k in (*FIX_KEYS, *CODE_KEYS)}
    kw = {k: t[k] for k in CODE_KEYS if k != missing}
    with pytest.raises(ValueError):
        fused.interval_fixpoint(*(t[k] for k in FIX_KEYS), c["shape"][3],
                                codes_out=torch.empty((64,),
                                                      dtype=torch.int8),
                                **kw)
