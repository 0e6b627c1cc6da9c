"""The port's two range inserts against the reference's, case by case:
window_insert (foundationdb_tpu/conflict/window.py) and the point insert
(_point_insert, foundationdb_tpu/conflict/fused.py), the port's plain
versions on the CPU against JAX on the CPU.  Integer data: tolerance 0.

Each case is a small tier (sorted unique boundaries, row 0 the zero digest
or a shard's lower split, versions, MAX / NEG_INF padding) and a set of
write ranges, built with numpy and no JAX, so that tests/test_torch_kernels.py
holds the CUDA kernels against the plain versions on the same cases:

  empty_new        an empty range [b, b) at a key no boundary holds: the
                   begin and the end are both added, the begin first;
  empty_at_row     an empty range at a live boundary: the reference's
                   scatters collide there (the row after the new begin is
                   left a MAX row at NEG_INF, in both packages);
  present_end      a range whose end is a live boundary (no end added);
  cover_all        one range over every live boundary, row 0 included: the
                   size shrinks;
  exact_fit        the new size is the capacity (a set flag stays set);
  overflow_by_one  one row over: state unchanged, the flag set, the tail
                   written;
  end_below_row0   a range ending below row 0: the continuing version's
                   slot is -1, which window_insert wraps to row cap - 1 and
                   the point insert clamps to row 0, as their references
                   gather;
  masked_shard     (point) a key-range shard's insert: only the owned
                   begins (u_own), row 0 the shard's lower split.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import fused as tf
from foundationdb_tpu_torch.conflict import window as tw
from foundationdb_tpu_torch.ops import digest as td
from foundationdb_tpu_torch.ops.rangemax import NEG_INF

CAP = 64          # both tiers' capacity
W = 8             # window_insert's write ranges
U, WP = 8, 12     # the point insert's unique keys and writes
NOW = 9000

WINDOW_CASES = ["empty_new", "empty_at_row", "present_end", "cover_all",
                "exact_fit", "overflow_by_one", "end_below_row0"]
POINT_CASES = ["present_end", "exact_fit", "overflow_by_one",
               "end_below_row0", "masked_shard"]
CASES = ([("window", c) for c in WINDOW_CASES]
         + [("point", c) for c in POINT_CASES])


def keys(ids) -> np.ndarray:
    """Planar digests uint32[8, n] of the 15-byte keys b"k%014d" % id."""
    ids = np.asarray(ids, dtype=np.int64).ravel()
    mat = np.empty((ids.size, 15), dtype=np.uint8)
    mat[:, 0] = ord("k")
    x = ids.copy()
    for d in range(14):
        mat[:, 14 - d] = 48 + x % 10
        x //= 10
    return td.encode_fixed(mat)


def after(planar: np.ndarray) -> np.ndarray:
    """Each key followed by a zero byte (a point range's end)."""
    out = planar.copy()
    out[7] += 1
    return out


def tier(live, first_id=None, cap: int = CAP, seed: int = 0):
    """(bk planar uint32[8, cap], bv int32[cap], size): row 0 the zero
    digest, or the key first_id (a shard's lower split), then the live
    keys (key ids, or planar digests; sorted here, all above row 0),
    random versions, MAX / NEG_INF padding."""
    rng = np.random.default_rng(seed)
    live = np.asarray(live)
    if live.ndim == 1:
        live = keys(live)
    live = live[:, np.lexsort(live[::-1])]
    bk = td.max_digest_block(cap)
    bk[:, 0] = 0 if first_id is None else keys([first_id])[:, 0]
    bk[:, 1:1 + live.shape[1]] = live
    size = 1 + live.shape[1]
    bv = np.full((cap,), NEG_INF, dtype=np.int32)
    bv[:size] = rng.integers(100, 5000, size=size).astype(np.int32)
    return bk, bv, size


def ranges(pairs, n: int = W):
    """Planar begins / ends [8, n] and validity of the ranges [k(a), k(b))
    (a None begin is the zero digest), the rest invalid at key 0."""
    b, e = keys(np.zeros(n)), keys(np.zeros(n))
    valid = np.zeros(n, dtype=bool)
    for i, (lo, hi) in enumerate(pairs):
        b[:, i] = 0 if lo is None else keys([lo])[:, 0]
        e[:, i] = keys([hi])[:, 0]
        valid[i] = True
    return b, e, valid


def window_case(name: str) -> dict:
    ids = np.arange(10, 400, 10)                  # 39 live rows + row 0
    first, flag, pairs = None, 0, []
    if name == "empty_new":
        pairs = [(15, 15), (31, 45), (200, 230)]
    elif name == "empty_at_row":
        pairs = [(20, 20), (55, 57), (300, 300)]
    elif name == "present_end":
        pairs = [(12, 30), (41, 50), (95, 130)]
    elif name == "cover_all":
        pairs = [(None, 1000)]
    elif name == "exact_fit":               # 60 rows + 2 x 2 new = 64
        ids, flag = np.arange(10, 600, 10), 1
        pairs = [(5, 7), (601, 603)]
    elif name == "overflow_by_one":         # 61 rows + 2 x 2 new = 65
        ids = np.arange(10, 610, 10)
        pairs = [(5, 7), (611, 613)]
    elif name == "end_below_row0":          # row 0 is k(5)
        first = 5
        pairs = [(1, 3), (30, 44)]
    bk, bv, size = tier(ids, first)
    b, e, valid = ranges(pairs)
    return {"kind": "window", "bk": bk, "bv": bv, "size": size, "flag": flag,
            "wb": b, "we": e, "valid": valid, "bsize": 4242}


def point_case(name: str, seed: int = 1) -> dict:
    """U sorted unique begin keys (MAX padded past n_keys), their ends one
    zero byte on, and WP writes (w_uid, w_ins) over them."""
    rng = np.random.default_rng(seed)
    ids = np.arange(10, 400, 10)
    first, flag, own = None, 0, None
    kid = np.array([12, 20, 33, 50, 71, 90])
    ins = np.ones(WP, dtype=bool)
    if name == "present_end":
        # Boundaries at the ends of k(12) and k(50), and at the begins
        # k(20) and k(50) (dropped by their ranges).
        bk, bv, size = tier(np.concatenate(
            [keys(ids), after(keys([12, 50]))], axis=1))
    elif name in ("exact_fit", "overflow_by_one"):
        kid = np.array([3, 5, 7])            # three new keys, 2 rows each
        n_live = CAP - 6 - 1 + (name == "overflow_by_one")
        bk, bv, size = tier(np.arange(10, 10 * (n_live + 1), 10))
        flag = int(name == "exact_fit")
    elif name == "end_below_row0":
        first = 60
        kid = np.array([5, 12, 61, 75])
        bk, bv, size = tier(np.arange(70, 400, 10), first)
    else:                                    # masked_shard
        first = 45
        kid = np.array([12, 20, 45, 50, 71, 90, 130])
        bk, bv, size = tier(np.arange(50, 400, 10), first)
        own = kid >= first
        own = np.concatenate([own, np.zeros(U - kid.size, dtype=bool)])
        own[-1] = True                       # a padding slot, owned
        ins = rng.random(WP) < 0.8
    n = kid.size
    u_k = td.max_digest_block(U)
    u_k[:, :n] = keys(kid)
    u_e = td.max_digest_block(U)
    u_e[:, :n] = after(keys(kid))
    w_uid = np.concatenate([np.arange(n), rng.integers(0, n, WP - n)])
    return {"kind": "point", "bk": bk, "bv": bv, "size": size, "flag": flag,
            "u_k": u_k, "u_e": u_e, "w_uid": w_uid.astype(np.int32),
            "w_ins": ins, "u_own": own, "bsize": 4242}


def make_case(kind: str, name: str) -> dict:
    return window_case(name) if kind == "window" else point_case(name)


def run_port(case: dict, device="cpu", impl=None) -> dict:
    """The port's insert on the case, IN PLACE on fresh tensors; returns
    the tier (planar keys), size, flag and tail."""
    def t(x, dtype=torch.int32):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(
            dtype).to(device)

    bk = torch.from_numpy(td.planar_to_rows(case["bk"])).to(device)
    bv = t(case["bv"])
    size = t([case["size"]])
    flag = t([case["flag"]])
    bsize = t([case["bsize"]])
    tail = torch.zeros((3,), dtype=torch.int32, device=device)

    def rows(planar):
        return torch.from_numpy(td.planar_to_rows(planar)).to(device)

    if case["kind"] == "window":
        _, ovf = tw.window_insert(
            tw.WindowState(bk, bv, size), rows(case["wb"]), rows(case["we"]),
            t(case["valid"]), t([NOW]), flag=flag, bsize=bsize, tail=tail,
            impl=impl)
        assert ovf is flag
    else:
        own = None if case["u_own"] is None else t(case["u_own"])
        tf._point_insert(bk, bv, size, rows(case["u_k"]), rows(case["u_e"]),
                         t(case["w_uid"]), t(case["w_ins"]), t([NOW]), flag,
                         bsize=bsize, tail=tail, impl=impl, u_own=own)
    return {"bk": td.rows_to_planar(bk.cpu()), "bv": bv.cpu().numpy(),
            "size": int(size[0]), "flag": int(flag[0]),
            "tail": tail.cpu().tolist()}


@lru_cache(maxsize=None)
def jax_point_insert(d_cap: int, u_pad: int, masked: bool):
    import jax
    from foundationdb_tpu.conflict import fused as jf
    if masked:
        return jax.jit(lambda dk, dv, ds, uk, ue, wu, wi, now, own:
                       jf._point_insert(dk, dv, ds, uk, ue, wu, wi, now,
                                        d_cap, u_pad, u_own=own))
    return jax.jit(lambda dk, dv, ds, uk, ue, wu, wi, now: jf._point_insert(
        dk, dv, ds, uk, ue, wu, wi, now, d_cap, u_pad))


def run_reference(case: dict) -> dict:
    """The reference's insert on the case (JAX on the CPU), with the
    port's flag and tail derived from its overflow bit."""
    import jax.numpy as jnp
    from foundationdb_tpu.conflict import window as jw
    j = jnp.asarray
    if case["kind"] == "window":
        st, ovf = jw.window_insert(
            jw.WindowState(j(case["bk"]), j(case["bv"]),
                           j(np.int32(case["size"]))),
            j(case["wb"]), j(case["we"]), j(case["valid"]), j(np.int32(NOW)))
    else:
        args = [j(case["bk"]), j(case["bv"]), j(np.int32(case["size"])),
                j(case["u_k"]), j(case["u_e"]), j(case["w_uid"]),
                j(case["w_ins"]), j(np.int32(NOW))]
        masked = case["u_own"] is not None
        if masked:
            args.append(j(case["u_own"]))
        st, ovf = jax_point_insert(CAP, U, masked)(*args)
    flag = case["flag"] | int(ovf)
    size = int(st[2])
    return {"bk": np.asarray(st[0]), "bv": np.asarray(st[1]), "size": size,
            "flag": flag, "tail": [flag, size, case["bsize"]]}


def assert_same(got: dict, want: dict, name: str) -> None:
    np.testing.assert_array_equal(got["bk"], want["bk"], err_msg=name)
    np.testing.assert_array_equal(got["bv"], want["bv"], err_msg=name)
    for k in ("size", "flag", "tail"):
        assert got[k] == want[k], (name, k, got[k], want[k])


@pytest.mark.parametrize("kind,name", CASES, ids=[f"{k}-{n}" for k, n in CASES])
def test_insert_matches_reference(kind, name):
    case = make_case(kind, name)
    got = run_port(case)
    want = run_reference(case)
    assert_same(got, want, f"{kind}-{name}")
    # What each case is there for.
    n0 = case["size"]
    if name == "overflow_by_one":
        assert got["flag"] == 1 and got["size"] == n0
        np.testing.assert_array_equal(got["bk"], case["bk"])
    elif name == "exact_fit":
        assert got["size"] == CAP and got["flag"] == 1
    elif name == "cover_all":
        assert got["size"] == 2 < n0
    elif name == "empty_new":
        i = int(np.flatnonzero((got["bk"] == keys([15])).all(0))[0])
        assert (got["bk"][:, i + 1] == keys([15])[:, 0]).all()
        assert got["bv"][i] == NOW and got["bv"][i + 1] != NOW
    elif name == "empty_at_row":
        i = int(np.flatnonzero((got["bk"] == keys([20])).all(0))[0])
        assert got["bv"][i] == NOW
        assert (got["bk"][:, i + 1] == 0xFFFFFFFF).all()
        assert got["bv"][i + 1] == NEG_INF
    elif name == "end_below_row0" and kind == "window":
        # k(3)'s continuing version is row cap - 1's (the wrap), NEG_INF
        # past the live rows; the clamp would have given row 0's.
        i = int(np.flatnonzero((got["bk"] == keys([3])).all(0))[0])
        assert got["bv"][i] == NEG_INF
    elif name == "end_below_row0":
        # k(5)'s end continues row 0's version (the clamp).
        i = int(np.flatnonzero((got["bk"] == after(keys([5]))).all(0))[0])
        assert got["bv"][i] == case["bv"][0]
