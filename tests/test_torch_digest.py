"""The port's ops/digest.py against foundationdb_tpu/ops/digest.py.

Host encoders must be byte-identical (they are copies); the device half
(searches, rank_count, the history probe, the compact-buffer widening)
must give the reference's integers exactly.  The device tables are rows
int32[N, 8] in the port and planar uint32[8, N] in the reference, so the
inputs are made once with numpy and converted for each side.  Lanes at
the int32 sign boundary (0x7FFFFFFF / 0x80000000) and MAX padding are
part of every table: the port's plain versions compare lanes biased by
0x80000000, and a wrong bias shows exactly there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import digest as jd
from foundationdb_tpu.ops.rangemax import build_sparse_table as jax_table
from foundationdb_tpu.ops.rangemax import range_max as jax_range_max
from foundationdb_tpu_torch.ops import digest as td
from foundationdb_tpu_torch.ops.rangemax import build_sparse_table

EDGE_LANES = np.array([0, 1, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0x80000001,
                       0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


def random_keys(rng, n: int, max_len: int = 40):
    return [bytes(rng.integers(0, 256, size=int(rng.integers(0, max_len + 1)),
                               dtype=np.uint8)) for _ in range(n)]


def tenant_keys(rng, n: int):
    """8-byte tenant prefix + tenant-relative key of 0..30 bytes (keys of
    up to 38 bytes: exact up to 23 relative bytes, rounded past that)."""
    tenants = [bytes(rng.integers(0, 256, size=8, dtype=np.uint8))
               for _ in range(4)]
    return [tenants[int(rng.integers(0, 4))]
            + bytes(rng.integers(0, 256, size=int(rng.integers(0, 31)),
                                 dtype=np.uint8)) for _ in range(n)]


def edge_digests(rng, n: int) -> np.ndarray:
    """Planar uint32[8, n] digests drawn mostly from EDGE_LANES."""
    lanes = EDGE_LANES[rng.integers(0, EDGE_LANES.size, size=(8, n))]
    rand = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    pick = rng.random((8, n)) < 0.2
    return np.where(pick, rand.astype(np.uint32), lanes).astype(np.uint32)


def sorted_table(rng, live: int, cap: int) -> np.ndarray:
    """Sorted unique digests (first row all zeros, the all-keys boundary),
    MAX-padded to cap: planar uint32[8, cap]."""
    d = np.concatenate([np.zeros((8, 1), np.uint32),
                        edge_digests(rng, live)], axis=1)
    s = np.unique(jd.planar_to_s24(d))
    rows = s.view(np.uint8).reshape(-1, 32)[: cap]
    planar = rows.view(">u4").astype(np.uint32).T
    out = jd.max_digest_block(cap)
    out[:, :planar.shape[1]] = planar
    return out


def rows(planar: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(td.planar_to_rows(planar))


@pytest.mark.parametrize("round_up", [False, True])
def test_encode_keys_byte_identical(round_up):
    """Random keys of 0..40 bytes (>= 32 bytes round down or up) and
    tenant-salted keys."""
    rng = np.random.default_rng(1)
    keys = (random_keys(rng, 300) + tenant_keys(rng, 200)
            + [b"", b"\x00", b"\xff" * 31, b"\xff" * 32, b"\xff" * 40,
               b"a" * 31, b"a" * 32])
    got = td.encode_keys(keys, round_up=round_up)
    want = jd.encode_keys(keys, round_up=round_up)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("width,with_lens", [(15, False), (16, True),
                                             (31, True), (40, True),
                                             (40, False)])
def test_encode_fixed_byte_identical(width, with_lens):
    rng = np.random.default_rng(width)
    mat = rng.integers(0, 256, size=(257, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, size=257) if with_lens else None
    for round_up in (False, True):
        got = td.encode_fixed(mat, lens, round_up=round_up)
        want = jd.encode_fixed(mat, lens, round_up=round_up)
        assert got.tobytes() == want.tobytes()


def test_host_helpers_identical():
    rng = np.random.default_rng(3)
    d = edge_digests(rng, 500)
    row_major = np.ascontiguousarray(d.T)
    assert td._add_one_ulp(row_major).tobytes() == \
        jd._add_one_ulp(row_major).tobytes()
    assert td.planar_to_s24(d).tobytes() == jd.planar_to_s24(d).tobytes()
    assert td.max_digest_block(7).tobytes() == jd.max_digest_block(7).tobytes()
    for name in ("SALT_LANES", "SALT_BYTES", "KEY_LANES", "PREFIX_BYTES",
                 "DIGEST_BYTES", "ROW_PAD"):
        assert getattr(td, name) == getattr(jd, name), name
    assert (td.MAX_DIGEST == jd.MAX_DIGEST).all()
    # Rows and planar hold the same bits.
    assert (td.rows_to_planar(rows(d)) == d).all()


def test_lex_less_unsigned_order():
    """lex_less on rows against the reference's planar lex_less."""
    rng = np.random.default_rng(4)
    a, b = edge_digests(rng, 2000), edge_digests(rng, 2000)
    b[:, ::7] = a[:, ::7]                      # some equal pairs
    want = np.asarray(jd.lex_less(jnp.asarray(a), jnp.asarray(b)))
    got = td.lex_less(rows(a), rows(b)).numpy()
    assert (got == want).all()
    assert (td.lex_eq(rows(a), rows(b)).numpy()
            == np.asarray(jd.lex_eq(jnp.asarray(a), jnp.asarray(b)))).all()


@pytest.mark.parametrize("cap,live", [(64, 40), (256, 255), (1024, 300)])
def test_searches_match_reference(cap, live):
    """searchsorted_left/right/interval over a MAX-padded table, queries
    drawn from the table itself, from edge lanes and MAX."""
    rng = np.random.default_rng(cap)
    table = sorted_table(rng, live, cap)
    q = np.concatenate([table[:, rng.integers(0, cap, size=100)],
                        edge_digests(rng, 150), jd.max_digest_block(6),
                        np.zeros((8, 2), np.uint32)], axis=1)
    jt, jq = jnp.asarray(table), jnp.asarray(q)
    tt, tq = rows(table), rows(q)
    for side_left, jfn in ((True, jd.searchsorted_left),
                           (False, jd.searchsorted_right)):
        got = td.searchsorted(tt, tq, side_left).numpy()
        assert (got == np.asarray(jfn(jt, jq))).all()
    qe = q.copy()
    qe[7] += 1
    jb, je = jd.searchsorted_interval(jt, jq, jnp.asarray(qe))
    gb, ge = td.searchsorted_interval(tt, tq, rows(qe))
    assert (gb.numpy() == np.asarray(jb)).all()
    assert (ge.numpy() == np.asarray(je)).all()


def general_endpoints(rng, r_cap: int, w_cap: int) -> np.ndarray:
    """A general batch's endpoint rows as the general step holds them:
    planar r_b | r_e | w_b | w_e (r_cap reads, w_cap writes), the last
    slots of each section MAX padding, and endpoints that repeat within
    and across the sections (writes over read endpoints, a read's end
    another's begin)."""
    pool = np.concatenate([edge_digests(rng, 40), jd.max_digest_block(1),
                           np.zeros((8, 1), np.uint32)], axis=1)

    def section(n, pad):
        d = pool[:, rng.integers(0, pool.shape[1], size=n)]
        d[:, n - pad:] = 0xFFFFFFFF
        return d

    r_b, r_e = section(r_cap, r_cap // 4), section(r_cap, r_cap // 4)
    w_b, w_e = section(w_cap, w_cap // 4), section(w_cap, w_cap // 4)
    w_b[:, :w_cap // 4] = r_e[:, :w_cap // 4]
    w_e[:, :w_cap // 4] = r_b[:, 1:1 + w_cap // 4]
    return np.concatenate([r_b, r_e, w_b, w_e], axis=1)


@pytest.mark.parametrize("r_cap,w_cap,seed", [(24, 8, 1), (96, 32, 2),
                                              (200, 56, 3)])
def test_universe_placement_in_one_call(r_cap, w_cap, seed):
    """The general step's endpoint placement (reference fused.py:520-529:
    the batch's endpoints sorted and MAX padded to a power of two, then
    searchsorted_left of the reads' and the writes' endpoints): one
    searchsorted over every row of the batch equals the reference's four
    searches, the port's two calls and _searchsorted_plain."""
    import jax
    from foundationdb_tpu_torch.conflict.fused import _next_pow2
    from foundationdb_tpu_torch.ops.sort import sort_rows
    rng = np.random.default_rng(seed)
    planar = general_endpoints(rng, r_cap, w_cap)
    n = planar.shape[1]
    u_cap = _next_pow2(n)
    padded = np.concatenate([planar, jd.max_digest_block(u_cap - n)], axis=1)
    j_universe = jnp.stack(jax.lax.sort([jnp.asarray(padded[lane])
                                         for lane in range(8)],
                                        num_keys=8))
    digests = rows(planar)
    universe = td.max_rows(u_cap, "cpu")
    sort_rows(digests, out=universe[:n], impl="plain")
    assert (td.rows_to_planar(universe) == np.asarray(j_universe)).all()
    want = np.concatenate([np.asarray(jd.searchsorted_left(
        j_universe, jnp.asarray(planar[:, a:b]))) for a, b in (
        (0, r_cap), (r_cap, 2 * r_cap), (2 * r_cap, 2 * r_cap + w_cap),
        (2 * r_cap + w_cap, n))])
    got = td.searchsorted(universe, digests, True).numpy()
    assert (got == want).all()
    two = np.concatenate([
        td.searchsorted(universe, digests[:2 * r_cap], True).numpy(),
        td.searchsorted(universe, digests[2 * r_cap:], True).numpy()])
    assert (two == want).all()
    assert (td._searchsorted_plain(universe, digests, True).numpy()
            == want).all()
    # The batch really repeats endpoints across its sections and holds
    # MAX rows.
    s = jd.planar_to_s24(planar)
    assert np.intersect1d(s[:2 * r_cap], s[2 * r_cap:]).size > 1
    assert (planar == 0xFFFFFFFF).all(axis=0).sum() >= n // 4


def test_rank_count_matches_reference():
    """Positions below 0, inside and past out_len (never counted)."""
    rng = np.random.default_rng(6)
    for out_len in (1, 7, 256):
        pos = rng.integers(-3, out_len + 4, size=500).astype(np.int32)
        want = np.asarray(jd.rank_count(jnp.asarray(pos), out_len))
        got = td.rank_count(torch.from_numpy(pos), out_len).numpy()
        assert got.dtype == np.int32 and (got == want).all()


def test_history_probe_matches_reference():
    """max V over [b, e) across base and delta (reference fused.py:351-355:
    searchsorted_interval + range_max per tier)."""
    rng = np.random.default_rng(8)
    cap, dcap, u = 512, 128, 200
    bk, dk = sorted_table(rng, 300, cap), sorted_table(rng, 60, dcap)
    bv = rng.integers(-(1 << 31) + 1, 1 << 31, size=cap, dtype=np.int64)
    dv = rng.integers(-(1 << 31) + 1, 1 << 31, size=dcap, dtype=np.int64)
    bv, dv = bv.astype(np.int32), dv.astype(np.int32)
    ub = np.concatenate([bk[:, rng.integers(0, 300, size=80)],
                         dk[:, rng.integers(0, 60, size=40)],
                         edge_digests(rng, u - 120)], axis=1)
    ue = ub.copy()
    ue[7] += 1
    jbt, jdt = jax_table(jnp.asarray(bv)), jax_table(jnp.asarray(dv))
    pb, hb = jd.searchsorted_interval(jnp.asarray(bk), jnp.asarray(ub),
                                      jnp.asarray(ue))
    pd, hd = jd.searchsorted_interval(jnp.asarray(dk), jnp.asarray(ub),
                                      jnp.asarray(ue))
    want = np.maximum(np.asarray(jax_range_max(jbt, pb - 1, hb)),
                      np.asarray(jax_range_max(jdt, pd - 1, hd)))
    tb = build_sparse_table(torch.from_numpy(bv))
    tdt = build_sparse_table(torch.from_numpy(dv))
    got = td.history_probe(rows(bk), tb, rows(dk), tdt, rows(ub), rows(ue))
    assert (got.numpy() == want).all()


def test_widen_unique_restores_digests():
    """The compact buffer's unique-key bytes widen back to the exact
    begin digests (end = marker + 1), MAX past u_n."""
    from foundationdb_tpu_torch.conflict import fused
    from foundationdb_tpu_torch.conflict.encoded import EncodedBatch
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    rng = np.random.default_rng(9)
    keys = sorted({bytes(rng.integers(0, 256, size=int(rng.integers(1, 24)),
                                      dtype=np.uint8)) for _ in range(90)})
    enc = EncodedBatch(
        n_txns=len(keys), t_snap=np.zeros(len(keys), np.int64),
        t_has_reads=np.ones(len(keys), bool),
        r_txn=np.arange(len(keys), dtype=np.int32),
        r_begin=td.encode_keys(keys),
        r_end=td.encode_keys([k + b"\x00" for k in keys], round_up=True),
        w_txn=np.zeros(0, np.int32), w_begin=np.zeros((8, 0), np.uint32),
        w_end=np.zeros((8, 0), np.uint32), all_point=True)
    packed = TorchConflictSet._pack_compact(enc)
    t_cap, r_pad, w_pad, u_pad, lw = packed["shapes"]
    lay = fused.compact_layout(t_cap, r_pad, w_pad, u_pad, lw)
    buf = torch.from_numpy(packed["buf"])
    scal = buf.view(torch.int32)[lay["scalars"] // 4:][:6]
    u_b, u_e = td.widen_unique(buf[:u_pad * lw], scal, lw, u_pad)
    want = jd.max_digest_block(u_pad)
    want[:, :len(keys)] = td.encode_keys(keys)
    want_e = want.copy()
    want_e[7, :len(keys)] += 1
    assert (td.rows_to_planar(u_b) == want).all()
    assert (td.rows_to_planar(u_e) == want_e).all()
