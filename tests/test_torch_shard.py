"""ops/shard.py (and the row clips of ops/digest.py) against the JAX
package's clip and collectives, exactly.

clip_rows is held against the reference's lex_max_cols / lex_min_cols /
lex_less (ops/digest.py) and its begin-in-bounds mask against the one of
conflict/fused.py:391-393, with digest lanes at the edges of the uint32
order (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, MAX) where a signed
compare would go wrong.  shard_combine is held against the pmax / psum
over the shard axis (a max or a wrapping int32 sum), in its [D, n] form
and over a list of views read in place, shard_commit against
the reference's jnp.where(ovf_any, old, new).  Integer data: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import digest as jd
from foundationdb_tpu_torch.conflict.window import (WindowState,
                                                    make_window_state)
from foundationdb_tpu_torch.ops import digest as td
from foundationdb_tpu_torch.ops.shard import (clip_rows, shard_combine,
                                              shard_commit)

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                np.uint32)


def edge_planar(rng, n):
    """uint32[8, n] digests drawn from the edge lanes."""
    return EDGE[rng.integers(0, EDGE.size, size=(8, n))]


def rows(planar) -> torch.Tensor:
    return torch.from_numpy(td.planar_to_rows(planar))


def row(lanes) -> torch.Tensor:
    return torch.from_numpy(np.asarray(lanes, np.uint32).view(np.int32))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_clip_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    b, e = edge_planar(rng, n), edge_planar(rng, n)
    lo, hi = sorted((edge_planar(rng, 1)[:, 0], edge_planar(rng, 1)[:, 0]),
                    key=lambda x: tuple(x))
    valid = rng.random(n) < 0.8
    cb, ce, owned, b_in = clip_rows(rows(b), rows(e), row(lo), row(hi),
                                    valid=torch.from_numpy(
                                        valid.astype(np.int32)))
    jcb = jd.lex_max_cols(jnp.asarray(b), jnp.asarray(lo))
    jce = jd.lex_min_cols(jnp.asarray(e), jnp.asarray(hi))
    np.testing.assert_array_equal(td.rows_to_planar(cb), np.asarray(jcb))
    np.testing.assert_array_equal(td.rows_to_planar(ce), np.asarray(jce))
    np.testing.assert_array_equal(
        owned.numpy(), np.asarray(jd.lex_less(jcb, jce)) & valid)
    lo_bc = jnp.broadcast_to(jnp.asarray(lo)[:, None], b.shape)
    hi_bc = jnp.broadcast_to(jnp.asarray(hi)[:, None], b.shape)
    want_in = ~jd.lex_less(jnp.asarray(b), lo_bc) & jd.lex_less(
        jnp.asarray(b), hi_bc)
    np.testing.assert_array_equal(b_in.numpy(), np.asarray(want_in))
    # Without `valid`, owned is the clip's non-emptiness alone.
    owned_all = clip_rows(rows(b), rows(e), row(lo), row(hi))[2]
    np.testing.assert_array_equal(owned_all.numpy(),
                                  np.asarray(jd.lex_less(jcb, jce)))


def test_clip_rows_masks_differ_on_a_straddling_range():
    """A range that begins below lo and ends inside the shard is owned
    (some of it lies there) but its begin is not in bounds."""
    lo, hi = row([0x80000000] + [0] * 7), row([0xFFFFFFFF] * 8)
    b = row([0x7FFFFFFF] + [0xFFFFFFFF] * 7)[None]
    e = row([0x80000000, 5] + [0] * 6)[None]
    cb, ce, owned, b_in = clip_rows(b, e, lo, hi)
    assert torch.equal(cb[0], lo) and torch.equal(ce[0], e[0])
    assert owned.tolist() == [1] and b_in.tolist() == [0]


@pytest.mark.parametrize("d,n_max", [(1, None), (4, None), (4, 2), (8, 0)])
def test_shard_combine_max_and_wrapping_sum(d, n_max):
    rng = np.random.default_rng(d)
    n = 37
    parts = rng.integers(-(1 << 31), 1 << 31, size=(d, n), dtype=np.int64)
    parts[:, :3] = [0x7FFFFFFF, -(1 << 31), 0x40000000]
    parts = parts.astype(np.int32)
    got = shard_combine(torch.from_numpy(parts), n_max).numpy()
    k = n if n_max is None else n_max
    np.testing.assert_array_equal(got[:k], parts[:, :k].max(axis=0))
    np.testing.assert_array_equal(got[k:], parts[:, k:].sum(
        axis=0, dtype=np.int32))
    out = torch.full((n,), 7, dtype=torch.int32)
    assert shard_combine(torch.from_numpy(parts), n_max, out=out) is out
    np.testing.assert_array_equal(out.numpy(), got)


def reference_combine(parts: np.ndarray, n_max: int) -> np.ndarray:
    """The reference's collectives over a named shard axis: pmax on the
    columns below n_max, psum (wrapping int32) on the rest."""
    import jax

    def collect(x):
        return jnp.concatenate([jax.lax.pmax(x[:n_max], "kr"),
                                jax.lax.psum(x[n_max:], "kr")])

    return np.asarray(jax.vmap(collect, axis_name="kr")(
        jnp.asarray(parts)))[0]


@pytest.mark.parametrize("n_max", [None, 0, 2])
@pytest.mark.parametrize("d", [1, 4, 8])
def test_shard_combine_reads_views_in_place(d, n_max):
    """A list of D partials that are views of larger buffers at odd
    offsets, with odd gaps between them and one with an element stride,
    combines as the [D, n] form does and as the reference's pmax / psum,
    sums wrapping as int32."""
    rng = np.random.default_rng(10 + d)
    n = 41
    parts = rng.integers(-(1 << 31), 1 << 31, size=(d, n),
                         dtype=np.int64).astype(np.int32)
    parts[:, :3] = [0x7FFFFFFF, -(1 << 31), 0x40000000]  # sums wrap
    flat = torch.from_numpy(rng.integers(-9, 9, size=7 * d * n + 50,
                                         dtype=np.int32))
    views, at = [], 3
    for k in range(d):
        if k == 1:  # every third element of another buffer
            view = torch.zeros((3 * n + 5,), dtype=torch.int32)[1::3][:n]
        else:
            view = flat[at:at + n]
            at += n + 2 * k + 5
        view.copy_(torch.from_numpy(parts[k]))
        views.append(view)
    stacked = torch.from_numpy(parts)
    k = n if n_max is None else n_max
    want = reference_combine(parts, k)
    got = shard_combine(views, n_max)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(shard_combine(stacked, n_max).numpy(),
                                  want)
    np.testing.assert_array_equal(got.numpy()[k:], parts[:, k:].sum(
        axis=0, dtype=np.int32))
    out = torch.full((n,), 7, dtype=torch.int32)
    assert shard_combine(views, n_max, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    for view, row_ in zip(views, parts):  # the partials are only read
        np.testing.assert_array_equal(view.numpy(), row_)


@pytest.mark.parametrize("ovf", [0, 1])
def test_shard_commit_puts_the_saved_state_back(ovf):
    rng = np.random.default_rng(ovf)
    saved = make_window_state(64, 3, "cpu")
    state = WindowState(
        torch.from_numpy(rng.integers(-9, 9, size=(64, 8), dtype=np.int32)),
        torch.from_numpy(rng.integers(-9, 9, size=64, dtype=np.int32)),
        torch.tensor([17], dtype=torch.int32))
    before = [t.clone() for t in state]
    want = [np.asarray(jnp.where(bool(ovf), jnp.asarray(s.numpy()),
                                 jnp.asarray(n.numpy())))
            for s, n in zip(saved, before)]
    shard_commit(torch.tensor([ovf], dtype=torch.int32), saved, state)
    for got, w in zip(state, want):
        np.testing.assert_array_equal(got.numpy(), w)


def test_lex_max_min_rows_match_reference():
    rng = np.random.default_rng(4)
    a = edge_planar(rng, 200)
    r = edge_planar(rng, 1)[:, 0]
    np.testing.assert_array_equal(
        td.rows_to_planar(td.lex_max_rows(rows(a), row(r))),
        np.asarray(jd.lex_max_cols(jnp.asarray(a), jnp.asarray(r))))
    np.testing.assert_array_equal(
        td.rows_to_planar(td.lex_min_rows(rows(a), row(r))),
        np.asarray(jd.lex_min_cols(jnp.asarray(a), jnp.asarray(r))))
