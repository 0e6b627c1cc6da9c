"""The port's ops/rangemax.py against foundationdb_tpu/ops/rangemax.py:
the doubling table (every CAP from 1 to 2^12) and the range-max queries,
exactly, including empty and inverted ranges (NEG_INF) and values at the
int32 extremes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import rangemax as jr
from foundationdb_tpu_torch.ops import rangemax as tr


def values(rng, cap: int) -> np.ndarray:
    v = rng.integers(-(1 << 31), 1 << 31, size=cap, dtype=np.int64)
    v[rng.random(cap) < 0.2] = int(jr.NEG_INF)
    v[rng.random(cap) < 0.05] = (1 << 31) - 1
    v[rng.random(cap) < 0.05] = -(1 << 31)
    return v.astype(np.int32)


@pytest.mark.parametrize("cap", [1 << k for k in range(13)])
def test_build_sparse_table_matches_reference(cap):
    v = values(np.random.default_rng(cap), cap)
    want = np.asarray(jr.build_sparse_table(jnp.asarray(v)))
    got = tr.build_sparse_table(torch.from_numpy(v))
    assert tuple(got.shape) == want.shape == (tr.table_levels(cap), cap)
    assert (got.numpy() == want).all()
    # In place into a given buffer, as the delta table is refreshed.
    out = torch.full(want.shape, 7, dtype=torch.int32)
    assert tr.build_sparse_table(torch.from_numpy(v), out=out) is out
    assert (out.numpy() == want).all()


def test_build_sparse_table_every_cap_to_4096():
    """Every CAP from 1 to 2^12.  The reference's table of v with NEG_INF
    from position c on, cut to c columns and table_levels(c) rows, is its
    table of v[:c]: a window running past c meets NEG_INF either way (the
    shifted concatenate's fill).  So one vmapped reference call at 2^12
    covers a chunk of CAPs; the power-of-two cases above call it at their
    own CAP."""
    full, chunk = 1 << 12, 256
    ref = jax.jit(jax.vmap(jr.build_sparse_table))
    rng = np.random.default_rng(12)
    for first in range(1, full + 1, chunk):
        caps = np.arange(first, min(first + chunk, full + 1))
        v = values(rng, caps.size * full).reshape(caps.size, full)
        v[np.arange(full)[None, :] >= caps[:, None]] = int(jr.NEG_INF)
        want = np.asarray(ref(jnp.asarray(v)))
        for k, cap in enumerate(caps.tolist()):
            got = tr.build_sparse_table(torch.from_numpy(v[k, :cap].copy()))
            assert (got.numpy()
                    == want[k, :tr.table_levels(cap), :cap]).all(), cap


@pytest.mark.parametrize("cap", [2, 64, 1024])
def test_range_max_matches_reference(cap):
    """Random [lo, hi) with 0 <= lo, hi <= cap: empty (lo == hi) and
    inverted (hi < lo) ranges give NEG_INF, full ranges the global max."""
    rng = np.random.default_rng(cap + 1)
    v = values(rng, cap)
    lo = rng.integers(0, cap + 1, size=600).astype(np.int32)
    hi = rng.integers(0, cap + 1, size=600).astype(np.int32)
    lo[:50], hi[:50] = lo[50:100], lo[50:100]          # empty
    lo[100:110], hi[100:110] = 0, cap                  # everything
    want = np.asarray(jr.range_max(jr.build_sparse_table(jnp.asarray(v)),
                                   jnp.asarray(lo), jnp.asarray(hi)))
    table = tr.build_sparse_table(torch.from_numpy(v))
    got = tr.range_max(table, torch.from_numpy(lo), torch.from_numpy(hi))
    assert (got.numpy() == want).all()
    assert (got.numpy()[:50] == int(jr.NEG_INF)).all()
    assert (got.numpy()[100:110] == v.max()).all()


def test_range_max_negative_lo_follows_jax_gather():
    """lo = -1 (a begin probe of 0 minus one) wraps to the last entry and
    clamps, as a JAX gather does."""
    v = values(np.random.default_rng(5), 16)
    lo = np.array([-1, -1, 0], np.int32)
    hi = np.array([3, 0, 16], np.int32)
    want = np.asarray(jr.range_max(jr.build_sparse_table(jnp.asarray(v)),
                                   jnp.asarray(lo), jnp.asarray(hi)))
    got = tr.range_max(tr.build_sparse_table(torch.from_numpy(v)),
                       torch.from_numpy(lo), torch.from_numpy(hi))
    assert (got.numpy() == want).all()
