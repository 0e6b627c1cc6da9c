"""The port's ops/segtree.py against foundationdb_tpu/ops/segtree.py:
interval_min_cover, build_min_table and range_min on the same seeded
inputs (intervals inside, across and outside the universe, empty and
inverted spans, invalid ones; empty and full query ranges).  Integer data:
tolerance 0.  The CUDA form of these phases lives inside the general
step's fixpoint kernel (tests/test_torch_kernels.py)."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import segtree as js
from foundationdb_tpu_torch.ops import segtree as ts

LOG_U = 7
U = 1 << LOG_U


@lru_cache(maxsize=None)
def jax_cover():
    return jax.jit(lambda l, r, w, v: js.interval_min_cover(l, r, w, v,
                                                            LOG_U))


def spans(rng, n: int):
    l = rng.integers(-5, U + 5, size=n).astype(np.int32)
    r = (l + rng.integers(-3, 12, size=n)).astype(np.int32)
    w = rng.integers(0, 1000, size=n).astype(np.int32)
    valid = rng.random(n) < 0.8
    return l, r, w, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_min_cover_matches_reference(seed):
    l, r, w, valid = spans(np.random.default_rng(seed), 30)
    want = jax_cover()(jnp.asarray(l), jnp.asarray(r), jnp.asarray(w),
                       jnp.asarray(valid))
    got = ts.interval_min_cover(torch.from_numpy(l), torch.from_numpy(r),
                                torch.from_numpy(w), torch.from_numpy(valid),
                                LOG_U)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == ts.INF_I32).any() and (got.numpy() < 1000).any()


def test_min_table_and_range_min_match_reference():
    rng = np.random.default_rng(3)
    l, r, w, valid = spans(rng, 60)
    cover = np.array(jax_cover()(jnp.asarray(l), jnp.asarray(r),
                                   jnp.asarray(w), jnp.asarray(valid)))
    want_table = np.asarray(js.build_min_table(jnp.asarray(cover)))
    got_table = ts.build_min_table(torch.from_numpy(cover))
    np.testing.assert_array_equal(got_table.numpy(), want_table)
    lo = rng.integers(0, U + 1, size=300).astype(np.int32)
    hi = np.clip(lo + rng.integers(-4, 60, size=300), 0, U).astype(np.int32)
    lo[:3], hi[:3] = (0, 5, U), (U, 5, U)      # full and empty ranges
    want = js.range_min(jnp.asarray(want_table), jnp.asarray(lo),
                        jnp.asarray(hi))
    got = ts.range_min(got_table, torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == ts.INF_I32


def test_plain_phases_refuse_cuda_tensors_without_plain():
    """The phases have no launch of their own on the card."""
    class FakeCuda:
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="interval_fixpoint"):
        ts.build_min_table(FakeCuda())
