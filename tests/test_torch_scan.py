"""The port's ops/scan.py (inclusive scan, order-preserving row compaction
with the merge's rebase) against the JAX expressions it replaces in
foundationdb_tpu/conflict/fused.py: jnp.cumsum and the rank scatter
`.at[where(keep, rank, n)].set(rows, mode="drop")`, with
`jnp.maximum(v - rebase, NEG_INF + 1)` wrapping in int32 (fused.py:669)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops.rangemax import NEG_INF
from foundationdb_tpu_torch.ops import scan


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_inclusive_scan_matches_cumsum(n):
    x = np.random.default_rng(n).integers(-3, 4, size=n).astype(np.int32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    got = scan.inclusive_scan(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and (got == want).all()


@pytest.mark.parametrize("rebase", [None, 0, 1500, 100])
def test_compact_rows_matches_rank_scatter(rebase):
    """Kept rows land at their rank, writes past the end are dropped, and
    the rebase subtracts before it clamps (NEG_INF + 5 - 100 wraps)."""
    rng = np.random.default_rng(7)
    n, n_dst = 600, 250                      # more kept rows than n_dst
    keep = (rng.random(n) < 0.6).astype(np.int32)
    rows = rng.integers(-(1 << 31), 1 << 31, size=(n, 8)).astype(np.int32)
    vals = rng.integers(-(1 << 31) + 1, 1 << 31, size=n).astype(np.int32)
    vals[:20] = int(NEG_INF) + 5
    rank = jnp.cumsum(jnp.asarray(keep)) - 1
    dst = jnp.where(jnp.asarray(keep) != 0, rank, n_dst)
    v = jnp.asarray(vals)
    if rebase is not None:
        v = jnp.maximum(v - rebase, NEG_INF + 1)
    want_rows = jnp.full((n_dst, 8), -1, jnp.int32).at[dst].set(
        jnp.asarray(rows), mode="drop")
    want_v = jnp.full((n_dst,), 7, jnp.int32).at[dst].set(v, mode="drop")

    keep_t = torch.from_numpy(keep)
    incl = scan.inclusive_scan(keep_t)
    got_rows = torch.full((n_dst, 8), -1, dtype=torch.int32)
    got_v = torch.full((n_dst,), 7, dtype=torch.int32)
    scan.compact_rows(keep_t, incl, torch.from_numpy(rows),
                      torch.from_numpy(vals), got_rows, got_v, rebase=rebase)
    assert (got_rows.numpy() == np.asarray(want_rows)).all()
    assert (got_v.numpy() == np.asarray(want_v)).all()
    if rebase == 100:
        assert (got_v.numpy()[:3] > (1 << 30)).any()   # the wrap


def test_scatter_drop_semantics():
    """Negative indices count from the end, anything still outside the
    array is dropped: .at[idx].set / .max(mode="drop")."""
    idx = np.array([0, -1, 5, 9, -12, 3], np.int32)
    src = np.array([4, 5, 6, 7, 8, 9], np.int32)
    want_set = np.asarray(jnp.zeros(6, jnp.int32).at[jnp.asarray(idx)].set(
        jnp.asarray(src), mode="drop"))
    want_max = np.asarray(jnp.zeros(6, jnp.int32).at[jnp.asarray(idx)].max(
        jnp.asarray(src), mode="drop"))
    got_set = scan.scatter_set(torch.zeros(6, dtype=torch.int32),
                               torch.from_numpy(idx), torch.from_numpy(src))
    got_max = scan.scatter_max(torch.zeros(6, dtype=torch.int32),
                               torch.from_numpy(idx), torch.from_numpy(src))
    assert (got_set.numpy() == want_set).all()
    assert (got_max.numpy() == want_max).all()
