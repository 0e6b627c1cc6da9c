"""Static-shape interval min-cover structure (foundationdb_tpu/ops/segtree.py).

For a universe of U elementary gaps and weighted intervals (span [l, r),
weight w), answers "min weight over intervals overlapping gap range
[a, b)".  The general step's intra-batch pass uses it with the writer's
transaction index as the weight: a read conflicts iff the least
overlapping writer precedes it in the batch.

  * interval_min_cover: each interval min-updates <= 2 nodes per level of
    an iterative segment tree, then a top-down pushdown gives
    cover[g] = min weight over intervals covering gap g;
  * build_min_table / range_min: the doubling range-max table over the
    negated cover (min(x) == -max(-x); -INF_I32 == NEG_INF, so the
    sentinels map onto each other).

These are the plain-torch versions.  On the card the three phases run
inside one kernel, the persistent Jacobi fixpoint of the general step
(conflict/fused.py interval_fixpoint, csrc/segtree.cu), which has no
launch per phase; so each function here refuses a CUDA tensor unless
impl="plain".
"""

from __future__ import annotations

import torch

from .rangemax import build_sparse_table, range_max

INF_I32 = (1 << 31) - 1


def _plain_only(t: torch.Tensor, impl, name: str) -> None:
    if t.device.type == "cuda" and impl != "plain":
        raise ValueError(f"{name}: on the card this phase runs inside the "
                         "interval_fixpoint kernel; pass impl='plain' for "
                         "the plain version")


def interval_min_cover(l: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                       valid: torch.Tensor, log_u: int,
                       impl=None) -> torch.Tensor:
    """cover[g] = min{w[i] : valid[i] and l[i] <= g < r[i]} (INF if none).

    l, r: int32[N] spans over [0, U) with U = 1 << log_u; w: int32[N];
    valid: bool or int32 0/1 [N].  Returns int32[U]."""
    _plain_only(l, impl, "interval_min_cover")
    u = 1 << log_u
    dev = l.device
    tree = torch.full((2 * u,), INF_I32, dtype=torch.int32, device=dev)
    valid = valid != 0
    wv = torch.where(valid & (l < r), w, INF_I32).to(torch.int32)
    li = torch.clamp(l, 0, u) + u
    ri = torch.clamp(r, 0, u) + u
    inf = torch.full_like(wv, INF_I32)
    # At each level an odd left cursor contributes node li (then li += 1),
    # an odd right cursor node ri - 1 (then ri -= 1); both then halve.
    # Untaken updates go to node 0, which is unused padding.
    for _ in range(log_u + 1):
        active = li < ri
        take_l = active & ((li & 1) == 1)
        take_r = active & ((ri & 1) == 1)
        idx_l = torch.where(take_l, li, 0).long()
        idx_r = torch.where(take_r, ri - 1, 0).long()
        tree.scatter_reduce_(0, idx_l, torch.where(take_l, wv, inf), "amin")
        tree.scatter_reduce_(0, idx_r, torch.where(take_r, wv, inf), "amin")
        li = (li + (li & 1)) >> 1
        ri = (ri - (ri & 1)) >> 1
    # Pushdown: children inherit parent minima level by level.
    for level in range(1, log_u + 1):
        lo = 1 << level
        parents = tree[lo >> 1:lo]
        tree[lo:2 * lo] = torch.minimum(tree[lo:2 * lo],
                                        parents.repeat_interleave(2))
    return tree[u:2 * u].clone()


def build_min_table(values: torch.Tensor, impl=None) -> torch.Tensor:
    """Doubling sparse table for range-MIN: the range-max table over the
    negated values.  Pair only with range_min below."""
    _plain_only(values, impl, "build_min_table")
    return build_sparse_table(-values, impl="plain")


def range_min(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              impl=None) -> torch.Tensor:
    """Per-query min(values[lo:hi]) over a build_min_table table; empty
    ranges give INF_I32.  lo, hi: int32[N] with 0 <= lo, hi <= CAP."""
    _plain_only(table, impl, "range_min")
    return -range_max(table, lo, hi)
