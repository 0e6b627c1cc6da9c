"""Inclusive scans and masked row compaction (device building blocks).

The reference leans on jnp.cumsum and on order-preserving rank scatters
(`.at[where(keep, rank, n)].set(rows, mode="drop")`) throughout
conflict/fused.py.  Here each is a wrapper with a plain-torch version and a
CUDA kernel (csrc/rank_scan.cu): a single-pass scan with decoupled
look-back, and a guarded row store that follows JAX's drop semantics.
No path of the conflict code launches either kernel (the programs scan and
compact inside their own kernels, window_gc among them); the plain
versions serve the plain programs.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels as _k
from .rangemax import NEG_INF

SCAN_TILE = 8192  # elements per tile of rs_scan (csrc/rank_scan.cu SCAN_TILE)
_MAX_TILES = (1 << 31) - 1  # the grid's x dimension, and the tile ticket


def inclusive_scan(x: torch.Tensor, impl=None) -> torch.Tensor:
    """Inclusive prefix sum of int32[n] -> new int32[n], wrapping in int32.
    Kernel: rs_scan, one single-pass launch for any n (decoupled
    look-back over per-tile descriptors in a zeroed per-call scratch)."""
    if not _k.use_kernel(x, impl):
        return torch.cumsum(x, 0, dtype=torch.int32)
    if x.dtype != torch.int32:
        raise ValueError(f"inclusive_scan: the kernel scans int32, got "
                         f"{x.dtype}")
    n = x.numel()
    tiles = max(1, (n + SCAN_TILE - 1) // SCAN_TILE)
    if tiles > _MAX_TILES:
        raise ValueError(f"inclusive_scan: {n} elements exceed one grid of "
                         f"{_MAX_TILES} tiles")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    scratch = torch.zeros((1 + tiles,), dtype=torch.int64, device=x.device)
    _k.launch("inclusive_scan", "rs_scan", x, out, n, scratch)
    return out


def drop_index(idx: torch.Tensor, n: int):
    """JAX scatter-index semantics for mode="drop": a negative index counts
    from the end; whatever is still outside [0, n) is dropped.  Returns
    (index as int64, mask of writes that land)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def scatter_set(dst: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """dst.at[idx].set(src, mode="drop") in place (plain)."""
    i, ok = drop_index(idx, dst.shape[0])
    dst[i[ok]] = src[ok]
    return dst


def scatter_max(dst: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """dst.at[idx].max(src, mode="drop") in place (plain, int32)."""
    i, ok = drop_index(idx, dst.shape[0])
    dst.scatter_reduce_(0, i[ok], src[ok].to(dst.dtype), "amax")
    return dst


def rebase_versions(v: torch.Tensor, rebase: int) -> torch.Tensor:
    """max(v - rebase, NEG_INF + 1) with the subtraction wrapping in int32
    two's complement, bit for bit as the reference's merge computes it
    (conflict/fused.py:669 subtracts before it clamps)."""
    w = v.to(torch.int64) - int(rebase)
    w = torch.remainder(w + (1 << 31), 1 << 32) - (1 << 31)
    return torch.clamp(w, min=NEG_INF + 1).to(torch.int32)


def compact_rows(keep: torch.Tensor, incl: torch.Tensor,
                 src_rows: torch.Tensor, src_v: Optional[torch.Tensor],
                 dst_rows: torch.Tensor, dst_v: Optional[torch.Tensor],
                 rebase: Optional[int] = None, impl=None) -> None:
    """Order-preserving compaction in place: for every i with keep[i],
    dst[incl[i] - 1] = src[i] (rows and values), writes past the end of
    dst dropped; incl is the inclusive scan of keep.  src_v / dst_v may
    both be None (rows only).  With `rebase` the values are rebased as
    rebase_versions does.  Kernel: rs_compact."""
    n_dst = dst_rows.shape[0]
    if _k.use_kernel(keep, impl):
        _k.launch("compact_rows", "rs_compact", keep.numel(), keep, incl,
                  src_rows, src_v, dst_rows, dst_v, n_dst,
                  int(rebase or 0), int(rebase is not None))
        return
    idx = torch.where(keep != 0, incl - 1, n_dst)
    scatter_set(dst_rows, idx, src_rows)
    if src_v is not None:
        vals = src_v if rebase is None else rebase_versions(src_v, rebase)
        scatter_set(dst_v, idx, vals)
