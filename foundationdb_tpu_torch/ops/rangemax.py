"""Batched range-maximum queries via a sparse table.

Segment versions live in a flat int32[CAP] array; the doubling table
M[j][i] = max(v[i .. i+2^j)) answers each query [lo, hi) with two gathers:
max(M[j][lo], M[j][hi - 2^j]) where j = floor(log2(hi - lo))
(foundationdb_tpu/ops/rangemax.py).  build_sparse_table is a wrapper over
the plain-torch version and the CUDA kernel csrc/sparse_table.cu; on the
card range_max runs fused into the history probe (csrc/digest_search.cu),
and the plain range_max here is its reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels as _k

NEG_INF = -(1 << 31) + 1


def table_levels(cap: int) -> int:
    """Number of rows of the table for a CAP-long value array (LOG+1)."""
    return max((cap - 1).bit_length(), 1) + 1


def tile_log(cap: int) -> int:
    """log2 of the outputs one block of the kernel's first launch owns
    (csrc/sparse_table.cu st_tile): 2,048 up to 2^19 (more blocks for a
    small table), 4,096 above, 16,384 past 2^27, where the second launch's
    strided sequences would outgrow shared memory."""
    if cap <= 1 << 19:
        return 11
    return 12 if cap <= 1 << 27 else 14


def build_sparse_table(values: torch.Tensor,
                       out: Optional[torch.Tensor] = None,
                       impl=None) -> torch.Tensor:
    """values: int32[CAP] -> M: int32[LOG+1, CAP], for any CAP >= 1 (the
    callers' are powers of two).

    `out` (int32[LOG+1, CAP]) is written in place when given, the way the
    reference's donated buffers are reused.  Kernels: st_tile (the rows up
    to log2 of its tile), then st_high (the rest) when CAP exceeds a tile:
    at most two launches a call."""
    cap = values.shape[0]
    levels = table_levels(cap)
    if out is None:
        out = torch.empty((levels, cap), dtype=torch.int32,
                          device=values.device)
    if _k.use_kernel(values, impl):
        tl = tile_log(cap)
        _k.launch("build_sparse_table", "st_tile", values, out, cap, tl)
        if cap > 1 << tl:
            _k.launch("build_sparse_table", "st_high", out, cap, tl)
        return out
    rows = [values]
    cur = values
    for j in range(levels - 1):
        shift = 1 << j
        shifted = torch.cat([
            cur[shift:],
            torch.full((min(shift, cap),), NEG_INF, dtype=cur.dtype,
                       device=cur.device)])[:cap]
        cur = torch.maximum(cur, shifted)
        rows.append(cur)
    out.copy_(torch.stack(rows))
    return out


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x >= 1, exactly (31 - clz(x))."""
    j = torch.zeros_like(x)
    for k in range(1, 31):
        j = j + (x >= (1 << k)).to(x.dtype)
    return j


def _gather_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """JAX gather semantics: a negative index counts from the end, then
    the index is clamped into [0, n-1]."""
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1).long()


def range_max(table: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Per-query max(values[lo:hi]); empty ranges (hi<=lo) -> NEG_INF."""
    cap = table.shape[1]
    length = hi - lo
    valid = length > 0
    j = _floor_log2(torch.clamp(length, min=1))
    jl = j.long()
    left = table[jl, _gather_index(lo, cap)]
    right_i = torch.clamp(hi - torch.bitwise_left_shift(torch.ones_like(j), j),
                          min=0)
    right = table[jl, _gather_index(right_i, cap)]
    return torch.where(valid, torch.maximum(left, right),
                       torch.full_like(left, NEG_INF))
