"""Key-range shard helpers: clip to a shard, combine partials, commit.

What the key-range-sharded programs of foundationdb_tpu/parallel/ add to
the one-device conflict path (conflict/fused.py's `axis_name` branches and
parallel/sharded_window.py):

  clip_rows      clip digest ranges to a shard's [lo, hi) bounds, with the
                 owned mask (clipped begin < clipped end) and the separate
                 begin-in-[lo, hi) mask
  shard_combine  the collectives over mesh axis "kr" (pmax / psum): D
                 per-shard partials of n to [n], by max or by sum per
                 column, each read where it lies
  shard_commit   the window insert's mesh-wide all-or-nothing: with the
                 combined overflow set, put a shard's pre-insert state back

The reference runs these inside shard_map on every device of the mesh; the
port runs one process that holds every shard (parallel/), so a collective
becomes one kernel on the mesh's first device over the shards' partials
(a partial on another device is copied there first).  Each
function is a wrapper with a plain-torch version, taken for CPU tensors and
with impl="plain", and a hand-written CUDA kernel (csrc/shard.cu) for CUDA
tensors.  Digests are rows int32[N, 8] (ops/digest.py); masks int32 0/1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .. import kernels as _k
from .digest import ROW_PAD, lex_less, lex_max_rows, lex_min_rows


def clip_rows(b: torch.Tensor, e: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, valid: Optional[torch.Tensor] = None,
              impl=None) -> Tuple[torch.Tensor, ...]:
    """Clip ranges [b, e) (rows int32[N, 8]) to a shard's bounds [lo, hi)
    (rows int32[8]): (cb = max(b, lo), ce = min(e, hi), owned, b_in), where
    owned = valid & (cb < ce) is whether any of the range lies in the
    shard (reference parallel/sharded_window.py:166-168, conflict/fused.py
    :344-346, :489-491, :553-555) and b_in = lo <= b < hi is whether the
    range's begin does (fused.py:391-393, the point insert's ownership).
    The two masks differ for a range that straddles lo.  Kernel: sh_clip."""
    n = b.shape[0]
    dev = b.device
    if _k.use_kernel(b, impl):
        e_ = dict(dtype=torch.int32, device=dev)
        cb = torch.empty((n, ROW_PAD), **e_)
        ce = torch.empty((n, ROW_PAD), **e_)
        owned = torch.empty((n,), **e_)
        b_in = torch.empty((n,), **e_)
        _k.launch("clip_rows", "sh_clip", n, b, e, lo, hi, valid, cb, ce,
                  owned, b_in)
        return cb, ce, owned, b_in
    cb = lex_max_rows(b, lo)
    ce = lex_min_rows(e, hi)
    owned = lex_less(cb, ce)
    if valid is not None:
        owned = owned & (valid != 0)
    lo_b, hi_b = lo.expand_as(b), hi.expand_as(b)
    b_in = ~lex_less(b, lo_b) & lex_less(b, hi_b)
    return cb, ce, owned.to(torch.int32), b_in.to(torch.int32)


# Partials one sh_combine launch takes (csrc/shard.cu COMBINE_MAX).
COMBINE_MAX = 8


def shard_combine(parts: Union[torch.Tensor, Sequence[torch.Tensor]],
                  n_max: Optional[int] = None,
                  out: Optional[torch.Tensor] = None,
                  impl=None) -> torch.Tensor:
    """D int32 per-shard partials of n -> [n]: columns below n_max (all of
    them by default) by max, the rest by sum, wrapping as int32 (the
    reference's pmax / psum over "kr").  parts is an int32[D, n] tensor or
    a list of D int32[n] tensors (views at any offset).  The result lies
    on out's device when `out` is given (and is written there), else on
    the first partial's.  Kernel: sh_combine, one launch that reads each
    partial in place (D <= COMBINE_MAX, each contiguous); a partial on
    another device is copied to the result's once, non-blocking."""
    parts = list(parts)
    n = parts[0].shape[0]
    n_max = n if n_max is None else int(n_max)
    dev = parts[0].device if out is None else out.device
    if out is None:
        out = torch.empty((n,), dtype=torch.int32, device=dev)
    if not _k.use_kernel(out, impl):
        stack = torch.stack([p.to(dev) for p in parts])
        out[:n_max] = stack[:, :n_max].amax(dim=0)
        out[n_max:] = stack[:, n_max:].sum(dim=0, dtype=torch.int32)
        return out
    if len(parts) > COMBINE_MAX or any(p.shape != (n,) for p in parts):
        raise ValueError(f"shard_combine: at most {COMBINE_MAX} partials of "
                         f"shape ({n},) on the card, got "
                         f"{[tuple(p.shape) for p in parts]}")
    ptrs = [p if p.device == dev else p.to(dev, non_blocking=True)
            for p in parts]
    ptrs += [None] * (COMBINE_MAX - len(ptrs))
    _k.launch("shard_combine", "sh_combine", *ptrs, len(parts), n, n_max,
              out)
    return out


def shard_commit(ovf: torch.Tensor, saved, state, impl=None) -> None:
    """All-or-nothing across shards (reference sharded_window.py:184-186):
    where the combined overflow ovf (int32[1]) is set, state (bk, bv,
    size) is overwritten IN PLACE by the pre-insert copy `saved`; decided
    on the device, with no host sync.  Kernel: sh_commit."""
    bk, bv, size = state
    if _k.use_kernel(bk, impl):
        _k.launch("shard_commit", "sh_commit", ovf, bk.shape[0], saved[0],
                  saved[1], saved[2], bk, bv, size)
        return
    put_back = ovf != 0
    for dst, src in zip(state, saved):
        dst.copy_(torch.where(put_back.view((1,) * dst.dim()), src, dst))
