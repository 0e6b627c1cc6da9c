"""Lexicographic sort of 8-lane digest rows (device building block).

The counterpart of `jax.lax.sort(lanes [+ tie] [+ payload], num_keys=8[+1])`
in foundationdb_tpu: the endpoint universe of the general step
(conflict/fused.py:524), the begins-first endpoint sweep of _union_ranges
(conflict/window.py:105, an int32 tie key) and window_insert's new
boundaries (conflict/window.py:184, an int32 version payload).

jax.lax.sort is unstable (is_stable=False); this sort is stable.  The two
agree element for element wherever rows with equal keys carry equal
payloads, which holds in every use above:
  * the universe has no payload;
  * in _union_ranges invalid rows are MAX with delta 0, and valid begins
    (tie 0) on one key all carry +1, valid ends (tie 1) all carry -1;
  * in window_insert's second sort the merged begins and the kept ends are
    distinct keys (merged ranges are disjoint and non-touching, and
    EncodedBatch drops empty ranges), and invalid rows are MAX / NEG_INF.

The wrapper runs the plain-torch version for a CPU tensor and the CUDA
kernel csrc/sort.cu (a merge sort of whole rows: a shared-memory tile
sort, then merge-path rounds) for a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels as _k
from .digest import KEY_LANES, ROW_PAD

# csrc/sort.cu's TILE_NV (rows a tile-sort block sorts) and MERGE_NV
# (outputs a merge block writes).
SORT_TILE = 4096
SORT_MERGE_ROWS = 1024


def sort_rounds(n: int) -> int:
    """Merge rounds after the tile sort: the fewest doublings of SORT_TILE
    that reach n.  The kernel makes 1 + 2 * sort_rounds(n) launches a call
    (the tile sort, then a partition and a merge a round)."""
    rounds = 0
    while SORT_TILE << rounds < n:
        rounds += 1
    return rounds


def sort_scratch_ints(n: int) -> int:
    """int32 scratch the kernel needs for n rows: a second rows buffer,
    two tie buffers and a second payload buffer (passes ping-pong), and
    one merge-path split per merge block."""
    return 11 * n + -(-n // SORT_MERGE_ROWS)


def _u32_key(lane: torch.Tensor) -> torch.Tensor:
    """int32 lane bits -> int64 holding the lane as an unsigned value."""
    return lane.to(torch.int64) & 0xFFFFFFFF


def sort_rows(rows: torch.Tensor, tie: Optional[torch.Tensor] = None,
              payload: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None, impl=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort rows int32[N, 8] (uint32 lane bits, lane 0 most significant)
    ascending, then by the optional int32 `tie` (signed), stably; the
    optional int32 `payload` rides along.  Returns (sorted rows, sorted
    payload or None).  `out` (int32[N, 8], contiguous) receives the rows
    when given, e.g. the head of a larger MAX-filled buffer.

    Kernels: so_sort (csrc/sort.cu) enqueues a tile sort and
    sort_rounds(n) merge rounds, 1 + 2 * sort_rounds(n) launches."""
    n = rows.shape[0]
    if out is None:
        out = torch.empty((n, ROW_PAD), dtype=torch.int32,
                          device=rows.device)
    pay_out = None if payload is None else torch.empty_like(payload)
    if n == 0:
        return out, pay_out
    if _k.use_kernel(rows, impl):
        scratch = torch.empty((sort_scratch_ints(n),), dtype=torch.int32,
                              device=rows.device)
        rounds = sort_rounds(n)
        _k.launch("sort_rows", "so_sort", n, rounds, rows, tie, payload, out,
                  pay_out, scratch, count=1 + 2 * rounds)
        return out, pay_out
    # Plain: stable LSD sorts, least significant key first (the tie, then
    # lane pairs 7-6, 5-4, 3-2, 1-0 as one unsigned 64-bit key each).
    perm = torch.arange(n, device=rows.device)
    if tie is not None:
        perm = perm[torch.sort(tie[perm], stable=True).indices]
    for hi in range(KEY_LANES - 2, -1, -2):
        r = rows[perm]
        key = (_u32_key(r[:, hi]) << 32) | _u32_key(r[:, hi + 1])
        # Unsigned 64-bit order as signed: flip the top bit.
        key = key ^ (-(1 << 63))
        perm = perm[torch.sort(key, stable=True).indices]
    out.copy_(rows[perm])
    if payload is not None:
        pay_out.copy_(payload[perm])
    return out, pay_out
