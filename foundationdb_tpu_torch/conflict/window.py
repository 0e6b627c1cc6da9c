"""Device-resident conflict window: sorted segment arrays and their programs.

The reference skip list (fdbserver/SkipList.cpp) maintains a piecewise-
constant function V(key) = version of the last write covering key.  Here,
as in foundationdb_tpu/conflict/window.py, that function is a pair of
capacity-padded arrays on the device:

    bk: int32[CAP, 8]  sorted boundary digests as rows (ops/digest.py;
                       padding = MAX_DIGEST rows)
    bv: int32[CAP]     version of segment [bk[i], bk[i+1]) (pad NEG_INF)
    size: int32[1]     live boundary count

Versions are int32 offsets from a host-held base.  Three programs:

  window_query   batched "max V over [begin, end) > snapshot" checks
  window_insert  union of the surviving write ranges, then a parallel
                 sorted merge into the boundary arrays
  window_gc      removeBefore (merge adjacent sub-floor segments) and the
                 version rebase

Idiomatic PyTorch: window_insert and window_gc update the state's tensors
IN PLACE and return them (the reference returns new arrays).  Each program
is a wrapper with a plain-torch version, taken for CPU tensors and with
impl="plain", and hand-written CUDA kernels (csrc/window.cu and
csrc/insert.cu, with the sort and the sparse table of ops/) for CUDA
tensors.  Booleans are int32 0/1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import kernels as _k
from ..ops.digest import (ROW_PAD, lex_eq, max_rows, planar_to_rows,
                          rank_count, rows_to_planar, searchsorted)
from ..ops.rangemax import NEG_INF, build_sparse_table, range_max
from ..ops.scan import compact_rows, inclusive_scan, scatter_set
from ..ops.sort import sort_rows


class WindowState(NamedTuple):
    bk: torch.Tensor    # int32[CAP, 8]
    bv: torch.Tensor    # int32[CAP]
    size: torch.Tensor  # int32[1]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `device` as given, or `cuda` when
    it is None.  With no device given and no CUDA device present this
    raises; nothing falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain-torch versions on the CPU")
        device = "cuda"
    return torch.device(device)


def make_window_state(cap: int, init_version_rel: int = 0, device=None,
                      first: Optional[torch.Tensor] = None) -> WindowState:
    """One segment covering all keys at init_version_rel; everything past
    it MAX / NEG_INF.  The segment starts at digest(b"") = all zeros, or
    at `first` (a row int32[8]): a key-range shard's lower split, as the
    reference's sharded state starts (sharded_resolver.py:89-99).  device
    None means `cuda` (resolve_device)."""
    assert cap & (cap - 1) == 0, "capacity must be a power of two"
    device = resolve_device(device)
    bk = max_rows(cap, device)
    bk[0] = 0 if first is None else first
    bv = torch.full((cap,), NEG_INF, dtype=torch.int32, device=device)
    bv[0] = init_version_rel
    return WindowState(bk, bv, torch.ones((1,), dtype=torch.int32,
                                          device=device))


def window_state_to_numpy(state: WindowState):
    """(bk planar uint32[8, CAP], bv int32[CAP], size np.int32): the JAX
    package's layout of a WindowState."""
    return (rows_to_planar(state.bk), state.bv.cpu().numpy(),
            np.int32(int(state.size.cpu()[0])))


def window_state_from_numpy(bk, bv, size, device=None) -> WindowState:
    """A WindowState from the JAX package's layout (bk planar uint32[8,
    CAP], bv int32[CAP], size an int32 scalar), on `device` (None means
    `cuda`, as make_window_state)."""
    device = resolve_device(device)
    return WindowState(
        torch.from_numpy(planar_to_rows(np.asarray(bk))).to(device),
        torch.from_numpy(np.array(bv, dtype=np.int32)).to(device),
        torch.tensor([int(size)], dtype=torch.int32, device=device))


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _device_int(x: Union[int, torch.Tensor], device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(x)], dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------

def window_query(bk: torch.Tensor, bv: torch.Tensor, r_begin: torch.Tensor,
                 r_end: torch.Tensor, r_snap: torch.Tensor,
                 r_valid: torch.Tensor, impl=None) -> torch.Tensor:
    """conflict[i] = valid[i] and max{V(k): k in [begin_i, end_i)} > snap_i
    (int32 0/1 [Q]).  The segment containing begin_i is included (its
    boundary key is <= begin), matching the skip list's start-side check.
    Kernel: build_sparse_table's st_tile / st_high, then wq_query (both
    searches and the range max fused, the searches' first levels in
    shared memory: csrc/common.cuh probe_max; invalid queries search
    nothing)."""
    table = build_sparse_table(bv, impl=impl)
    if _k.use_kernel(bk, impl):
        out = torch.empty((r_begin.shape[0],), dtype=torch.int32,
                          device=bk.device)
        _k.launch("window_query", "wq_query", bk, bk.shape[0], table,
                  r_begin, r_end, r_snap, r_valid, r_begin.shape[0], out)
        return out
    lo = searchsorted(bk, r_begin, False, "plain") - 1
    hi = searchsorted(bk, r_end, True, "plain")
    maxv = range_max(table, lo, hi)
    return ((r_valid != 0) & (maxv > r_snap)).to(torch.int32)


# ---------------------------------------------------------------------------
# Insert (union of write ranges + parallel sorted merge)
# ---------------------------------------------------------------------------

# Endpoints a tile of _union_ranges' sweep takes (csrc/window.cu SW_TILE).
UNION_TILE = 1024


def _union_ranges(w_begin: torch.Tensor, w_end: torch.Tensor,
                  w_valid: torch.Tensor, impl=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge overlapping or touching [begin, end) ranges (reference
    combineWriteConflictRanges, SkipList.cpp:996).

    w_begin / w_end: rows int32[W, 8]; w_valid: int32 0/1 [W].  Returns
    (mb, me, m_incl): sorted disjoint merged ranges as rows [W, 8], MAX
    padded, and the inclusive count of merged ranges over the 2W sorted
    endpoints (m_incl[-1] is the number of merged ranges; m_valid =
    iota(W) < m_incl[-1]).  Endpoint sweep: +1 at begins, -1 at ends,
    begins first on ties; a merged range starts where coverage reaches 1
    and ends where it returns to 0.  Kernels: wu_endpoints (the endpoints,
    mb and me as MAX rows, the sweep's descriptors zeroed), sort_rows, then
    wu_sweep (the coverage, the marks, m_incl and both compactions in one
    single-pass launch of two look-back chains, csrc/window.cu)."""
    w = w_begin.shape[0]
    dev = w_begin.device
    e = dict(dtype=torch.int32, device=dev)
    if _k.use_kernel(w_begin, impl):
        n2 = 2 * w
        scratch = torch.empty((1 + 2 * max(1, -(-n2 // UNION_TILE)),),
                              dtype=torch.int64, device=dev)
        digests = torch.empty((n2, ROW_PAD), **e)
        tie = torch.empty((n2,), **e)
        delta = torch.empty((n2,), **e)
        mb = torch.empty((w, ROW_PAD), **e)
        me = torch.empty((w, ROW_PAD), **e)
        _k.launch("union_ranges", "wu_endpoints", w, w_begin, w_end, w_valid,
                  digests, tie, delta, mb, me, scratch, scratch.numel())
        s_rows, s_delta = sort_rows(digests, tie=tie, payload=delta)
        m_incl = torch.empty((n2,), **e)
        _k.launch("union_ranges", "wu_sweep", n2, s_rows, s_delta, scratch,
                  scratch.numel(), mb, me, w, m_incl)
        return mb, me, m_incl
    valid = w_valid != 0
    digests = torch.cat([torch.where(valid[:, None], w_begin, -1),
                         torch.where(valid[:, None], w_end, -1)])
    tie = torch.cat([torch.zeros((w,), **e), torch.ones((w,), **e)])
    delta = torch.cat([valid.to(torch.int32), -valid.to(torch.int32)])
    s_rows, s_delta = sort_rows(digests, tie=tie, payload=delta, impl="plain")
    cov = inclusive_scan(s_delta, "plain")
    is_start = ((s_delta > 0) & (cov == 1)).to(torch.int32)
    is_end = ((s_delta < 0) & (cov == 0)).to(torch.int32)
    m_incl = inclusive_scan(is_start, "plain")
    mb, me = max_rows(w, dev), max_rows(w, dev)
    compact_rows(is_start, m_incl, s_rows, None, mb, None, impl="plain")
    compact_rows(is_end, inclusive_scan(is_end, "plain"), s_rows, None, me,
                 None, impl="plain")
    return mb, me, m_incl


# Ranges a probe block of csrc/insert.cu owns (RI_TILE).
RANGE_TILE = 256


def range_insert(counter: str, k, v, size, mb, me, m_valid, m_count,
                 wrap: bool, now_rel, flag, flag_or: bool, bsize,
                 tail) -> None:
    """The insert core of window_insert and the point insert on the card,
    IN PLACE on k/v/size: ri_insert's probe, move and commit, three
    launches counted under `counter` (csrc/insert.cu).

    mb / me: rows int32[W, 8], sorted and disjoint where valid; a range is
    valid where m_valid (int32 0/1 [W]) is set and its index is below
    m_count (int32[1]), each when given.  wrap: the slot rule of the
    continuing version (True: slot -1 wraps to row cap - 1, as
    window_insert's reference gathers; False: clamped to row 0, as the
    point insert's).  now_rel: an int or an int32[1] tensor on the card.
    flag (int32[1]) gets the overflow, OR'd into it when flag_or; tail
    (int32[3]), when given, flag / new size / bsize.  On overflow the tier
    keeps its old contents.  The tier's rows past size must be MAX rows at
    NEG_INF and its live rows unique (the window's invariant)."""
    cap, w = k.shape[0], mb.shape[0]
    e = dict(dtype=torch.int32, device=k.device)
    nt = max(1, -(-w // RANGE_TILE))
    now_t, now_val = None, 0
    if isinstance(now_rel, torch.Tensor):
        now_t = now_rel.reshape(1).to(**e)
    else:
        now_val = int(now_rel)
    n = 5 * w + nt + 2
    _k.launch(counter, "ri_insert", k, v, cap, size, mb, me, w, m_valid,
              m_count, int(wrap), now_t, now_val, flag, int(flag_or), bsize,
              tail, torch.empty((n,), **e), n,
              torch.empty((cap * 9,), **e), count=3)


def window_insert(state: WindowState, w_begin: torch.Tensor,
                  w_end: torch.Tensor, w_valid: torch.Tensor,
                  now_rel: Union[int, torch.Tensor],
                  flag: Optional[torch.Tensor] = None,
                  bsize: Optional[torch.Tensor] = None,
                  tail: Optional[torch.Tensor] = None, impl=None
                  ) -> Tuple[WindowState, torch.Tensor]:
    """Set V(k) := now for k in each valid write range, IN PLACE on the
    state's tensors (reference window.py:127; SkipList.cpp:430-441): drop
    old boundaries inside [b, e), add boundary b at `now` and boundary e
    continuing the prior version.  Returns (state, overflow int32[1]); on
    overflow the state keeps its old contents.

    w_begin / w_end: rows int32[W, 8]; w_valid: int32 0/1 [W]; now_rel an
    int or an int32[1] tensor.  With `flag` (int32[1]) the overflow is
    OR'd into it (the sticky flag of the general step); with `tail`
    (int32[3]) flag / new size / bsize are written there (the verdict
    tail).  Kernel: _union_ranges' own, then range_insert's three
    launches (csrc/insert.cu), which need no sort of the new rows: the
    merged ranges are sorted and disjoint, touching ones merged, so each
    range's begin and end follow it in order (an empty merged range gives
    its begin first, as the plain version's stable sort does)."""
    bk, bv, size = state
    cap, w = bk.shape[0], w_begin.shape[0]
    dev = bk.device
    e = dict(dtype=torch.int32, device=dev)
    use = _k.use_kernel(bk, impl)
    p_ = None if use else "plain"

    mb, me, m_incl = _union_ranges(w_begin, w_end, w_valid, impl=p_)
    if use:
        ovf_out = torch.empty((1,), **e) if flag is None else flag
        range_insert("window_insert", bk, bv, size, mb, me, None,
                     m_incl[-1:], True, now_rel, ovf_out, flag is not None,
                     size if bsize is None else bsize, tail)
        return state, ovf_out
    now = _device_int(now_rel, dev)
    ovf_out = torch.zeros((1,), **e) if flag is None else flag
    n2 = 2 * w
    m_valid = _iota(w, dev) < m_incl[-1]
    idx_cap = _iota(cap, dev)
    live = idx_cap < size

    # Version continuing after each merged end (on the old state), and
    # whether a boundary sits exactly at the end already.
    slot = searchsorted(bk, me, False, p_) - 1
    cont_v = bv[torch.where(slot < 0, slot + cap, slot).clamp(0, cap - 1)
                .long()]
    p = searchsorted(bk, me, True, p_)
    present_end = lex_eq(bk[torch.clamp(p, max=cap - 1).long()], me) & (
        p < size)
    # Old boundaries strictly inside a merged range, or equal to a merged
    # begin, are dropped (counts from the dual direction: few searches
    # into the big array + histogram cumsum).
    cnt_b = rank_count(searchsorted(bk, mb, True, p_), cap, p_)
    cnt_e = rank_count(p, cap, p_)
    keep = (live & ~(cnt_b > cnt_e)).to(torch.int32)
    kincl = inclusive_scan(keep, p_)
    kept_count = kincl[-1]
    old_rows = max_rows(cap, dev)
    old_v = torch.full((cap,), NEG_INF, **e)
    compact_rows(keep, kincl, bk, bv, old_rows, old_v, impl=p_)

    # New entries: begins at now, ends at cont_v (suppressed if present).
    end_valid = m_valid & ~present_end
    new_rows = torch.cat([torch.where(m_valid[:, None], mb, -1),
                          torch.where(end_valid[:, None], me, -1)])
    new_v = torch.cat([torch.where(m_valid, now, NEG_INF),
                       torch.where(end_valid, cont_v, NEG_INF)]).to(
                           torch.int32)
    s_rows, s_v = sort_rows(new_rows, payload=new_v, impl=p_)
    new_valid = ~lex_eq(s_rows, torch.full_like(s_rows, -1))
    new_count = new_valid.sum(dtype=torch.int32)

    # Interleave positions: no duplicates exist between kept-old and new.
    pos_new = searchsorted(old_rows, s_rows, True, p_) + _iota(n2, dev)
    pos_old = idx_cap + rank_count(searchsorted(old_rows, s_rows, False, p_),
                                   cap, p_)
    new_size = kept_count + new_count
    overflow = new_size > cap
    old_dst = torch.where((idx_cap < kept_count) & ~overflow, pos_old, cap)
    new_dst = torch.where(new_valid & ~overflow, pos_new, cap)
    out_rows = scatter_set(max_rows(cap, dev), old_dst, old_rows)
    out_rows = scatter_set(out_rows, new_dst, s_rows)
    out_v = torch.full((cap,), NEG_INF, **e)
    out_v = scatter_set(out_v, old_dst, old_v)
    out_v = scatter_set(out_v, new_dst, s_v)
    bk.copy_(torch.where(overflow, bk, out_rows))
    bv.copy_(torch.where(overflow, bv, out_v))
    size.copy_(torch.where(overflow, size, new_size))
    ovf_out.copy_(ovf_out | overflow.to(torch.int32))
    if tail is not None:
        tail.copy_(torch.cat([ovf_out, size,
                              size if bsize is None else bsize]))
    return state, ovf_out


# ---------------------------------------------------------------------------
# GC / rebase
# ---------------------------------------------------------------------------

# Elements a tile of wg_gc owns (csrc/window.cu GC_TILE) and the int32
# slots of its scratch a tile: its kept count and its 64 mask words.
GC_TILE = 2048
_GC_SLOTS = 1 + GC_TILE // 32


def window_gc(state: WindowState, oldest_rel: int, rebase_delta: int,
              impl=None) -> WindowState:
    """removeBefore(oldest), IN PLACE: drop boundary i when both it and its
    original predecessor are below the floor (SkipList.cpp:576-607
    wasAbove logic); then shift every version down by rebase_delta, the
    subtraction wrapping in int32 before the clamp at NEG_INF + 1, bit for
    bit as the reference (window.py:239).  Rows past the new size become
    MAX rows at NEG_INF.
    Kernel: wg_gc, one cooperative launch a call and no other device
    operation (csrc/window.cu k_gc): the keep bits, the kept rows moved
    down in place chunk by chunk, the freed rows refilled and the size,
    all sized by size[0] on the device.  It rewrites only rows below the
    old size, so it relies on the window's invariant that rows past size
    are MAX rows at NEG_INF (every state is built from a MAX fill and
    every program keeps it); the plain version rewrites all of them."""
    bk, bv, size = state
    cap = bk.shape[0]
    dev = bk.device
    if _k.use_kernel(bk, impl):
        n = -(-cap // GC_TILE) * _GC_SLOTS
        _k.launch("window_gc", "wg_gc", bk, bv, size, cap, int(oldest_rel),
                  int(rebase_delta),
                  torch.empty((n,), dtype=torch.int32, device=dev), n)
        return state
    idx = _iota(cap, dev)
    above = bv >= int(oldest_rel)
    prev_above = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                            above[:-1]])
    keep = ((idx < size) & ((idx == 0) | above | prev_above)).to(torch.int32)
    incl = inclusive_scan(keep, "plain")
    out_rows = max_rows(cap, dev)
    out_v = torch.full((cap,), NEG_INF, dtype=torch.int32, device=dev)
    compact_rows(keep, incl, bk, bv, out_rows, out_v,
                 rebase=int(rebase_delta), impl="plain")
    bk.copy_(out_rows)
    bv.copy_(out_v)
    size.copy_(incl[-1:])
    return state
