"""Fused two-tier conflict resolution: the per-batch steps and the merge.

The port of foundationdb_tpu/conflict/fused.py.  The window is tiered as
there:

  BASE   bk/bv[CAP]   merged history, read-only between merges, with its
                      doubling range-max table (built at merge time)
  DELTA  dk/dv[DCAP]  small sorted segment array absorbing the last few
                      batches' writes, with its table refreshed by
                      delta_table_step after every insert and merge

and four device programs drive it (each per-batch step splits where the
key-range-sharded reference runs its collective, into the history,
resolve and insert halves that parallel/sharded_resolver.py drives per
shard):

  make_resolve_step_compact  per point batch: unpack the single uint8
                             buffer, too-old, history probe over both
                             tiers, the Jacobi intra-batch fixpoint, the
                             sort-free delta insert, int8 verdicts + a
                             12-byte tail
  make_resolve_step          per general batch (range reads and writes,
                             long keys): too-old, the two-tier history
                             probe, the sorted endpoint universe, the
                             Jacobi fixpoint over interval structures
                             (ops/segtree.py), window_insert into the
                             delta, the same verdicts and tail
  delta_table_step           the delta's range-max table
  make_merge_step            overlay delta onto base, removeBefore GC,
                             version rebase, rebuild the base table

Idiomatic PyTorch: plain functions on tensors with an explicit device, and
IN-PLACE state updates where the reference donated its buffers
(fused.py:423 and :690 there): the step writes dk/dv/dsize/flag in place,
the merge bk/bv/table/size and the reset delta.  Each block below is a
wrapper with a plain-torch version, taken for CPU tensors and with
impl="plain", and a hand-written CUDA kernel for CUDA tensors; on the CUDA
path all array work runs in kernels (torch only allocates, views and
copies between host and device).

State layout on the device: digests as rows int32[N, 8] (ops/digest.py),
scalars (size, dsize, flag) as int32[1] tensors, booleans as int32 0/1.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import kernels as _k
from ..ops.digest import (ROW_PAD, history_probe, lex_eq, max_rows,
                          rank_count, searchsorted, widen_unique)
from ..ops.rangemax import NEG_INF, build_sparse_table
from ..ops.scan import compact_rows, inclusive_scan, scatter_max, scatter_set
from ..ops.segtree import build_min_table, interval_min_cover, range_min
from ..ops.shard import clip_rows
from ..ops.sort import sort_rows
from ..txn.types import CommitResult
from .window import (WindowState, make_window_state, range_insert,
                     window_insert)

RES_CONFLICT = int(CommitResult.CONFLICT)
RES_TOO_OLD = int(CommitResult.TOO_OLD)
RES_COMMITTED = int(CommitResult.COMMITTED)
RES_INVALID = -1

INF_I32 = (1 << 31) - 1

N_SCALARS = 2  # now_rel, oldest_rel

# Per-batch output layout: int8[t_cap + 12] = [codes[t_cap] as int8,
# then flag, delta_size, base_size as 4 little-endian bytes each].
OUT_FLAG = 0
OUT_DSIZE = 1
OUT_BSIZE = 2
OUT_EXTRA = 12  # tail bytes


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 1)


def meta_size(t_cap: int, r_cap: int, w_cap: int) -> int:
    """int32 slots of the general step's metadata block:
    r_txn[R], r_valid[R], w_txn[W], w_valid[W], t_snap[T], t_has_reads[T],
    t_valid[T], now_rel, oldest_rel."""
    return 2 * r_cap + 2 * w_cap + 3 * t_cap + N_SCALARS


# Compact point-batch wire format (make_resolve_step_compact): one uint8
# buffer per batch.
#
#   ubytes  uint8[u_pad, L+1]   unique sorted begin-key digests, compacted
#                               to L prefix bytes + the length-marker byte
#   r_uid   int32[r_pad]        each read's slot in the unique table
#   w_uid   int32[w_pad]        each write's slot
#   r_start int32[t_cap]        first read index per txn
#   w_start int32[t_cap]
#   t_snap  int32[t_cap]        rebased snapshot versions
#   t_flags uint8[t_cap]        bit0 = has_reads
#   scalars int32[6]            u_n, n_r, n_w, n_t, now_rel, oldest_rel
COMPACT_SCALARS = 6


def compact_layout(t_cap: int, r_pad: int, w_pad: int, u_pad: int,
                   lw: int) -> dict:
    """Byte offsets of each section of the compact buffer.  Every section
    starts 4-byte aligned so the int32 sections read through one int32
    view of the buffer."""
    o = 0
    lay = {}
    for name, nbytes in (
            ("ubytes", u_pad * lw), ("r_uid", 4 * r_pad),
            ("w_uid", 4 * w_pad), ("r_start", 4 * t_cap),
            ("w_start", 4 * t_cap), ("t_snap", 4 * t_cap),
            ("t_flags", t_cap), ("scalars", 4 * COMPACT_SCALARS)):
        lay[name] = o
        o += (nbytes + 3) & ~3
    lay["total"] = o
    return lay


def make_delta_state(d_cap: int, device=None,
                     first: Optional[torch.Tensor] = None) -> WindowState:
    """Fresh transparent delta: one segment covering all keys (from
    `first`, a shard's lower split, when given) at NEG_INF.  device None
    means `cuda` (window.resolve_device)."""
    return make_window_state(d_cap, NEG_INF, device, first)


def delta_table_step(dv: torch.Tensor, out=None, impl=None) -> torch.Tensor:
    """The delta's range-max table (build_sparse_table), refreshed after
    every insert and merge; written into `out` in place when given."""
    return build_sparse_table(dv, out=out, impl=impl)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Blocks of the per-batch step
# ---------------------------------------------------------------------------

def txn_prep(r_start, w_start, t_snap, t_flags, scal, r_pad: int,
             w_pad: int, impl=None):
    """Too-old per txn and the rank counts that rebuild each read's and
    write's txn from the per-txn start offsets (reference fused.py:324-330):
    (too_old int32[t_cap], r_cnt int32[r_pad], w_cnt int32[w_pad]), where
    r_txn = r_cnt - 1.  Plain torch only: on the card the compact step
    computes them in compact_prep's kernels, so a call that would take the
    kernel route raises."""
    t_cap = t_snap.shape[0]
    dev = t_snap.device
    if _k.use_kernel(t_snap, impl):
        raise RuntimeError("txn_prep has no kernel of its own (the card runs "
                           "it in compact_prep); call it with impl='plain'")
    t_valid = _iota(t_cap, dev) < scal[3]
    t_has_reads = (t_flags & 1) != 0
    too_old = (t_valid & t_has_reads & (t_snap < scal[5])).to(torch.int32)
    r_cnt = rank_count(torch.where(t_valid, r_start, r_pad), r_pad, "plain")
    w_cnt = rank_count(torch.where(t_valid, w_start, w_pad), w_pad, "plain")
    return too_old, r_cnt, w_cnt


@functools.lru_cache(maxsize=64)
def unpack_layout(t_cap: int, r_pad: int, w_pad: int,
                  n_hist: int) -> tuple:
    """ib_unpack's scratch as its source lays it out: (int32 length,
    offset of the first hist, the hists' stride, the scan's tile)."""
    out = torch.empty((4,), dtype=torch.int64)
    _k.query("ib_unpack_layout", t_cap, r_pad, w_pad, n_hist, out)
    return tuple(int(v) for v in out)


def compact_prep(ub, r_start, w_start, t_snap, t_flags, scal, lw: int,
                 u_pad: int, r_pad: int, w_pad: int, n_hist: int = 1,
                 impl=None) -> dict:
    """The compact step's unpacking of one packed batch (reference
    fused.py:300-330): the unique keys widened to rows (widen_unique),
    too-old and the two rank counts (txn_prep), and `n_hist` zeroed
    int32[t_cap] buffers for the read_write_prep calls that follow (one a
    key-range shard on the device).  Returns {"u_b", "u_e" (int32[u_pad,
    8]), "too_old" (int32[t_cap]), "r_cnt" (int32[r_pad]), "w_cnt"
    (int32[w_pad]), "hists" (a list of n_hist)}.  No order of the starts
    is assumed: the counts are a histogram and its scan.  Kernel:
    ib_unpack, one cooperative launch a call and no fill: it zeroes its
    scratch (the histograms of the starts, their per-tile totals and the
    hists), widens and counts, then scans each tile from the totals of the
    tiles before it."""
    t_cap = t_snap.shape[0]
    dev = t_snap.device
    e = dict(dtype=torch.int32, device=dev)
    if not _k.use_kernel(t_snap, impl):
        u_b, u_e = widen_unique(ub, scal, lw, u_pad, "plain")
        too_old, r_cnt, w_cnt = txn_prep(r_start, w_start, t_snap, t_flags,
                                         scal, r_pad, w_pad, "plain")
        return {"u_b": u_b, "u_e": u_e, "too_old": too_old, "r_cnt": r_cnt,
                "w_cnt": w_cnt,
                "hists": [torch.zeros((t_cap,), **e) for _ in range(n_hist)]}
    if ub.numel() < u_pad * lw or ub.dtype != torch.uint8:
        raise ValueError(f"compact_prep: ub must hold u_pad * lw = "
                         f"{u_pad * lw} uint8, got {ub.numel()} {ub.dtype}")
    if t_flags.dtype != torch.uint8 or scal.numel() < COMPACT_SCALARS:
        raise ValueError("compact_prep: t_flags must be uint8 and scal hold "
                         f"{COMPACT_SCALARS} int32")
    for name, x in (("r_start", r_start), ("w_start", w_start),
                    ("t_snap", t_snap), ("t_flags", t_flags)):
        if x.shape != (t_cap,):
            raise ValueError(f"compact_prep: {name} has shape "
                             f"{tuple(x.shape)}, want ({t_cap},)")
    total, at, stride, _ = unpack_layout(t_cap, r_pad, w_pad, n_hist)
    scratch = torch.empty((total,), **e)
    hists = [scratch[at + i * stride:at + i * stride + t_cap]
             for i in range(n_hist)]
    u_b = torch.empty((u_pad, ROW_PAD), **e)
    u_e = torch.empty((u_pad, ROW_PAD), **e)
    too_old = torch.empty((t_cap,), **e)
    r_cnt = torch.empty((r_pad,), **e)
    w_cnt = torch.empty((w_pad,), **e)
    _k.launch("compact_prep", "ib_unpack", u_pad, lw, t_cap, r_pad, w_pad,
              n_hist, ub, r_start, w_start, t_snap, t_flags, scal, u_b, u_e,
              too_old, r_cnt, w_cnt, scratch, total)
    return {"u_b": u_b, "u_e": u_e, "too_old": too_old, "r_cnt": r_cnt,
            "w_cnt": w_cnt, "hists": hists}


def read_write_prep(r_uid, w_uid, r_cnt, w_cnt, too_old, t_snap, scal,
                    vmax_u, u_pad: int, impl=None, hist=None) -> dict:
    """Per read: its txn, liveness (valid and not too-old) and unique-key
    slot, and the history verdict scatter-maxed per txn; per write: its
    txn, base eligibility and slot (reference fused.py:332-371).  Returns
    int32 arrays r_txn, r_live, r_slot, hist, w_txn, w_ok, w_slot.
    hist, when given, is a zeroed int32[t_cap] buffer the verdicts are
    written into (one of compact_prep's, zeroed in its launch); else a
    zero fill makes it.  Kernel: ib_rw_prep, one launch for the reads and
    the writes (it sets only the hits, from any block, so it cannot also
    clear hist in the same launch)."""
    r_pad, w_pad, t_cap = r_uid.shape[0], w_uid.shape[0], t_snap.shape[0]
    dev = r_uid.device
    e = dict(dtype=torch.int32, device=dev)
    if hist is None:
        hist = torch.zeros((t_cap,), **e)
    elif hist.shape != (t_cap,) or hist.dtype != torch.int32:
        raise ValueError(f"read_write_prep: hist must be int32[{t_cap}], got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    if _k.use_kernel(r_uid, impl):
        o = {name: torch.empty((r_pad,), **e)
             for name in ("r_txn", "r_live", "r_slot")}
        o.update({name: torch.empty((w_pad,), **e)
                  for name in ("w_txn", "w_ok", "w_slot")})
        o["hist"] = hist
        _k.launch("read_write_prep", "ib_rw_prep", r_pad, w_pad, t_cap,
                  u_pad, r_uid, r_cnt, w_uid, w_cnt, too_old, t_snap, scal,
                  vmax_u, o["r_txn"], o["r_live"], o["r_slot"], o["hist"],
                  o["w_txn"], o["w_ok"], o["w_slot"])
        return o
    r_txn = r_cnt - 1
    r_valid = _iota(r_pad, dev) < scal[1]
    r_txn_c = torch.clamp(r_txn, 0, t_cap - 1).long()
    r_live = r_valid & (too_old[r_txn_c] == 0)
    snap_r = t_snap[r_txn_c]
    r_slot = torch.clamp(r_uid, 0, u_pad - 1)
    hist_bits = r_live & (vmax_u[r_slot.long()] > snap_r)
    hist = scatter_max(hist, torch.where(r_live, r_txn, t_cap), hist_bits)
    w_txn = w_cnt - 1
    w_valid = _iota(w_pad, dev) < scal[2]
    w_txn_c = torch.clamp(w_txn, 0, t_cap - 1).long()
    w_ok = w_valid & (too_old[w_txn_c] == 0)
    return {"r_txn": r_txn, "r_live": r_live.to(torch.int32),
            "r_slot": r_slot, "hist": hist, "w_txn": w_txn,
            "w_ok": w_ok.to(torch.int32),
            "w_slot": torch.clamp(w_uid, 0, u_pad - 1)}


def intra_batch_fixpoint(hist, r_txn, r_live, r_slot, w_txn, w_ok, w_slot,
                         u_pad: int, impl=None, codes_out=None, scal=None,
                         too_old=None):
    """The intra-batch fixpoint (checkIntraBatchConflicts,
    SkipList.cpp:874-906; reference fused.py:373-385): a reader conflicts
    iff an EARLIER SURVIVING txn of the batch wrote its key.  Jacobi
    rounds recompute from the history-only baseline until nothing
    changes.  Returns (conflicted int32[t_cap], rounds int32[1]).
    With codes_out (int8[t_cap]), scal (the compact scalars, on the
    device) and too_old (int32[t_cap]) it also writes the verdict codes
    into codes_out and returns the insert mask as a third element:
    exactly batch_codes after the fixpoint (reference fused.py:388-405).
    Kernel: ib_fixpoint, one cooperative persistent launch over every SM
    whose rounds loop on the device; its cover, next-conflict and changed
    scratch is double-buffered by round parity, and the codes are its last
    phase, after the barrier the rounds leave on (csrc/intra_batch.cu)."""
    t_cap, w_pad = hist.shape[0], w_txn.shape[0]
    dev = hist.device
    codes = codes_out is not None
    if codes and (scal is None or too_old is None):
        raise ValueError("intra_batch_fixpoint: codes_out needs scal and "
                         "too_old")
    if _k.use_kernel(hist, impl):
        e = dict(dtype=torch.int32, device=dev)
        if codes and (codes_out.shape != (t_cap,)
                      or codes_out.dtype != torch.int8
                      or too_old.shape != (t_cap,)
                      or scal.numel() < COMPACT_SCALARS):
            raise ValueError(
                f"intra_batch_fixpoint: codes_out must be int8[{t_cap}], "
                f"too_old int32[{t_cap}] and scal hold {COMPACT_SCALARS} "
                f"int32, got {codes_out.dtype} {tuple(codes_out.shape)}, "
                f"{tuple(too_old.shape)}, {scal.numel()}")
        conf = torch.empty((t_cap,), **e)
        rounds = torch.empty((1,), **e)
        w_ins = torch.empty((w_pad,), **e) if codes else None
        _k.launch("intra_batch_fixpoint", "ib_fixpoint", t_cap,
                  r_txn.shape[0], w_pad, u_pad, hist, r_txn, r_live,
                  r_slot, w_txn, w_ok, w_slot,
                  torch.empty((2 * (u_pad + 1),), **e),
                  torch.empty((2 * t_cap,), **e), torch.empty((2,), **e),
                  conf, rounds, scal if codes else None,
                  too_old if codes else None, codes_out, w_ins)
        return (conf, rounds, w_ins) if codes else (conf, rounds)
    w_txn_c = torch.clamp(w_txn, 0, t_cap - 1).long()
    live = r_live != 0
    r_scatter = torch.where(live, r_txn, t_cap)
    conf = hist.clone()
    rounds = 0
    while True:
        rounds += 1
        w_active = (w_ok != 0) & (conf[w_txn_c] == 0)
        cover = torch.full((u_pad + 1,), INF_I32, dtype=torch.int32,
                           device=dev)
        cover.scatter_reduce_(
            0, torch.where(w_active, w_slot, u_pad).long(),
            torch.where(w_active, w_txn, INF_I32), "amin")
        intra_hit = live & (cover[r_slot.long()] < r_txn)
        new_conf = scatter_max(hist.clone(), r_scatter, intra_hit)
        changed = bool((new_conf != conf).any())
        conf = new_conf
        if not changed:
            break
    rounds_t = torch.tensor([rounds], dtype=torch.int32, device=dev)
    if not codes:
        return conf, rounds_t
    return conf, rounds_t, batch_codes(scal, too_old, conf, w_txn,
                                       codes_out, "plain")


def batch_codes(scal, too_old, conf, w_txn, codes_out, impl=None):
    """Verdict codes into codes_out (int8[t_cap]: INVALID / TOO_OLD /
    CONFLICT / COMMITTED) and the insert mask of surviving txns' writes
    (int32[w_pad]) (reference fused.py:388-405).  Plain torch only: on
    the card intra_batch_fixpoint writes them in the fixpoint's own
    launch, so a call that would take the kernel route raises."""
    t_cap, w_pad = too_old.shape[0], w_txn.shape[0]
    dev = too_old.device
    if _k.use_kernel(too_old, impl):
        raise RuntimeError("batch_codes has no kernel of its own (the card "
                           "runs it in intra_batch_fixpoint's launch); "
                           "call it with impl='plain'")
    t_valid = _iota(t_cap, dev) < scal[3]
    old = too_old != 0
    cf = conf != 0
    codes = torch.where(
        ~t_valid, RES_INVALID,
        torch.where(old, RES_TOO_OLD,
                    torch.where(cf, RES_CONFLICT, RES_COMMITTED)))
    codes_out.copy_(codes.to(torch.int8))
    survivor = t_valid & ~old & ~cf
    w_txn_c = torch.clamp(w_txn, 0, t_cap - 1).long()
    w_ins = (_iota(w_pad, dev) < scal[2]) & survivor[w_txn_c]
    return w_ins.to(torch.int32)


def _point_insert(dk, dv, dsize, u_k, u_e, w_uidx, w_ins, now_rel, flag,
                  bsize=None, tail=None, impl=None, u_own=None) -> None:
    """Sort-free delta insert for point batches, IN PLACE on dk/dv/dsize;
    flag |= overflow, and on overflow the delta keeps its old state
    (reference fused.py:157-247, where the overflow bit is returned).

    u_k/u_e are the batch's unique begin/end keys, sorted with MAX padding
    and disjoint as ranges (tpu_backend._pack_compact's guarantees), so the
    union sweep reduces to a scatter-max of the survivor mask over
    unique-key slots and the new-boundary sequence is the interleave
    [b0, e0, b1, e1, ...] compacted by rank.  now_rel is int32[1] on the
    device.  With `tail` (int32[3]), flag / new delta size / bsize are
    written there (the verdict tail).  With `u_own` (int32 0/1 [U], a
    key-range shard's begin-in-bounds mask) only the owned unique keys are
    inserted (reference fused.py:175-177).  Kernels: pi_mark and
    range_insert's probe, move and commit (csrc/insert.cu), four launches
    a call; the unique keys are the ranges, so no sort, scan or search of
    ops/ runs."""
    if _k.use_kernel(dk, impl):
        _point_insert_kernel(dk, dv, dsize, u_k, u_e, w_uidx, w_ins,
                             now_rel, flag, bsize, tail, u_own)
        return
    d_cap, w_cap = dk.shape[0], u_k.shape[0]
    dev = dk.device
    p_ = "plain"
    m_valid = torch.zeros((w_cap,), dtype=torch.int32, device=dev)
    m_valid.scatter_reduce_(0, torch.clamp(w_uidx, 0, w_cap - 1).long(),
                            w_ins.to(torch.int32), "amax")
    mv = m_valid != 0
    if u_own is not None:
        mv = mv & (u_own != 0)
    mb = torch.where(mv[:, None], u_k, -1)
    me = torch.where(mv[:, None], u_e, -1)

    idx_cap = _iota(d_cap, dev)
    live = idx_cap < dsize
    slot = searchsorted(dk, me, False, p_) - 1
    cont_v = dv[torch.clamp(slot, 0, d_cap - 1).long()]
    p = searchsorted(dk, me, True, p_)
    present_end = lex_eq(dk[torch.clamp(p, max=d_cap - 1).long()], me) & (
        p < dsize)
    cnt_b = rank_count(searchsorted(dk, mb, True, p_), d_cap, p_)
    cnt_e = rank_count(p, d_cap, p_)
    keep = (live & ~(cnt_b > cnt_e)).to(torch.int32)
    kincl = inclusive_scan(keep, p_)
    kept_count = kincl[-1]
    old_rows = max_rows(d_cap, dev)
    old_v = torch.full((d_cap,), NEG_INF, dtype=torch.int32, device=dev)
    compact_rows(keep, kincl, dk, dv, old_rows, old_v, impl=p_)

    end_valid = mv & ~present_end
    il_rows = torch.stack([u_k, u_e], dim=1).reshape(2 * w_cap, ROW_PAD)
    il_valid = torch.stack([mv, end_valid], dim=1).reshape(
        2 * w_cap).to(torch.int32)
    il_v = torch.stack(
        [torch.where(mv, now_rel, NEG_INF),
         torch.where(end_valid, cont_v, NEG_INF)], dim=1).reshape(2 * w_cap)
    nincl = inclusive_scan(il_valid, p_)
    new_count = nincl[-1]
    cnew_rows = max_rows(2 * w_cap, dev)
    cnew_v = torch.full((2 * w_cap,), NEG_INF, dtype=torch.int32,
                        device=dev)
    compact_rows(il_valid, nincl, il_rows, il_v.to(torch.int32), cnew_rows,
                 cnew_v, impl=p_)
    new_valid = _iota(2 * w_cap, dev) < new_count

    pos_new = searchsorted(old_rows, cnew_rows, True, p_) + _iota(
        2 * w_cap, dev)
    pos_old = idx_cap + rank_count(
        searchsorted(old_rows, cnew_rows, False, p_), d_cap, p_)
    new_size = kept_count + new_count
    overflow = new_size > d_cap
    old_dst = torch.where((idx_cap < kept_count) & ~overflow, pos_old, d_cap)
    new_dst = torch.where(new_valid & ~overflow, pos_new, d_cap)
    out_rows = scatter_set(max_rows(d_cap, dev), old_dst, old_rows)
    out_rows = scatter_set(out_rows, new_dst, cnew_rows)
    out_v = torch.full((d_cap,), NEG_INF, dtype=torch.int32, device=dev)
    out_v = scatter_set(out_v, old_dst, old_v)
    out_v = scatter_set(out_v, new_dst, cnew_v)
    dk.copy_(torch.where(overflow, dk, out_rows))
    dv.copy_(torch.where(overflow, dv, out_v))
    dsize.copy_(torch.where(overflow, dsize, new_size))
    flag.copy_(flag | overflow.to(torch.int32))
    if tail is not None:
        tail.copy_(torch.cat([flag, dsize, bsize]))


def _point_insert_kernel(dk, dv, dsize, u_k, u_e, w_uidx, w_ins, now_rel,
                         flag, bsize, tail, u_own) -> None:
    """pi_mark (one cooperative launch: zero the mask, scatter the
    survivors), then range_insert over the unique keys with the clamp
    slot rule: four launches a call."""
    u_pad = u_k.shape[0]
    m_valid = torch.empty((u_pad,), dtype=torch.int32, device=dk.device)
    _k.launch("point_insert", "pi_mark", w_uidx.shape[0], w_uidx, w_ins,
              u_pad, u_own, m_valid)
    range_insert("point_insert", dk, dv, dsize, u_k, u_e, m_valid, None,
                 False, now_rel, flag, True, bsize, tail)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

class CompactStep:
    """Per-batch step over the compact single-buffer point layout — the
    production path for all_point batches (reference fused.py:251).

    step(bk, bv, table, size, dk, dv, dtable, dsize, flag, buf)
      -> (dk, dv, dsize, flag, out)
    buf is the packed batch (uint8, on the state's device); dk/dv/dsize/
    flag are updated IN PLACE and returned; out = int8[t_cap + 12]
    (codes, then flag / delta size / base size as int32 bytes).  `dtable`
    is the delta table over the INPUT delta (delta_table_step).

    The call is the composition of three halves, split where the sharded
    reference (axis_name) runs its collective; a key-range-sharded caller
    (parallel/sharded_resolver.py) runs them itself:

      history(...)  unpack(...) once per device (the unique keys, too-old,
                    the rank counts: compact_prep), then per shard
                    probe(...): the history probe (over keys clipped to
                    the shard's bounds when given) and the per-txn
                    history bits (read_write_prep)
      resolve(...)  once, on the combined bits: the fixpoint and the codes
      insert(...)   per shard: the delta insert of the surviving writes
                    (of the keys the shard owns when bounds were given)"""

    def __init__(self, cap: int, d_cap: int, t_cap: int, r_pad: int,
                 w_pad: int, u_pad: int, lw: int, impl=None) -> None:
        self.t_cap, self.r_pad, self.w_pad = t_cap, r_pad, w_pad
        self.u_pad, self.lw, self.impl = u_pad, lw, impl
        self.lay = compact_layout(t_cap, r_pad, w_pad, u_pad, lw)

    def unpack(self, buf, n_hist: int = 1) -> dict:
        """The batch's part of the history, the same for every shard on
        the buffer's device: compact_prep's dict (n_hist zeroed hists, one
        a probe(...) that follows) and the buffer's views r_uid, w_uid,
        t_snap and scal."""
        lay = self.lay
        buf32 = buf.view(torch.int32)

        def i32(name, n):
            o = lay[name] // 4
            return buf32[o:o + n]

        t_cap = self.t_cap
        t_snap, scal = i32("t_snap", t_cap), i32("scalars", COMPACT_SCALARS)
        u = compact_prep(
            buf[lay["ubytes"]:lay["ubytes"] + self.u_pad * self.lw],
            i32("r_start", t_cap), i32("w_start", t_cap), t_snap,
            buf[lay["t_flags"]:lay["t_flags"] + t_cap], scal, self.lw,
            self.u_pad, self.r_pad, self.w_pad, n_hist, self.impl)
        u.update(r_uid=i32("r_uid", self.r_pad),
                 w_uid=i32("w_uid", self.w_pad), t_snap=t_snap, scal=scal)
        return u

    def probe(self, u: dict, bk, table, dk, dtable, bounds,
              hist) -> dict:
        """A shard's history bits `h["rw"]["hist"]` from unpack(...)'s `u`,
        written into `hist` (one of u["hists"], zeroed).  bounds, when
        given, is the shard's (lo, hi) rows: each unique key's range is
        clipped to it and its maximum is NEG_INF where nothing of it is
        owned (reference fused.py:340-357).  Nothing here writes into `u`,
        so shards may share it."""
        impl, u_b, u_e = self.impl, u["u_b"], u["u_e"]
        u_own = None
        if bounds is None:
            vmax_u = history_probe(bk, table, dk, dtable, u_b, u_e, impl)
        else:
            cu_b, cu_e, owned, u_own = clip_rows(u_b, u_e, *bounds,
                                                 impl=impl)
            vmax_u = history_probe(bk, table, dk, dtable, cu_b, cu_e, impl,
                                   own=owned)
        rw = read_write_prep(u["r_uid"], u["w_uid"], u["r_cnt"], u["w_cnt"],
                             u["too_old"], u["t_snap"], u["scal"], vmax_u,
                             self.u_pad, impl, hist=hist)
        return {"u_b": u_b, "u_e": u_e, "u_own": u_own, "w_uid": u["w_uid"],
                "scal": u["scal"], "too_old": u["too_old"], "rw": rw}

    def history(self, bk, table, dk, dtable, buf, bounds=None) -> dict:
        """unpack(buf) and probe(...) for one shard (or none): everything up
        to the history bits `h["rw"]["hist"]`."""
        u = self.unpack(buf)
        return self.probe(u, bk, table, dk, dtable, bounds, u["hists"][0])

    def resolve(self, h: dict, hist: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
        """The intra-batch fixpoint from the (combined) history bits and
        the codes into out[:t_cap], one call (one launch on the card);
        returns the insert mask w_ins."""
        rw = h["rw"]
        _, _, w_ins = intra_batch_fixpoint(
            hist, rw["r_txn"], rw["r_live"], rw["r_slot"], rw["w_txn"],
            rw["w_ok"], rw["w_slot"], self.u_pad, self.impl,
            codes_out=out[:self.t_cap], scal=h["scal"],
            too_old=h["too_old"])
        return w_ins

    def insert(self, h: dict, dk, dv, dsize, flag, size, w_ins,
               tail) -> None:
        """The surviving writes into the delta, IN PLACE; flag, delta size
        and `size` into tail (int32[3])."""
        _point_insert(dk, dv, dsize, h["u_b"], h["u_e"], h["w_uid"], w_ins,
                      h["scal"][4:5], flag, bsize=size, tail=tail,
                      impl=self.impl, u_own=h["u_own"])

    def __call__(self, bk, bv, table, size, dk, dv, dtable, dsize, flag,
                 buf):
        h = self.history(bk, table, dk, dtable, buf)
        out = torch.empty((self.t_cap + OUT_EXTRA,), dtype=torch.int8,
                          device=buf.device)
        w_ins = self.resolve(h, h["rw"]["hist"], out)
        self.insert(h, dk, dv, dsize, flag, size, w_ins,
                    out[self.t_cap:].view(torch.int32))
        return dk, dv, dsize, flag, out


def make_resolve_step_compact(cap: int, d_cap: int, t_cap: int, r_pad: int,
                              w_pad: int, u_pad: int, lw: int,
                              impl=None) -> CompactStep:
    """The compact point step for one bucket shape (CompactStep)."""
    return CompactStep(cap, d_cap, t_cap, r_pad, w_pad, u_pad, lw, impl)


# ---------------------------------------------------------------------------
# Blocks of the general interval step
# ---------------------------------------------------------------------------

def general_prep(meta: dict, vmax: torch.Tensor, impl=None) -> dict:
    """Too-old per txn (SkipList.cpp:819), live reads and their history
    verdicts scatter-maxed per txn, and the writers' base eligibility
    (reference fused.py:479-511).  meta holds the views of the metadata
    block (r_txn, r_valid, w_txn, w_valid, t_snap, t_has_reads, t_valid,
    oldest_rel as int32[1]); vmax is history_probe over each read.
    Returns int32 arrays too_old, r_live, hist, w_ok.
    Kernel: ig_prep, one cooperative launch a call and no fill: too-old
    per txn and hist zeroed, a grid barrier, then the reads and the
    writes."""
    t_cap = meta["t_snap"].shape[0]
    r_cap, w_cap = meta["r_txn"].shape[0], meta["w_txn"].shape[0]
    dev = vmax.device
    if _k.use_kernel(vmax, impl):
        e = dict(dtype=torch.int32, device=dev)
        o = {"too_old": torch.empty((t_cap,), **e),
             "r_live": torch.empty((r_cap,), **e),
             "hist": torch.empty((t_cap,), **e),
             "w_ok": torch.empty((w_cap,), **e)}
        _k.launch("general_prep", "ig_prep", t_cap, r_cap, w_cap,
                  meta["r_txn"], meta["r_valid"], meta["w_txn"],
                  meta["w_valid"], meta["t_snap"], meta["t_has_reads"],
                  meta["t_valid"], meta["oldest_rel"], vmax, o["too_old"],
                  o["r_live"], o["hist"], o["w_ok"])
        return o
    too_old = ((meta["t_valid"] != 0) & (meta["t_has_reads"] != 0)
               & (meta["t_snap"] < meta["oldest_rel"]))
    r_txn = meta["r_txn"]
    r_txn_c = torch.clamp(r_txn, 0, t_cap - 1).long()
    r_live = (meta["r_valid"] != 0) & ~too_old[r_txn_c]
    hist_bits = r_live & (vmax > meta["t_snap"][r_txn_c])
    hist = scatter_max(torch.zeros((t_cap,), dtype=torch.int32, device=dev),
                       torch.where(r_live, r_txn, t_cap), hist_bits)
    w_txn_c = torch.clamp(meta["w_txn"], 0, t_cap - 1).long()
    w_ok = (meta["w_valid"] != 0) & ~too_old[w_txn_c]
    return {"too_old": too_old.to(torch.int32),
            "r_live": r_live.to(torch.int32), "hist": hist,
            "w_ok": w_ok.to(torch.int32)}


# csrc/segtree.cu's tile and run sizes (FIX_TILE_LOG, FIX_BLOCK_LOG).
FIX_TILE_LOG = 12
FIX_BLOCK_LOG = 5


def fixpoint_scratch_len(t_cap: int, log_u: int) -> int:
    """int32 slots of sg_fixpoint's scratch (csrc/segtree.cu fix_layout):
    the tree (2U), the cover (U), the in-tile tables of the run minima,
    the tile minima, the two conflict buffers and four counts."""
    u = 1 << log_u
    tl = min(log_u, FIX_TILE_LOG)
    lb = min(tl, FIX_BLOCK_LOG)
    return 3 * u + (u >> lb) * (tl - lb + 1) + (u >> tl) + 2 * t_cap + 4


def interval_fixpoint(hist, r_txn, r_live, r_pb, r_pe, w_txn, w_ok, w_pb,
                      w_pe, log_u: int, rounds_acc=None, impl=None,
                      codes_out=None, t_valid=None, too_old=None,
                      w_valid=None):
    """The general intra-batch fixpoint (checkIntraBatchConflicts,
    SkipList.cpp:874-906; reference fused.py:531-547): a reader conflicts
    iff an EARLIER SURVIVING txn of the batch wrote a range overlapping
    its own.  Reads and writes arrive as spans [pb, pe) of gaps of the
    sorted endpoint universe (U = 1 << log_u gaps, 0 <= pb, pe <= U);
    each Jacobi round builds the min-writer cover (ops/segtree.py),
    answers every read's range min, and recomputes from the history-only
    baseline, until nothing changes.  Returns (conflicted int32[t_cap],
    rounds int32[1]); with rounds_acc (int32[1]) the round count is also
    added there.  With codes_out (int8[t_cap]), t_valid, too_old
    (int32[t_cap]) and w_valid (int32[w_cap]) it also writes the verdict
    codes into codes_out and returns the insert mask as a third element:
    exactly general_codes after the fixpoint (reference fused.py:550-566).
    Kernel: sg_fixpoint, one cooperative persistent launch whose rounds
    loop on the device, three grid barriers a round: the cover pushed
    down by tiles in shared memory, the reads answered from the cover,
    in-tile tables of run minima and a table of tile minima; the codes
    are its last phase, after the barrier the rounds leave on
    (csrc/segtree.cu)."""
    t_cap, w_cap = hist.shape[0], w_txn.shape[0]
    dev = hist.device
    e = dict(dtype=torch.int32, device=dev)
    codes = codes_out is not None
    if codes and (t_valid is None or too_old is None or w_valid is None):
        raise ValueError("interval_fixpoint: codes_out needs t_valid, "
                         "too_old and w_valid")
    if _k.use_kernel(hist, impl):
        if codes and (codes_out.shape != (t_cap,)
                      or codes_out.dtype != torch.int8
                      or t_valid.shape != (t_cap,)
                      or too_old.shape != (t_cap,)
                      or w_valid.shape != (w_cap,)):
            raise ValueError(
                f"interval_fixpoint: codes_out must be int8[{t_cap}], "
                f"t_valid and too_old int32[{t_cap}], w_valid "
                f"int32[{w_cap}], got {codes_out.dtype} "
                f"{tuple(codes_out.shape)}, {tuple(t_valid.shape)}, "
                f"{tuple(too_old.shape)}, {tuple(w_valid.shape)}")
        n = fixpoint_scratch_len(t_cap, log_u)
        conf = torch.empty((t_cap,), **e)
        rounds = torch.empty((1,), **e)
        w_ins = torch.empty((w_cap,), **e) if codes else None
        _k.launch("interval_fixpoint", "sg_fixpoint", t_cap, r_txn.shape[0],
                  w_cap, log_u, hist, r_txn, r_live, r_pb, r_pe,
                  w_txn, w_ok, w_pb, w_pe, torch.empty((n,), **e), n, conf,
                  rounds, rounds_acc, t_valid if codes else None,
                  too_old if codes else None, w_valid if codes else None,
                  codes_out, w_ins)
        return (conf, rounds, w_ins) if codes else (conf, rounds)
    p_ = "plain"
    w_txn_c = torch.clamp(w_txn, 0, t_cap - 1).long()
    live = r_live != 0
    r_scatter = torch.where(live, r_txn, t_cap)
    conf = hist.clone()
    rounds = 0
    while True:
        rounds += 1
        w_active = (w_ok != 0) & (conf[w_txn_c] == 0)
        cover = interval_min_cover(w_pb, w_pe, w_txn, w_active, log_u, p_)
        m = range_min(build_min_table(cover, p_), r_pb, r_pe, p_)
        intra_hit = live & (m < r_txn)
        new_conf = scatter_max(hist.clone(), r_scatter, intra_hit)
        changed = bool((new_conf != conf).any())
        conf = new_conf
        if not changed:
            break
    rounds_t = torch.tensor([rounds], **e)
    if rounds_acc is not None:
        rounds_acc.add_(rounds_t)
    if not codes:
        return conf, rounds_t
    return conf, rounds_t, general_codes(t_valid, too_old, conf, w_txn,
                                         w_valid, codes_out, p_)


def general_codes(t_valid, too_old, conf, w_txn, w_valid, codes_out,
                  impl=None):
    """Verdict codes into codes_out (int8[t_cap]) and the insert mask of
    surviving txns' writes (int32[w_cap]) (reference fused.py:550-566).
    Plain torch only: on the card interval_fixpoint writes them in the
    fixpoint's own launch, so a call that would take the kernel route
    raises."""
    t_cap = too_old.shape[0]
    if _k.use_kernel(too_old, impl):
        raise RuntimeError("general_codes has no kernel of its own (the card "
                           "runs it in interval_fixpoint's launch); call it "
                           "with impl='plain'")
    tv = t_valid != 0
    old = too_old != 0
    cf = conf != 0
    codes_out.copy_(torch.where(
        ~tv, RES_INVALID,
        torch.where(old, RES_TOO_OLD,
                    torch.where(cf, RES_CONFLICT, RES_COMMITTED))).to(
                        torch.int8))
    survivor = tv & ~old & ~cf
    w_txn_c = torch.clamp(w_txn, 0, t_cap - 1).long()
    return ((w_valid != 0) & survivor[w_txn_c]).to(torch.int32)


def unpack_meta(meta: torch.Tensor, t_cap: int, r_cap: int,
                w_cap: int) -> dict:
    """Views of the metadata block's sections (layout at meta_size)."""
    out, o = {}, 0
    for name, n in (("r_txn", r_cap), ("r_valid", r_cap), ("w_txn", w_cap),
                    ("w_valid", w_cap), ("t_snap", t_cap),
                    ("t_has_reads", t_cap), ("t_valid", t_cap),
                    ("now_rel", 1), ("oldest_rel", 1)):
        out[name] = meta[o:o + n]
        o += n
    return out


class GeneralStep:
    """Per-batch step of the general interval path (reference
    fused.py:427): range reads and writes, keys of any length, point
    batches the compact layout rejects.

    step(bk, bv, table, size, dk, dv, dtable, dsize, flag, digests, meta,
         rounds_acc=None) -> (dk, dv, dsize, flag, out)
    digests: rows int32[2R + 2W, 8] = r_b | r_e | w_b | w_e, MAX padded;
    meta: int32[meta_size(T, R, W)].  dk/dv/dsize/flag are updated IN
    PLACE and returned; out = int8[t_cap + 12] (codes, then flag / delta
    size / base size as int32 bytes).  `dtable` is the delta table over
    the INPUT delta (delta_table_step).  rounds_acc (int32[1]), when
    given, accumulates the fixpoint's round count.

    As CompactStep, the call composes history (per shard; reads clipped
    to the shard's bounds when given), resolve (once) and insert (per
    shard; writes clipped to the bounds when given)."""

    def __init__(self, cap: int, d_cap: int, t_cap: int, r_cap: int,
                 w_cap: int, impl=None) -> None:
        self.t_cap, self.r_cap, self.w_cap, self.impl = (t_cap, r_cap, w_cap,
                                                         impl)
        self.u_cap = _next_pow2(2 * (r_cap + w_cap))
        self.log_u = self.u_cap.bit_length() - 1

    def history(self, bk, table, dk, dtable, digests, meta,
                bounds=None) -> dict:
        """Everything up to the history bits `h["g"]["hist"]`: max(base,
        delta) over each read against its snapshot, and general_prep.
        With bounds (the shard's (lo, hi) rows) each read is clipped to
        them and a read with nothing owned contributes NEG_INF (reference
        fused.py:485-502)."""
        r_cap = self.r_cap
        r_b, r_e = digests[:r_cap], digests[r_cap:2 * r_cap]
        if bounds is None:
            vmax = history_probe(bk, table, dk, dtable, r_b, r_e, self.impl)
        else:
            cr_b, cr_e, owned, _ = clip_rows(r_b, r_e, *bounds,
                                             impl=self.impl)
            vmax = history_probe(bk, table, dk, dtable, cr_b, cr_e,
                                 self.impl, own=owned)
        m = unpack_meta(meta, self.t_cap, r_cap, self.w_cap)
        return {"digests": digests, "m": m, "bounds": bounds,
                "g": general_prep(m, vmax, self.impl)}

    def resolve(self, h: dict, hist: torch.Tensor, out: torch.Tensor,
                rounds_acc=None) -> torch.Tensor:
        """The endpoint universe, the fixpoint from the (combined) history
        bits with the codes into out[:t_cap] (one device operation after
        the sort and the search); returns the insert mask."""
        impl, r_cap, w_cap = self.impl, self.r_cap, self.w_cap
        digests, m, g = h["digests"], h["m"], h["g"]
        # The endpoint gap universe: every endpoint of the batch sorted
        # (MAX padded to u_cap), and each range as a span of its gaps.
        # Every endpoint is placed by one search over the whole batch.
        universe = max_rows(self.u_cap, digests.device)
        sort_rows(digests, out=universe[:digests.shape[0]], impl=impl)
        pos = searchsorted(universe, digests, True, impl)
        r_pos, w_pos = pos[:2 * r_cap], pos[2 * r_cap:]
        # The fixpoint and, in its launch, the codes and the insert mask.
        _, _, w_ins = interval_fixpoint(
            hist, m["r_txn"], g["r_live"], r_pos[:r_cap], r_pos[r_cap:],
            m["w_txn"], g["w_ok"], w_pos[:w_cap], w_pos[w_cap:], self.log_u,
            rounds_acc, impl, codes_out=out[:self.t_cap],
            t_valid=m["t_valid"], too_old=g["too_old"], w_valid=m["w_valid"])
        return w_ins

    def insert(self, h: dict, dk, dv, dsize, flag, size, w_ins,
               tail) -> None:
        """The surviving writes into the delta at `now`, IN PLACE (clipped
        to the shard's bounds when history had them, reference
        fused.py:553-555); flag, delta size and `size` into tail
        (int32[3])."""
        o = 2 * self.r_cap
        w_b = h["digests"][o:o + self.w_cap]
        w_e = h["digests"][o + self.w_cap:]
        if h["bounds"] is not None:
            w_b, w_e, w_ins, _ = clip_rows(w_b, w_e, *h["bounds"],
                                           valid=w_ins, impl=self.impl)
        window_insert(WindowState(dk, dv, dsize), w_b, w_e, w_ins,
                      h["m"]["now_rel"], flag=flag, bsize=size, tail=tail,
                      impl=self.impl)

    def __call__(self, bk, bv, table, size, dk, dv, dtable, dsize, flag,
                 digests, meta, rounds_acc=None):
        h = self.history(bk, table, dk, dtable, digests, meta)
        out = torch.empty((self.t_cap + OUT_EXTRA,), dtype=torch.int8,
                          device=digests.device)
        w_ins = self.resolve(h, h["g"]["hist"], out, rounds_acc)
        self.insert(h, dk, dv, dsize, flag, size, w_ins,
                    out[self.t_cap:].view(torch.int32))
        return dk, dv, dsize, flag, out


def make_resolve_step(cap: int, d_cap: int, t_cap: int, r_cap: int,
                      w_cap: int, impl=None) -> GeneralStep:
    """The general interval step for one bucket shape (GeneralStep)."""
    return GeneralStep(cap, d_cap, t_cap, r_cap, w_cap, impl)


# Merged elements a block of mg_merge owns (csrc/rank_scan.cu MG_TILE).
MERGE_TILE = 1016


def make_merge_step(cap: int, d_cap: int, impl=None):
    """The merge: overlay delta onto base + removeBefore GC + rebase +
    base table + delta reset (reference fused.py:593).

    fn(bk, bv, table, size, dk, dv, dsize, flag, scalars, first=None)
      -> (bk, bv, table, size, dk, dv, dsize, flag), all updated IN PLACE.
    scalars = (new_oldest_rel, rebase_delta), host ints.  The reset
    delta's covering boundary is the zero digest, or `first` (a row
    int32[8]): a key-range shard's lower split, the sharded reference's
    dk0_first (fused.py:679-683).  The plain version places the merged
    sequence in an s_cap = CAP + DCAP scratch before the base is
    rewritten, since the placement reads bk; the kernel merges the two
    tiers' live rows by a merge path into a CAP-row scratch base (rows
    past size / dsize are MAX rows, the window's invariant)."""
    s_cap = cap + d_cap

    def merge(bk, bv, table, size, dk, dv, dsize, flag, scalars, first=None):
        new_oldest_rel, rebase_delta = int(scalars[0]), int(scalars[1])
        if _k.use_kernel(bk, impl):
            _merge_kernel(bk, bv, size, dk, dv, dsize, flag, new_oldest_rel,
                          rebase_delta, s_cap, first)
        else:
            _merge_plain(bk, bv, size, dk, dv, dsize, flag, new_oldest_rel,
                         rebase_delta, s_cap, first)
        build_sparse_table(bv, out=table, impl=impl)
        return bk, bv, table, size, dk, dv, dsize, flag

    return merge


def _merge_plain(bk, bv, size, dk, dv, dsize, flag, new_oldest_rel,
                 rebase_delta, s_cap, first) -> None:
    cap, d_cap = bk.shape[0], dk.shape[0]
    dev = bk.device
    p_ = "plain"
    idx_b, idx_d = _iota(cap, dev), _iota(d_cap, dev)
    live_b = idx_b < size
    live_d = idx_d < dsize

    # Pointwise-max values at every boundary of either tier (where delta
    # covers a key its version is newer than base's, so max == overlay).
    pl = searchsorted(bk, dk, True, p_)
    pr = searchsorted(bk, dk, False, p_)
    slot_db = torch.clamp(rank_count(pl, cap, p_) - 1, 0, d_cap - 1)
    v_b = torch.maximum(bv, dv[slot_db.long()])
    slot_bd = torch.clamp(pr - 1, 0, cap - 1)
    v_d = torch.maximum(dv, bv[slot_bd.long()])

    # Dedup: a base boundary with an equal live delta boundary is dropped.
    p = rank_count(pr, cap, p_)
    dup_b = (p < dsize) & lex_eq(dk[torch.clamp(p, max=d_cap - 1).long()],
                                 bk)
    keep_b = live_b & ~dup_b

    # Merged-order positions via cross ranks.
    rank_b = inclusive_scan(keep_b.to(torch.int32), p_) - 1
    d_before = torch.minimum(p, dsize)
    pos_b = torch.where(keep_b, rank_b + d_before, s_cap)
    b_before_raw = torch.minimum(pl, size)
    drop_prefix = inclusive_scan(dup_b.to(torch.int32), p_)
    drops_before = torch.where(
        b_before_raw > 0,
        drop_prefix[torch.clamp(b_before_raw - 1, 0, cap - 1).long()], 0)
    pos_d = torch.where(live_d, idx_d + b_before_raw - drops_before, s_cap)

    s_rows = max_rows(s_cap, dev)
    sv = torch.full((s_cap,), NEG_INF, dtype=torch.int32, device=dev)
    scatter_set(s_rows, pos_b, bk)
    scatter_set(sv, pos_b, torch.where(keep_b, v_b, NEG_INF))
    scatter_set(s_rows, pos_d, dk)
    scatter_set(sv, pos_d, torch.where(live_d, v_d, NEG_INF))
    m_size = keep_b.sum(dtype=torch.int32) + live_d.sum(dtype=torch.int32)

    # removeBefore GC (SkipList.cpp:576 wasAbove: drop a boundary when it
    # and its predecessor are both below the floor) + version rebase.
    idx_s = _iota(s_cap, dev)
    live_s = idx_s < m_size
    above = sv >= new_oldest_rel
    prev_above = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                            above[:-1]])
    keep_s = (live_s & ((idx_s == 0) | above | prev_above)).to(torch.int32)
    ks_incl = inclusive_scan(keep_s, p_)
    final_size = ks_incl[-1]
    out_rows = max_rows(cap, dev)
    out_v = torch.full((cap,), NEG_INF, dtype=torch.int32, device=dev)
    compact_rows(keep_s, ks_incl, s_rows, sv, out_rows, out_v,
                 rebase=rebase_delta, impl=p_)
    bk.copy_(out_rows)
    bv.copy_(out_v)
    # On overflow the state is poisoned (entries dropped); the sticky flag
    # makes every later wait() fail loudly rather than mis-verdict.
    flag.copy_(flag | (final_size > cap).to(torch.int32))
    size.copy_(torch.clamp(final_size, max=cap))
    fresh = make_delta_state(d_cap, dev, first)
    dk.copy_(fresh.bk)
    dv.copy_(fresh.bv)
    dsize.copy_(fresh.size)


def _merge_kernel(bk, bv, size, dk, dv, dsize, flag, new_oldest_rel,
                  rebase_delta, s_cap, first) -> None:
    """mg_merge: partition, merge and finish, three launches (csrc/
    rank_scan.cu); its scratch needs no fill."""
    cap, d_cap = bk.shape[0], dk.shape[0]
    dev = bk.device
    n = 2 * (-(-s_cap // MERGE_TILE) + 1) + 1
    _k.launch("merge", "mg_merge", bk, bv, cap, size, dk, dv, d_cap, dsize,
              flag, first, new_oldest_rel, rebase_delta,
              torch.empty((n,), dtype=torch.int64, device=dev), n,
              torch.empty((cap * 9,), dtype=torch.int32, device=dev),
              count=3)
