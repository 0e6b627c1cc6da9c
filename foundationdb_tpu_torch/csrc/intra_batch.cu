// intra_batch: the per-batch transaction logic of the compact point step.
//
// Replaces (foundationdb_tpu, conflict/fused.py make_resolve_step_compact):
//   ib_unpack      -- :300-330 the compact buffer's unpacking: the unique
//                     keys widened to rows (:300-321), too-old
//                     (SkipList.cpp:819) and the r_txn / w_txn rank_counts
//                     (ops/digest.py:221), one cooperative launch;
//   ib_rw_prep     -- :332-371 live reads, the history verdict of each read
//                     from the unique-key maxima, scatter-max per txn, and
//                     the writers' txn, base eligibility and slot, in one
//                     launch;
//   ib_fixpoint    -- :373-385 the Jacobi intra-batch fixpoint
//                     (lax.while_loop), iterated ON THE DEVICE, and, in a
//                     last phase of the same launch, :388-405 survivors,
//                     the insert mask and verdict codes;
// and of the general interval step (make_resolve_step):
//   ig_prep        -- :479-511 too-old per txn from the metadata block,
//                     live reads, their history verdicts (from the
//                     two-tier maxima of history_probe) scatter-maxed per
//                     txn, and the writers' base eligibility, one
//                     cooperative launch.
// The general step's codes (:550-566) are the last phase of segtree.cu's
// sg_fixpoint.
//
// Bound on the card: bytes for the prep and code passes (each array read
// and written once).  The fixpoint's least work is one pass over writes,
// reads and txns per round, for as many rounds as the batch's chain depth;
// at config 2 that is ~3 MB a round, so its time is the rounds' grid-wide
// barriers and dependent loads, not bandwidth.
//
// Design: the fixpoint is one cooperative persistent launch over every SM
// (cudaLaunchCooperativeKernel; the grid is the blocks the occupancy query
// lets co-reside, at most FIX_BLOCKS_PER_SM an SM, and no more than the
// work needs), looping on the device with cooperative_groups grid.sync()
// between phases, so the host never synchronises per round.  A round is
// three phases and three barriers: atomicMin each active write's txn into
// the cover | scatter each live read's hit into the next conflicts |
// compare and copy into conf, raising the round's changed flag.  Every
// thread leaves the loop after the same barrier, so conf is final and
// visible grid-wide there, and the codes and the insert mask (batch_codes)
// are written by a last phase with no barrier of its own: the compact
// step's resolve is one device operation.  Cover and
// next-conflict scratch are double-buffered by round parity: the compare
// phase of round r refills round r+1's buffers (cover to INF, the next
// conflicts to the history baseline), which no phase of round r touches,
// so no fourth barrier is spent on the reset.  The changed flags are
// double-buffered the same way: round r clears its flag in its first
// phase; every thread last read it at the end of round r-2, behind round
// r-1's barriers.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define FIX_THREADS 256
// Blocks an SM: measured on the H100 at 1, 2, 3, 4, 6 and 8, two gave the
// fastest config-2 batch and 300-deep chain; more blocks make every grid
// barrier slower, fewer leave the phases' loads short of parallelism.
#define FIX_BLOCKS_PER_SM 2

// The reads' and the writes' prep in one launch: blocks [0, read_blocks)
// take the reads, the rest the writes, RW_VEC consecutive elements a
// thread.  The inputs move as int4 loads and the outputs as int4 stores
// when every array is 16-byte aligned (VEC) and the four lie below the
// pad; four across the pad, or any four without VEC, go element by
// element.  A read's gathers (too_old and t_snap of its txn, vmax_u of its
// slot) are issued for all four elements before any is used, and only for
// reads below n_r (the rest are not live and gather nothing).  No order of
// r_cnt / w_cnt is assumed: each element's txn is its own count minus one.
// Timed on the H100 at 256 threads x 4 and 8 elements and 128 x 4: 8 was
// 20% slower, 128 x 4 level with 256 x 4.
#define RW_VEC 4
#define RW_ITEMS (THREADS * RW_VEC)  // elements a block

struct RwArgs {
  int r_pad, w_pad, t_cap, u_pad;
  const int* r_uid;
  const int* r_cnt;
  const int* w_uid;
  const int* w_cnt;
  const int* too_old;
  const int* t_snap;
  const int* scal;
  const int* vmax_u;
  int* r_txn;
  int* r_live;
  int* r_slot;
  int* hist;  // zeroed by the wrapper; live reads with a hit set their txn
  int* w_txn;
  int* w_ok;
  int* w_slot;
};

// RW_VEC consecutive elements from i (0 past n): int4 loads when VEC and
// all of them lie below n, else element by element.
template <bool VEC>
__device__ __forceinline__ void load_run(const int* __restrict__ a, long i,
                                         long n, int v[RW_VEC]) {
  if (VEC && i + RW_VEC <= n) {
#pragma unroll
    for (int q = 0; q < RW_VEC / 4; ++q) {
      const int4 x = *reinterpret_cast<const int4*>(a + i + 4 * q);
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k) v[k] = i + k < n ? a[i + k] : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_run(int* __restrict__ a, long i,
                                          long n, const int v[RW_VEC]) {
  if (VEC && i + RW_VEC <= n) {
#pragma unroll
    for (int q = 0; q < RW_VEC / 4; ++q)
      *reinterpret_cast<int4*>(a + i + 4 * q) =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k)
      if (i + k < n) a[i + k] = v[k];
  }
}

// ------------------------------------------- the compact step's unpacking
// compact_prep (conflict/fused.py): ib_unpack, one cooperative launch
// over a co-resident grid of UNPACK_BLOCKS_PER_SM blocks an SM, in three
// phases:
//   zero   | grid.sync | widen and count | grid.sync | scan.
// The chain is latency-bound: its least bytes (~8 MB at config 2, ~2.4
// us) are under half of what one queued operation costs on the stream
// (~5 us on the H100, PERF.md), so the design is about operations: on the
// H100 the same work as a zero fill and two launches (unpack and count |
// scan) took 0.0280 ms a call at config 2, this launch with its two grid
// barriers 0.0207.
//
// zero: the histograms of the read and write starts and their per-tile
// totals, the only scratch the count adds to; the hists that the
// read_write_prep calls after it fill are zeroed after the barrier.
// widen: a unique key a thread (lw 16 and a 16-byte-aligned section: one
// 16-byte load, the lanes by byte permutes; otherwise byte loads), each
// row stored as two 16-byte halves.
// count: UNPACK_VEC consecutive txns a thread (int4 loads and stores when
// VEC), a block's run of txns at a time: too-old, and each txn's clamped
// start into hist_r / hist_w (a plain atomic a start: a batch's starts
// are sorted and mostly distinct) and its tile, p / RANK_TILE, into
// tot_r / tot_w (count_runs).  Starts need no order: the counts are a
// histogram.
// scan: a tile of RANK_TILE counts a block at a time, read tiles then
// write tiles (no tile straddles the two): the totals of the tiles before
// it in its segment plus a scan of its own counts in registers, into
// r_cnt or w_cnt; no look-back, since every count is in place after the
// barrier.  Sums wrap in int32, as torch.cumsum does.
// Timed at config 2 on the H100 with grids of 132, 264 and ~450 blocks of
// 256 threads (the last as many as the work needs): one block an SM was
// the fastest, the barriers' cost growing with the grid.
#define UNPACK_THREADS 256
#define UNPACK_BLOCKS_PER_SM 1
#define UNPACK_VEC RW_VEC  // txns a thread
#define UNPACK_ITEMS (UNPACK_THREADS * UNPACK_VEC)
#define RANK_STEPS 2       // 128-bit loads a lane
#define RANK_WARP_ITEMS (32 * 4 * RANK_STEPS)
#define RANK_TILE (UNPACK_THREADS / 32 * RANK_WARP_ITEMS)

// ib_unpack's int32 scratch, which this file alone lays out
// (ib_unpack_layout tells the caller its size and where the hists are):
// hist_r [r_pad], hist_w [w_pad], tot_r [tiles of r_pad], tot_w [tiles of
// w_pad] -- what the count adds to, zeroed before the first barrier --
// then n_hist hists of t_cap, each section at a multiple of 32 ints (128
// bytes, for the 16-byte moves).
struct UnpackLayout {
  long hist_r, hist_w, tot_r, tot_w, hists, hist_stride, total;
};

__host__ inline UnpackLayout unpack_layout(int t_cap, int r_pad, int w_pad,
                                           int n_hist) {
  auto up = [](long n) { return (n + 31) & ~31L; };
  auto tiles = [](long n) { return (n + RANK_TILE - 1) / RANK_TILE; };
  UnpackLayout l;
  l.hist_r = 0;
  l.hist_w = l.hist_r + up(r_pad);
  l.tot_r = l.hist_w + up(w_pad);
  l.tot_w = l.tot_r + up(tiles(r_pad));
  l.hists = l.tot_w + up(tiles(w_pad));
  l.hist_stride = up(t_cap);
  l.total = l.hists + (long)n_hist * l.hist_stride;
  return l;
}

struct UnpackArgs {
  int u_pad, lw, t_cap, r_pad, w_pad;
  int wide16;  // lw is 16 and ub 16-byte aligned
  const uint8_t* ub;
  const int* r_start;
  const int* w_start;
  const int* t_snap;
  const uint8_t* t_flags;
  const int* scal;
  uint32_t* u_b;
  uint32_t* u_e;
  int* too_old;
  int* r_cnt;
  int* w_cnt;
  int* hist_r;   // [r_pad]
  int* hist_w;   // [w_pad]
  int* tot_r;    // [ceil(r_pad / RANK_TILE)]
  int* tot_w;
  int* scratch;  // [n_scratch]: [0, n_count) holds hist_r .. tot_w
  long n_count, n_scratch;  // UnpackLayout's hists and total
};

// One unique key's row, the reference's lanes (fused.py:300-321): byte
// pos < L of the key, the marker byte ub[L] at pos 31, else 0.
__device__ __forceinline__ Row widen_row(const uint8_t* src, int lw,
                                         bool wide16) {
  Row r;
  if (wide16) {  // L = 15: lanes 0-3 the 15 bytes, lane 7 the marker
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    r.l[0] = __byte_perm(q.x, 0, 0x0123);
    r.l[1] = __byte_perm(q.y, 0, 0x0123);
    r.l[2] = __byte_perm(q.z, 0, 0x0123);
    r.l[3] = __byte_perm(q.w, 0, 0x0123) & 0xFFFFFF00u;
    r.l[4] = r.l[5] = r.l[6] = 0u;
    r.l[7] = q.w >> 24;
    return r;
  }
  const int L = lw - 1;
#pragma unroll
  for (int lane = 0; lane < 8; ++lane) {
    uint32_t acc = 0;
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
      const int pos = 4 * lane + bi;
      acc = acc * 256u;
      if (pos < L) acc += src[pos];
      else if (pos == 31) acc += src[L];
    }
    r.l[lane] = acc;
  }
  return r;
}

// Rows u of u_b and u_e: past u_n MAX, and the end gets no +1.
__device__ __forceinline__ void widen_key(const UnpackArgs& a, long u,
                                          int u_n) {
  if (u >= u_n) {
    const Row m = max_row();
    store_row(a.u_b, u, m);
    store_row(a.u_e, u, m);
    return;
  }
  Row r = widen_row(a.ub + u * (long)a.lw, a.lw, a.wide16 != 0);
  store_row(a.u_b, u, r);
  r.l[7] += 1u;
  store_row(a.u_e, u, r);
}

// Txns t0 .. t0 + UNPACK_VEC - 1 (those below t_cap); every lane of the
// warp calls it (count_runs).
template <bool VEC>
__device__ __forceinline__ void count_txns(const UnpackArgs& a, long t0,
                                           int n_t, int oldest) {
  const long t_cap = a.t_cap;
  int rs[UNPACK_VEC], ws[UNPACK_VEC], snap[UNPACK_VEC];
  load_run<VEC>(a.r_start, t0, t_cap, rs);
  load_run<VEC>(a.w_start, t0, t_cap, ws);
  load_run<VEC>(a.t_snap, t0, t_cap, snap);
  uint32_t flags = 0;  // byte k: t0 + k's
  if (VEC && t0 + UNPACK_VEC <= t_cap) {
    flags = *reinterpret_cast<const uint32_t*>(a.t_flags + t0);
  } else {
#pragma unroll
    for (int k = 0; k < UNPACK_VEC; ++k)
      if (t0 + k < t_cap) flags |= (uint32_t)a.t_flags[t0 + k] << (8 * k);
  }
  // Each txn's clamped start and its tile, -1 where nothing is counted
  // (padding txns sit at r_pad / w_pad, which nothing counts).
  int old[UNPACK_VEC], pr[UNPACK_VEC], pw[UNPACK_VEC], tr[UNPACK_VEC],
      tw[UNPACK_VEC];
#pragma unroll
  for (int k = 0; k < UNPACK_VEC; ++k) {
    const bool valid = t0 + k < t_cap && t0 + k < n_t;
    old[k] = (valid && ((flags >> (8 * k)) & 1u) && snap[k] < oldest) ? 1
                                                                      : 0;
    pr[k] = valid ? clampi(rs[k], 0, a.r_pad) : a.r_pad;
    pw[k] = valid ? clampi(ws[k], 0, a.w_pad) : a.w_pad;
    pr[k] = pr[k] < a.r_pad ? pr[k] : -1;
    pw[k] = pw[k] < a.w_pad ? pw[k] : -1;
    tr[k] = pr[k] >= 0 ? pr[k] / RANK_TILE : -1;
    tw[k] = pw[k] >= 0 ? pw[k] / RANK_TILE : -1;
  }
  store_run<VEC>(a.too_old, t0, t_cap, old);
#pragma unroll
  for (int k = 0; k < UNPACK_VEC; ++k) {
    if (pr[k] >= 0) atomicAdd(&a.hist_r[pr[k]], 1);
    if (pw[k] >= 0) atomicAdd(&a.hist_w[pw[k]], 1);
  }
  count_runs(a.tot_r, tr);
  count_runs(a.tot_w, tw);
}

// Tile `tile` of a segment of n counts, block-wide: out = the totals of
// the tiles before it plus the inclusive scan of its own.  The counts are
// read through L2 (written by this launch before its barrier).
__device__ __forceinline__ void scan_tile(const int* hist, const int* tot,
                                          int* out, long n, long tile,
                                          unsigned* s_before,
                                          unsigned* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long base = tile * RANK_TILE + (long)warp * RANK_WARP_ITEMS;
  const bool full = (tile + 1) * RANK_TILE <= n;
  unsigned x[RANK_STEPS][4];
  if (full) {  // the tile's loads before the totals' sum
#pragma unroll
    for (int s = 0; s < RANK_STEPS; ++s) {
      const int4 q = __ldcg(reinterpret_cast<const int4*>(
          hist + base + (long)(s * 32 + lane) * 4));
      x[s][0] = q.x; x[s][1] = q.y; x[s][2] = q.z; x[s][3] = q.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < RANK_STEPS; ++s) {
      const long i0 = base + (long)(s * 32 + lane) * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[s][k] = i0 + k < n ? (unsigned)__ldcg(hist + i0 + k) : 0u;
    }
  }
  unsigned before = 0u;
  for (long j = threadIdx.x; j < tile; j += UNPACK_THREADS)
    before += (unsigned)__ldcg(tot + j);
  before = warp_sum(before);
  unsigned carry = 0u;  // the warp's sum of its earlier steps
#pragma unroll
  for (int s = 0; s < RANK_STEPS; ++s) {
#pragma unroll
    for (int k = 1; k < 4; ++k) x[s][k] += x[s][k - 1];
    const unsigned incl = warp_inclusive_scan(x[s][3], lane);
    const unsigned excl = incl - x[s][3] + carry;
#pragma unroll
    for (int k = 0; k < 4; ++k) x[s][k] += excl;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncthreads();  // the block's previous tile has read s_before / s_warp
  if (lane == 0) {
    s_before[warp] = before;
    s_warp[warp] = carry;
  }
  __syncthreads();
  unsigned add = 0u;
#pragma unroll
  for (int w = 0; w < UNPACK_THREADS / 32; ++w) {
    add += s_before[w];
    if (w < warp) add += s_warp[w];
  }
  if (full) {
#pragma unroll
    for (int s = 0; s < RANK_STEPS; ++s)
      *reinterpret_cast<int4*>(out + base + (long)(s * 32 + lane) * 4) =
          make_int4((int)(x[s][0] + add), (int)(x[s][1] + add),
                    (int)(x[s][2] + add), (int)(x[s][3] + add));
  } else {
#pragma unroll
    for (int s = 0; s < RANK_STEPS; ++s) {
      const long i0 = base + (long)(s * 32 + lane) * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) out[i0 + k] = (int)(x[s][k] + add);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(UNPACK_THREADS) k_unpack(UnpackArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_scal[3];  // u_n, n_t, oldest_rel
  __shared__ unsigned s_before[UNPACK_THREADS / 32];
  __shared__ unsigned s_warp[UNPACK_THREADS / 32];
  if (threadIdx.x == 0) {
    s_scal[0] = a.scal[0];
    s_scal[1] = a.scal[3];
    s_scal[2] = a.scal[5];
  }
  const long gtid = blockIdx.x * (long)UNPACK_THREADS + threadIdx.x;
  const long gstride = (long)gridDim.x * UNPACK_THREADS;
  const int4 zero4 = make_int4(0, 0, 0, 0);
  for (long i = 4 * gtid; i < a.n_count; i += 4 * gstride)
    *reinterpret_cast<int4*>(a.scratch + i) = zero4;
  grid.sync();
  for (long i = a.n_count + 4 * gtid; i < a.n_scratch; i += 4 * gstride)
    *reinterpret_cast<int4*>(a.scratch + i) = zero4;
  for (long u = gtid; u < a.u_pad; u += gstride) widen_key(a, u, s_scal[0]);
  for (long b0 = blockIdx.x * (long)UNPACK_ITEMS; b0 < a.t_cap;
       b0 += (long)gridDim.x * UNPACK_ITEMS)  // block-uniform trips
    count_txns<VEC>(a, b0 + (long)threadIdx.x * UNPACK_VEC, s_scal[1],
                    s_scal[2]);
  grid.sync();
  const long tiles_r = ((long)a.r_pad + RANK_TILE - 1) / RANK_TILE;
  const long tiles_w = ((long)a.w_pad + RANK_TILE - 1) / RANK_TILE;
  for (long b = blockIdx.x; b < tiles_r + tiles_w; b += gridDim.x) {
    if (b < tiles_r)
      scan_tile(a.hist_r, a.tot_r, a.r_cnt, a.r_pad, b, s_before, s_warp);
    else
      scan_tile(a.hist_w, a.tot_w, a.w_cnt, a.w_pad, b - tiles_r, s_before,
                s_warp);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    k_rw_prep(RwArgs a, int read_blocks) {
  __shared__ int s_n;
  const bool reads = (int)blockIdx.x < read_blocks;
  if (threadIdx.x == 0) s_n = a.scal[reads ? 1 : 2];  // n_r or n_w
  __syncthreads();
  const long n_live = s_n;
  const long blk = reads ? blockIdx.x : blockIdx.x - read_blocks;
  const long i = (blk * THREADS + threadIdx.x) * RW_VEC;
  const long pad = reads ? a.r_pad : a.w_pad;
  if (i >= pad) return;
  int uid[RW_VEC], cnt[RW_VEC];
  load_run<VEC>(reads ? a.r_uid : a.w_uid, i, pad, uid);
  load_run<VEC>(reads ? a.r_cnt : a.w_cnt, i, pad, cnt);
  int txn[RW_VEC], tc[RW_VEC], slot[RW_VEC];
  bool valid[RW_VEC];
#pragma unroll
  for (int k = 0; k < RW_VEC; ++k) {
    txn[k] = (int)((unsigned)cnt[k] - 1u);  // wraps, as int32 in torch
    tc[k] = clampi(txn[k], 0, a.t_cap - 1);
    slot[k] = clampi(uid[k], 0, a.u_pad - 1);
    valid[k] = i + k < pad && i + k < n_live;
  }
  if (!reads) {
    int ok[RW_VEC];
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k)
      ok[k] = valid[k] && !a.too_old[tc[k]] ? 1 : 0;
    store_run<VEC>(a.w_txn, i, pad, txn);
    store_run<VEC>(a.w_ok, i, pad, ok);
    store_run<VEC>(a.w_slot, i, pad, slot);
    return;
  }
  int old[RW_VEC], snap[RW_VEC], vmax[RW_VEC], live[RW_VEC];
#pragma unroll
  for (int k = 0; k < RW_VEC; ++k) {  // every gather before any use
    old[k] = valid[k] ? a.too_old[tc[k]] : 1;
    snap[k] = valid[k] ? a.t_snap[tc[k]] : 0;
    vmax[k] = valid[k] ? a.vmax_u[slot[k]] : 0;
  }
#pragma unroll
  for (int k = 0; k < RW_VEC; ++k) {
    live[k] = old[k] ? 0 : 1;
    if (live[k] && vmax[k] > snap[k]) {
      // The reference's .at[r_txn].max(mode="drop"): txn -1 lands on
      // t_cap - 1, as its negative index normalises.
      const long d = scatter_index(txn[k], a.t_cap);
      if (d >= 0) a.hist[d] = 1;
    }
  }
  store_run<VEC>(a.r_txn, i, pad, txn);
  store_run<VEC>(a.r_live, i, pad, live);
  store_run<VEC>(a.r_slot, i, pad, slot);
}

struct IbFixArgs {
  int t_cap, r_pad, w_pad, u_pad;
  const int* hist;
  const int* r_txn;
  const int* r_live;
  const int* r_slot;
  const int* w_txn;
  const int* w_ok;
  const int* w_slot;
  int* cover;    // int32[2 * (u_pad + 1)], one half per round parity
  int* nconf;    // int32[2 * t_cap], the same
  int* changed;  // int32[2], one flag per round parity
  int* conf;     // out: int32[t_cap]
  int* rounds;   // out: int32[1]
  // The codes phase, run when codes is not null: scal (the compact
  // scalars, n_w at 2 and n_t at 3, read on the device) and too_old in,
  // codes (int8[t_cap]) and w_ins (int32[w_pad]) out; vec: too_old,
  // conf, w_txn and w_ins 16-byte and codes 4-byte aligned.
  const int* scal;
  const int* too_old;
  int8_t* codes;
  int* w_ins;
  int vec;
};

// A txn's verdict code (reference fused.py:400-404).
__device__ __forceinline__ int code_of(long t, int n_t, int old, int cf) {
  return t >= n_t ? -1 : old ? 1 : cf ? 0 : 2;
}

// The codes phase of k_ib_fixpoint, four txns or four writes a thread
// (the txns' quads, then the writes'), every load of a quad before any
// use: int4 loads of too_old and conf and one 32-bit store of four codes;
// a write quad's txns by one int4 load, its eight gathers, one int4
// store.  conf was last written before the rounds' last barrier, by other
// blocks: it is read through L2.
__device__ __forceinline__ void write_codes(const IbFixArgs& a, long gtid,
                                            long gstride) {
  const int n_w = __ldg(a.scal + 2);
  const int n_t = __ldg(a.scal + 3);
  const long t_cap = a.t_cap;
  const long t_quads = (t_cap + 3) / 4;
  const long quads = t_quads + (a.w_pad + 3L) / 4;
  for (long q = gtid; q < quads; q += gstride) {
    if (q < t_quads) {
      const long t0 = 4 * q;
      if (a.vec && t0 + 4 <= t_cap) {
        const int4 o = __ldg(reinterpret_cast<const int4*>(a.too_old + t0));
        const int4 c = __ldcg(reinterpret_cast<const int4*>(a.conf + t0));
        const uint32_t packed =
            (code_of(t0, n_t, o.x, c.x) & 0xFF) |
            (code_of(t0 + 1, n_t, o.y, c.y) & 0xFF) << 8 |
            (code_of(t0 + 2, n_t, o.z, c.z) & 0xFF) << 16 |
            (uint32_t)(code_of(t0 + 3, n_t, o.w, c.w) & 0xFF) << 24;
        *reinterpret_cast<uint32_t*>(a.codes + t0) = packed;
      } else {
        for (long t = t0; t < t0 + 4 && t < t_cap; ++t)
          a.codes[t] = (int8_t)code_of(t, n_t, __ldg(a.too_old + t),
                                       __ldcg(a.conf + t));
      }
      continue;
    }
    const long w0 = 4 * (q - t_quads);
    int tc[4], old[4], cf[4], ins[4];
    if (a.vec && w0 + 4 <= a.w_pad) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(a.w_txn + w0));
      tc[0] = x.x; tc[1] = x.y; tc[2] = x.z; tc[3] = x.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        tc[k] = w0 + k < a.w_pad ? __ldg(a.w_txn + w0 + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // txn -1 reads txn 0's flags
      tc[k] = clampi(tc[k], 0, a.t_cap - 1);
      old[k] = __ldg(a.too_old + tc[k]);
      cf[k] = __ldcg(a.conf + tc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ins[k] = w0 + k < n_w && tc[k] < n_t && !old[k] && !cf[k] ? 1 : 0;
    if (a.vec && w0 + 4 <= a.w_pad) {
      *reinterpret_cast<int4*>(a.w_ins + w0) =
          make_int4(ins[0], ins[1], ins[2], ins[3]);
    } else {
      for (int k = 0; k < 4 && w0 + k < a.w_pad; ++k) a.w_ins[w0 + k] = ins[k];
    }
  }
}

__global__ void __launch_bounds__(FIX_THREADS)
    k_ib_fixpoint(IbFixArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long gtid = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  const long cov_n = a.u_pad + 1L;
  const long t_cap = a.t_cap;
  // Round r works on the buffers of parity r & 1; round 1's are filled
  // here.  Each round recomputes from the history-only baseline (a
  // conflict inferred from a writer that later turns out conflicted must
  // be retractable).
  for (long t = gtid; t < t_cap; t += gstride) {
    const int h = __ldg(a.hist + t);
    a.conf[t] = h;
    a.nconf[t_cap + t] = h;
  }
  for (long u = gtid; u < cov_n; u += gstride) a.cover[cov_n + u] = INF_I32;
  grid.sync();
  // Jacobi on the lower-triangular system settles one more txn of the
  // batch order per round at the least, so t_cap + 1 rounds always
  // suffice; the cap only keeps a fault from spinning the card forever.
  int rounds = 0;
  while (rounds <= a.t_cap) {
    ++rounds;
    const int cur = rounds & 1;
    int* cover = a.cover + cur * cov_n;
    int* nconf = a.nconf + cur * t_cap;
    if (gtid == 0) a.changed[cur] = 0;
    for (long w = gtid; w < a.w_pad; w += gstride) {
      const int wt = __ldg(a.w_txn + w);
      if (__ldg(a.w_ok + w) && !a.conf[clampi(wt, 0, a.t_cap - 1)])
        atomicMin(&cover[__ldg(a.w_slot + w)], wt);
    }
    grid.sync();
    for (long r = gtid; r < a.r_pad; r += gstride) {
      const int rt = __ldg(a.r_txn + r);
      if (__ldg(a.r_live + r) && cover[__ldg(a.r_slot + r)] < rt) {
        const long d = scatter_index(rt, t_cap);
        if (d >= 0) nconf[d] = 1;
      }
    }
    grid.sync();
    int* next_cover = a.cover + (1 - cur) * cov_n;
    int* next_nconf = a.nconf + (1 - cur) * t_cap;
    bool ch = false;
    for (long t = gtid; t < t_cap; t += gstride) {
      const int v = nconf[t];
      if (v != a.conf[t]) {
        a.conf[t] = v;
        ch = true;
      }
      next_nconf[t] = __ldg(a.hist + t);
    }
    for (long u = gtid; u < cov_n; u += gstride) next_cover[u] = INF_I32;
    if (__any_sync(0xffffffffu, ch) && (threadIdx.x & 31) == 0)
      a.changed[cur] = 1;
    grid.sync();
    if (*(volatile int*)&a.changed[cur] == 0) break;
  }
  if (gtid == 0 && a.rounds != nullptr) a.rounds[0] = rounds;
  // batch_codes (reference fused.py:388-405): INVALID past n_t, else
  // TOO_OLD / CONFLICT / COMMITTED; a write is inserted when it is below
  // n_w and its txn (clamped to [0, t_cap)) survives.
  if (a.codes != nullptr) write_codes(a, gtid, gstride);
}

// ------------------------------------------------- general interval step
// general_prep (conflict/fused.py): ig_prep, one cooperative launch over
// a co-resident grid (coop_grid, at most GPREP_BLOCKS_PER_SM blocks an
// SM) and no fill, in two phases:
//   RW_VEC txns a thread: too_old, and hist zeroed | grid.sync |
//   RW_VEC reads or writes a thread (the reads' runs first, then the
//   writes', one index space): r_live and the history bit scattered into
//   hist (txn -1 lands on t_cap - 1, as the reference's negative index
//   normalises); w_ok.
// Like compact_prep it is latency-bound: its least bytes (~10 MB at
// config 3, ~3 us) are under the cost of the three operations it
// replaces (a zero fill of hist, a txn launch and a read-write launch,
// ~5 us each between events on the H100, PERF.md).  Only the zeroing of
// hist has to precede the barrier, since a read's history bit must not
// be cleared after it is set; too_old is written there too and read back
// after it through L2, with t_snap, two gathers issued together.  Arrays
// move as int4 when all of them are 16-byte aligned (VEC), as in
// ib_rw_prep.  Timed at config 3 on the H100 (PERF.md): the kernel 5.81
// us; 6.37 and 6.34 at 1 and 4 blocks an SM; 8.25 with each too-old
// recomputed after the barrier from t_valid, t_has_reads and t_snap
// (three gathers, one after another); 7.27-7.57 with all but the
// scatter before the barrier (each too-old recomputed, the three
// gathers together, the hits kept in registers and scattered after it).
#define GPREP_THREADS 256
#define GPREP_BLOCKS_PER_SM 2

struct GprepArgs {
  int t_cap, r_cap, w_cap;
  const int* r_txn;
  const int* r_valid;
  const int* w_txn;
  const int* w_valid;
  const int* t_snap;
  const int* t_has_reads;
  const int* t_valid;
  const int* oldest_rel;
  const int* vmax;  // [r_cap]: each read's history maximum
  int* too_old;
  int* r_live;
  int* hist;
  int* w_ok;
};

template <bool VEC>
__global__ void __launch_bounds__(GPREP_THREADS) k_gen_prep(GprepArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long gtid = blockIdx.x * (long)GPREP_THREADS + threadIdx.x;
  const long gstride = (long)gridDim.x * GPREP_THREADS;
  const int oldest = __ldg(a.oldest_rel);
  const long t_cap = a.t_cap;
  for (long t0 = RW_VEC * gtid; t0 < t_cap; t0 += RW_VEC * gstride) {
    int valid[RW_VEC], has[RW_VEC], snap[RW_VEC], old[RW_VEC];
    const int zero[RW_VEC] = {};
    load_run<VEC>(a.t_valid, t0, t_cap, valid);
    load_run<VEC>(a.t_has_reads, t0, t_cap, has);
    load_run<VEC>(a.t_snap, t0, t_cap, snap);
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k)
      old[k] = valid[k] && has[k] && snap[k] < oldest ? 1 : 0;
    store_run<VEC>(a.too_old, t0, t_cap, old);
    store_run<VEC>(a.hist, t0, t_cap, zero);
  }
  grid.sync();
  const long r_runs = ((long)a.r_cap + RW_VEC - 1) / RW_VEC;
  const long w_runs = ((long)a.w_cap + RW_VEC - 1) / RW_VEC;
  for (long c = gtid; c < r_runs + w_runs; c += gstride) {
    const bool reads = c < r_runs;
    const long i = (reads ? c : c - r_runs) * RW_VEC;
    const long n = reads ? a.r_cap : a.w_cap;
    int txn[RW_VEC], valid[RW_VEC], vmax[RW_VEC], old[RW_VEC],
        snap[RW_VEC];
    load_run<VEC>(reads ? a.r_txn : a.w_txn, i, n, txn);
    load_run<VEC>(reads ? a.r_valid : a.w_valid, i, n, valid);
    if (reads) load_run<VEC>(a.vmax, i, n, vmax);
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k) {  // every gather before any use
      const bool in = i + k < n && valid[k];
      const int tc = clampi(txn[k], 0, a.t_cap - 1);
      old[k] = in ? __ldcg(a.too_old + tc) : 1;  // through L2
      snap[k] = in && reads ? __ldg(a.t_snap + tc) : 0;
    }
    if (!reads) {
      int ok[RW_VEC];
#pragma unroll
      for (int k = 0; k < RW_VEC; ++k) ok[k] = old[k] ? 0 : 1;
      store_run<VEC>(a.w_ok, i, n, ok);
      continue;
    }
    int live[RW_VEC];
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k) {
      live[k] = old[k] ? 0 : 1;
      if (live[k] && vmax[k] > snap[k]) {
        const long d = scatter_index(txn[k], t_cap);
        if (d >= 0) a.hist[d] = 1;
      }
    }
    store_run<VEC>(a.r_live, i, n, live);
  }
}

#define S(stream) (cudaStream_t)(stream)
#define RET return (int)cudaGetLastError()

// out (host int64[4]): the scratch's int32 length, the offset of its first
// hist, the hists' stride, and the scan's tile (for tests at its edges).
extern "C" int ib_unpack_layout(int t_cap, int r_pad, int w_pad, int n_hist,
                                void* out) {
  if (t_cap < 0 || r_pad < 0 || w_pad < 0 || n_hist < 0)
    return (int)cudaErrorInvalidValue;
  const UnpackLayout l = unpack_layout(t_cap, r_pad, w_pad, n_hist);
  long long* o = (long long*)out;
  o[0] = l.total;
  o[1] = l.hists;
  o[2] = l.hist_stride;
  o[3] = RANK_TILE;
  return 0;
}

// One cooperative launch over min(what the work needs, the co-resident
// blocks, UNPACK_BLOCKS_PER_SM an SM) blocks.  scratch: int32, at least
// ib_unpack_layout's length, 16-byte aligned, as are the arrays moved as
// int4.
extern "C" int ib_unpack(int u_pad, int lw, int t_cap, int r_pad, int w_pad,
                         int n_hist, const void* ub, const void* r_start,
                         const void* w_start, const void* t_snap,
                         const void* t_flags, const void* scal, void* u_b,
                         void* u_e, void* too_old, void* r_cnt, void* w_cnt,
                         void* scratch, long n_scratch, void* stream) {
  const UnpackLayout l = unpack_layout(t_cap, r_pad, w_pad, n_hist);
  if (n_hist < 0 || n_scratch < l.total) return (int)cudaErrorInvalidValue;
  int* sc = (int*)scratch;
  UnpackArgs a{u_pad, lw, t_cap, r_pad, w_pad,
               lw == 16 && (uintptr_t)ub % 16 == 0,
               (const uint8_t*)ub, (const int*)r_start, (const int*)w_start,
               (const int*)t_snap, (const uint8_t*)t_flags, (const int*)scal,
               (uint32_t*)u_b, (uint32_t*)u_e, (int*)too_old, (int*)r_cnt,
               (int*)w_cnt, sc + l.hist_r, sc + l.hist_w, sc + l.tot_r,
               sc + l.tot_w, sc, l.hists, l.total};
  const void* quads[] = {u_b, u_e, r_cnt, w_cnt, scratch};
  for (const void* p : quads)
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)r_start % 16 == 0 &&
                   (uintptr_t)w_start % 16 == 0 &&
                   (uintptr_t)t_snap % 16 == 0 &&
                   (uintptr_t)too_old % 16 == 0 &&
                   (uintptr_t)t_flags % 4 == 0;
  const void* kern = vec ? (const void*)k_unpack<true>
                         : (const void*)k_unpack<false>;
  // The blocks the largest phase needs: a key a thread, a block's run of
  // txns, a tile, a quad of scratch a thread.
  long want = ((long)u_pad + UNPACK_THREADS - 1) / UNPACK_THREADS;
  const long tiles = ((long)r_pad + RANK_TILE - 1) / RANK_TILE +
                     ((long)w_pad + RANK_TILE - 1) / RANK_TILE;
  const long txn_blocks = ((long)t_cap + UNPACK_ITEMS - 1) / UNPACK_ITEMS;
  const long zero_blocks = (l.total / 4 + UNPACK_THREADS - 1) /
                           UNPACK_THREADS;
  if (txn_blocks > want) want = txn_blocks;
  if (tiles > want) want = tiles;
  if (zero_blocks > want) want = zero_blocks;
  int grid = 0;
  cudaError_t err = (cudaError_t)coop_grid(kern, UNPACK_THREADS,
                                           UNPACK_BLOCKS_PER_SM, want, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(UNPACK_THREADS),
                                    args, 0, S(stream));
  if (err != cudaSuccess) return (int)err;
  RET;
}

// One launch: ceil(r_pad / RW_ITEMS) read blocks, then ceil(w_pad /
// RW_ITEMS) write blocks (at least one block in all).
extern "C" int ib_rw_prep(int r_pad, int w_pad, int t_cap, int u_pad,
                          const void* r_uid, const void* r_cnt,
                          const void* w_uid, const void* w_cnt,
                          const void* too_old, const void* t_snap,
                          const void* scal, const void* vmax_u, void* r_txn,
                          void* r_live, void* r_slot, void* hist, void* w_txn,
                          void* w_ok, void* w_slot, void* stream) {
  RwArgs a{r_pad, w_pad, t_cap, u_pad,
           (const int*)r_uid, (const int*)r_cnt, (const int*)w_uid,
           (const int*)w_cnt, (const int*)too_old, (const int*)t_snap,
           (const int*)scal, (const int*)vmax_u, (int*)r_txn, (int*)r_live,
           (int*)r_slot, (int*)hist, (int*)w_txn, (int*)w_ok, (int*)w_slot};
  const long read_blocks = ((long)r_pad + RW_ITEMS - 1) / RW_ITEMS;
  const long write_blocks = ((long)w_pad + RW_ITEMS - 1) / RW_ITEMS;
  const long blocks = read_blocks + write_blocks > 0
                          ? read_blocks + write_blocks : 1;
  const void* quads[] = {r_uid, r_cnt, w_uid, w_cnt, r_txn,
                         r_live, r_slot, w_txn, w_ok, w_slot};
  bool vec = true;
  for (const void* p : quads) vec = vec && (uintptr_t)p % 16 == 0;
  if (vec)
    k_rw_prep<true><<<(unsigned)blocks, THREADS, 0, S(stream)>>>(
        a, (int)read_blocks);
  else
    k_rw_prep<false><<<(unsigned)blocks, THREADS, 0, S(stream)>>>(
        a, (int)read_blocks);
  RET;
}

// codes (with scal, too_old and w_ins) null: the fixpoint alone.
extern "C" int ib_fixpoint(int t_cap, int r_pad, int w_pad, int u_pad,
                           const void* hist, const void* r_txn,
                           const void* r_live, const void* r_slot,
                           const void* w_txn, const void* w_ok,
                           const void* w_slot, void* cover, void* nconf,
                           void* changed, void* conf, void* rounds_out,
                           const void* scal, const void* too_old,
                           void* codes, void* w_ins, void* stream) {
  if (codes != nullptr &&
      (scal == nullptr || too_old == nullptr || w_ins == nullptr))
    return (int)cudaErrorInvalidValue;
  IbFixArgs a;
  a.t_cap = t_cap;
  a.r_pad = r_pad;
  a.w_pad = w_pad;
  a.u_pad = u_pad;
  a.hist = (const int*)hist;
  a.r_txn = (const int*)r_txn;
  a.r_live = (const int*)r_live;
  a.r_slot = (const int*)r_slot;
  a.w_txn = (const int*)w_txn;
  a.w_ok = (const int*)w_ok;
  a.w_slot = (const int*)w_slot;
  a.cover = (int*)cover;
  a.nconf = (int*)nconf;
  a.changed = (int*)changed;
  a.conf = (int*)conf;
  a.rounds = (int*)rounds_out;
  a.scal = (const int*)scal;
  a.too_old = (const int*)too_old;
  a.codes = (int8_t*)codes;
  a.w_ins = (int*)w_ins;
  a.vec = (uintptr_t)too_old % 16 == 0 && (uintptr_t)conf % 16 == 0 &&
          (uintptr_t)w_txn % 16 == 0 && (uintptr_t)w_ins % 16 == 0 &&
          (uintptr_t)codes % 4 == 0;
  long work = u_pad + 1L;
  if (r_pad > work) work = r_pad;
  if (w_pad > work) work = w_pad;
  if (t_cap > work) work = t_cap;
  int grid = 0;
  cudaError_t err = (cudaError_t)coop_grid(
      (const void*)k_ib_fixpoint, FIX_THREADS, FIX_BLOCKS_PER_SM,
      (work + FIX_THREADS - 1) / FIX_THREADS, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)k_ib_fixpoint, dim3(grid),
                                    dim3(FIX_THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One cooperative launch over min(what the work needs, the co-resident
// blocks, GPREP_BLOCKS_PER_SM an SM) blocks.
extern "C" int ig_prep(int t_cap, int r_cap, int w_cap, const void* r_txn,
                       const void* r_valid, const void* w_txn,
                       const void* w_valid, const void* t_snap,
                       const void* t_has_reads, const void* t_valid,
                       const void* oldest_rel, const void* vmax,
                       void* too_old, void* r_live, void* hist, void* w_ok,
                       void* stream) {
  if (t_cap < 1 || r_cap < 0 || w_cap < 0) return (int)cudaErrorInvalidValue;
  GprepArgs a{t_cap, r_cap, w_cap,
              (const int*)r_txn, (const int*)r_valid, (const int*)w_txn,
              (const int*)w_valid, (const int*)t_snap,
              (const int*)t_has_reads, (const int*)t_valid,
              (const int*)oldest_rel, (const int*)vmax, (int*)too_old,
              (int*)r_live, (int*)hist, (int*)w_ok};
  const void* quads[] = {r_txn, r_valid, w_txn, w_valid, t_snap,
                         t_has_reads, t_valid, vmax, too_old, r_live, hist,
                         w_ok};
  bool vec = true;
  for (const void* p : quads) vec = vec && (uintptr_t)p % 16 == 0;
  const void* kern = vec ? (const void*)k_gen_prep<true>
                         : (const void*)k_gen_prep<false>;
  // The blocks the larger phase needs: RW_VEC txns, reads or writes a
  // thread.
  const long runs = ((long)r_cap + RW_VEC - 1) / RW_VEC +
                    ((long)w_cap + RW_VEC - 1) / RW_VEC;
  long want = ((long)t_cap + RW_VEC - 1) / RW_VEC;
  if (runs > want) want = runs;
  int grid = 0;
  cudaError_t err = (cudaError_t)coop_grid(
      kern, GPREP_THREADS, GPREP_BLOCKS_PER_SM,
      (want + GPREP_THREADS - 1) / GPREP_THREADS, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(GPREP_THREADS),
                                    args, 0, S(stream));
  if (err != cudaSuccess) return (int)err;
  RET;
}
