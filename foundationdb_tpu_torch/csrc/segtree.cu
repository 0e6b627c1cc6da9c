// segtree: the general step's Jacobi intra-batch fixpoint over interval
// structures, as one persistent kernel that loops on the device.
//
// Replaces (foundationdb_tpu): conflict/fused.py:531-547, the
// lax.while_loop whose body is ops/segtree.py:28 interval_min_cover
// (per-level min-updates of <= 2 nodes per interval, then the top-down
// pushdown), :61 build_min_table (the doubling range-max table over the
// negated cover) and :71 range_min, followed by the scatter-max of the
// intra-batch hits over the history-only baseline and the changed test;
// and, as the same launch's last phase, :550-566 the survivors, the
// insert mask and the verdict codes (general_codes).
//
// Bound on the card: bytes per round -- the tree (2U int32) read once,
// the cover (U int32) written once, the reads' and writes' columns read
// once; the round count is the batch's chain depth (typically 2-5).
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel, grid no
// larger than the blocks that fit on the card at once, at the kernel's
// dynamic shared memory) whose blocks loop over the rounds together.  A
// round is three phases separated by grid-wide barriers (grid.sync()):
//
//   update    every surviving write min-updates <= 2 nodes per level of
//             the tree (atomicMin, a thread per interval); the conflict
//             buffer of this round is reset to the history baseline;
//   pushdown  a block owns a tile of 2^FIX_TILE_LOG leaves, the subtree
//             under one node: it takes the min over that node's ancestors
//             (one warp), reads the subtree with coalesced loads into
//             shared memory (resetting each node it finds set to INF, so
//             the tree is clean for the next round without a clear pass),
//             pushes the minima down level by level in shared memory and
//             writes the leaves' cover (U int32).  It also writes the
//             minima of each run of 2^FIX_BLOCK_LOG leaves as a doubling
//             table that stays inside the tile (the "in-tile table",
//             U / 32 x 8 int32 at the defaults), and the tile's minimum;
//   queries   each block builds the doubling table over the tile minima in
//             its shared memory; each live read takes the min of the cover
//             over its gap span: a span inside a run of 32 gaps reads the
//             cover (one or two sectors), a longer one reads its partial
//             runs from the cover, its whole runs from the in-tile tables
//             and its whole tiles from the shared table -- O(1) loads.  A
//             hit (an earlier surviving writer) is an atomicMax of 1 into
//             the round's conflict buffer; the first hit on a txn counts
//             whether the previous round held it too.
//
// No doubling table as large as the universe is built: a read spans a few
// gaps, so its min comes from the cover itself, and a table over U would
// cost LOG+1 passes over U and a barrier per level every round.  The
// conflict buffers alternate by round parity, so "did anything change" is
// decided from the two counts of first hits (a round changes iff it finds
// a txn the previous round did not hold, or holds fewer than it) without
// a compare pass.  The codes, when asked for, are written after the
// barrier every thread leaves the rounds on, from the final round's
// buffer, with no barrier of their own (write_gen_codes): the general
// step's fixpoint and codes are one device operation.  The host never
// reads a flag per round; the loop is capped at t_cap + 1 rounds (Jacobi
// on the lower-triangular system settles at least one more txn per round)
// and the round count is written out.  Span endpoints are the universe's
// searchsorted positions, 0 <= pb, pe <= U.  All scratch is one int32
// buffer the wrapper allocates uninitialised; the kernel initialises what
// it reads.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define FIXG_THREADS 256
// Blocks an SM the registers must allow: 4, the 64 registers the rounds
// take.  Without the bound, the codes phase made ptxas choose 48 registers
// with spills, which let 5 blocks an SM into the grid, and the rounds ran
// 10% slower on the H100 (PERF.md).
#define FIXG_MIN_BLOCKS 4
#define FIX_TILE_LOG 12   // leaves a pushdown tile owns: 4,096
#define FIX_BLOCK_LOG 5   // leaves a run minimum covers: 32
#define FIX_TOP_MAX 1024  // tiles the shared top table covers (U <= 2^22)

struct FixArgs {
  int t_cap, r_cap, w_cap, log_u;
  int tl;   // log2 of a tile's leaves
  int lb;   // log2 of a run's leaves
  const int* hist;
  const int* r_txn;
  const int* r_live;
  const int* r_pb;
  const int* r_pe;
  const int* w_txn;
  const int* w_ok;
  const int* w_pb;
  const int* w_pe;
  int* tree;    // int32[2U]
  int* cover;   // int32[U]
  int* intile;  // int32[nt][LV][BPT]
  int* tmin;    // int32[nt]
  int* cbuf;    // int32[2][t_cap]: the conflicts, by round parity
  int* counts;  // int32[2][2]: first hits not held / held before, by parity
  int* conf;    // out: int32[t_cap]
  int* rounds;  // out: int32[1]
  int* rounds_acc;  // optional: += rounds
  // The codes phase, run when codes is not null: t_valid, too_old
  // (int32[t_cap]) and w_valid (int32[w_cap]) in, codes (int8[t_cap]) and
  // w_ins (int32[w_cap]) out; vec: t_valid, too_old, w_txn, w_valid and
  // w_ins 16-byte and codes 4-byte aligned.
  const int* t_valid;
  const int* too_old;
  const int* w_valid;
  int8_t* codes;
  int* w_ins;
  int vec;
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ int flog2(int x) { return 31 - __clz(x); }

// Scratch layout (int32 slots), shared by the launcher and the kernel.
struct FixLayout {
  long tree, cover, intile, tmin, cbuf, counts, total;
};

__host__ __device__ __forceinline__ FixLayout fix_layout(int t_cap,
                                                         int log_u, int tl,
                                                         int lb) {
  const long u = 1L << log_u;
  const long nt = u >> tl;
  const long lv = tl - lb + 1;
  FixLayout l;
  l.tree = 0;
  l.cover = l.tree + 2 * u;
  l.intile = l.cover + u;
  l.tmin = l.intile + (u >> lb) * lv;
  l.cbuf = l.tmin + nt;
  l.counts = l.cbuf + 2L * t_cap;
  l.total = l.counts + 4;
  return l;
}

// min(cover[l, r)) for 0 <= l, r <= U; INF_I32 when the span is empty.
// `top` is the shared doubling table over the tile minima (nullptr when
// there is one tile, or more than FIX_TOP_MAX).
__device__ int cover_min(const FixArgs& a, const int* top, int nt, int l,
                         int r) {
  int m = INF_I32;
  if (l >= r) return m;
  const int bl = (l + (1 << a.lb) - 1) >> a.lb;  // the first whole run
  const int br = r >> a.lb;                      // past the last one
  if (bl >= br) {
    for (int g = l; g < r; ++g) m = imin(m, a.cover[g]);
    return m;
  }
  for (int g = l; g < (bl << a.lb); ++g) m = imin(m, a.cover[g]);
  for (int g = br << a.lb; g < r; ++g) m = imin(m, a.cover[g]);
  const int lbpt = a.tl - a.lb;
  const int bpt = 1 << lbpt;
  const int lv = lbpt + 1;
  const int t0 = bl >> lbpt, t1 = (br - 1) >> lbpt;
  // Whole runs [lo, hi) of tile t, 0 <= lo < hi <= bpt, from its table.
  auto runs = [&](int t, int lo, int hi) {
    const int j = flog2(hi - lo);
    const int* row = a.intile + ((long)t * lv + j) * bpt;
    return imin(row[lo], row[hi - (1 << j)]);
  };
  const int lo = bl & (bpt - 1), hi = ((br - 1) & (bpt - 1)) + 1;
  if (t0 == t1) return imin(m, runs(t0, lo, hi));
  m = imin(m, runs(t0, lo, bpt));
  m = imin(m, runs(t1, 0, hi));
  if (t0 + 1 < t1) {
    if (top != nullptr) {
      const int j = flog2(t1 - t0 - 1);
      m = imin(m, imin(top[j * nt + t0 + 1], top[j * nt + t1 - (1 << j)]));
    } else {
      for (int t = t0 + 1; t < t1; ++t) m = imin(m, a.tmin[t]);
    }
  }
  return m;
}

// A txn's verdict code (reference fused.py:561-565): INVALID, TOO_OLD,
// CONFLICT or COMMITTED.
__device__ __forceinline__ int gen_code(int valid, int old, int cf) {
  return !valid ? -1 : old ? 1 : cf ? 0 : 2;
}

// general_codes (reference fused.py:550-566) as k_fixpoint's last phase,
// four txns or four writes a thread (the txns' quads, then the writes'),
// every load of a quad before any use: int4 loads of t_valid, too_old and
// the final conflicts and one 32-bit store of four codes; a write quad's
// txns and validity by int4 loads, its twelve gathers, one int4 store.  A
// write's txn is clamped to [0, t_cap) (txn -1 reads txn 0's flags).
// `conf` is the final round's buffer, last written by other blocks'
// atomics before the rounds' last barrier: it is read through L2.
__device__ __forceinline__ void write_gen_codes(const FixArgs& a,
                                                const int* conf, long gtid,
                                                long gstride) {
  const long t_cap = a.t_cap;
  const bool vec = a.vec && (uintptr_t)conf % 16 == 0;
  const long t_quads = (t_cap + 3) / 4;
  const long quads = t_quads + (a.w_cap + 3L) / 4;
  for (long q = gtid; q < quads; q += gstride) {
    if (q < t_quads) {
      const long t0 = 4 * q;
      if (vec && t0 + 4 <= t_cap) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(a.t_valid + t0));
        const int4 o = __ldg(reinterpret_cast<const int4*>(a.too_old + t0));
        const int4 c = __ldcg(reinterpret_cast<const int4*>(conf + t0));
        const uint32_t packed =
            (gen_code(v.x, o.x, c.x) & 0xFF) |
            (gen_code(v.y, o.y, c.y) & 0xFF) << 8 |
            (gen_code(v.z, o.z, c.z) & 0xFF) << 16 |
            (uint32_t)(gen_code(v.w, o.w, c.w) & 0xFF) << 24;
        *reinterpret_cast<uint32_t*>(a.codes + t0) = packed;
      } else {
        for (long t = t0; t < t0 + 4 && t < t_cap; ++t)
          a.codes[t] = (int8_t)gen_code(__ldg(a.t_valid + t),
                                        __ldg(a.too_old + t),
                                        __ldcg(conf + t));
      }
      continue;
    }
    const long w0 = 4 * (q - t_quads);
    const bool full = vec && w0 + 4 <= a.w_cap;
    int tc[4], wv[4], tv[4], old[4], cf[4];
    if (full) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(a.w_txn + w0));
      const int4 y = __ldg(reinterpret_cast<const int4*>(a.w_valid + w0));
      tc[0] = x.x; tc[1] = x.y; tc[2] = x.z; tc[3] = x.w;
      wv[0] = y.x; wv[1] = y.y; wv[2] = y.z; wv[3] = y.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = w0 + k < a.w_cap;
        tc[k] = in ? __ldg(a.w_txn + w0 + k) : 0;
        wv[k] = in ? __ldg(a.w_valid + w0 + k) : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      tc[k] = clampi(tc[k], 0, a.t_cap - 1);
      tv[k] = __ldg(a.t_valid + tc[k]);
      old[k] = __ldg(a.too_old + tc[k]);
      cf[k] = __ldcg(conf + tc[k]);
    }
    int ins[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ins[k] = wv[k] && tv[k] && !old[k] && !cf[k] ? 1 : 0;
    if (full) {
      *reinterpret_cast<int4*>(a.w_ins + w0) =
          make_int4(ins[0], ins[1], ins[2], ins[3]);
    } else {
      for (int k = 0; k < 4 && w0 + k < a.w_cap; ++k) a.w_ins[w0 + k] = ins[k];
    }
  }
}

__global__ void __launch_bounds__(FIXG_THREADS, FIXG_MIN_BLOCKS)
    k_fixpoint(FixArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int smem[];
  __shared__ int s_anc;
  __shared__ int s_hits[2];
  const long gtid = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long u = 1L << a.log_u;
  const int ts = 1 << a.tl;          // leaves a tile
  const int lnt = a.log_u - a.tl;    // log2 tiles
  const int nt = 1 << lnt;
  const int lbpt = a.tl - a.lb;
  const int bpt = 1 << lbpt;         // runs a tile
  const int lv = lbpt + 1;           // in-tile table levels
  const bool top_shared = nt > 1 && nt <= FIX_TOP_MAX;

  for (long i = gtid; i < 2 * u; i += gstride) a.tree[i] = INF_I32;
  for (long t = gtid; t < a.t_cap; t += gstride) a.cbuf[t] = a.hist[t];
  if (gtid < 4) a.counts[gtid] = 0;
  grid.sync();
  int rounds = 0;
  long held = 0;  // txns beyond the baseline the previous round held
  while (rounds <= a.t_cap) {
    ++rounds;
    const int cur = rounds & 1;
    const int* conf = a.cbuf + (long)(cur ^ 1) * a.t_cap;
    int* nconf = a.cbuf + (long)cur * a.t_cap;
    // --- update: writes of txns not conflicted; the round's conflicts
    // restart from the history-only baseline (a conflict inferred from a
    // writer that later turns out conflicted must be retractable).  The
    // buffer was last read by the previous round's queries, behind a
    // barrier.
    for (long t = gtid; t < a.t_cap; t += gstride) nconf[t] = a.hist[t];
    for (long w = gtid; w < a.w_cap; w += gstride) {
      const int wt = a.w_txn[w];
      const int l = a.w_pb[w], r = a.w_pe[w];
      if (!a.w_ok[w] || conf[clampi(wt, 0, a.t_cap - 1)] || !(l < r))
        continue;
      long li = clampi(l, 0, (int)u) + u;
      long ri = clampi(r, 0, (int)u) + u;
      for (int lvl = 0; lvl <= a.log_u && li < ri; ++lvl) {
        if (li & 1) atomicMin(&a.tree[li], wt);
        if (ri & 1) atomicMin(&a.tree[ri - 1], wt);
        li = (li + (li & 1)) >> 1;
        ri = (ri - (ri & 1)) >> 1;
      }
    }
    grid.sync();
    // --- pushdown, a tile a block.  The next round's counts are reset
    // here: their last reader passed the barrier above.
    if (gtid < 2) a.counts[(cur ^ 1) * 2 + gtid] = 0;
    int* heap = smem;               // local heap: heap[1] is the tile root
    int* tbl = smem + 2 * ts;       // the in-tile table, [lv][bpt]
    for (int t = blockIdx.x; t < nt; t += gridDim.x) {
      const long root = (long)nt + t;
      if (tid < 32) {  // the min over the root's lnt ancestors
        int m = INF_I32;
        for (int k = lane; k < lnt; k += 32)
          m = imin(m, a.tree[root >> (k + 1)]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = imin(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) s_anc = m;
      }
      for (int q = tid + 1; q < 2 * ts; q += blockDim.x) {
        const int k = flog2(q);
        const long node = (root << k) + (q - (1 << k));
        const int v = a.tree[node];
        heap[q] = v;
        if (v != INF_I32) a.tree[node] = INF_I32;
      }
      __syncthreads();
      if (tid == 0) heap[1] = imin(heap[1], s_anc);
      __syncthreads();
      for (int k = 1; k <= a.tl; ++k) {
        for (int i = tid; i < (1 << k); i += blockDim.x) {
          const int q = (1 << k) + i;
          heap[q] = imin(heap[q], heap[q >> 1]);
        }
        __syncthreads();
      }
      const int* leaf = heap + ts;
      int* cover = a.cover + (long)t * ts;
      for (int i = tid; i < ts; i += blockDim.x) cover[i] = leaf[i];
      for (int i = tid; i < bpt; i += blockDim.x) {
        // A run's minimum; the rotation keeps a warp's lanes on distinct
        // banks.
        const int* run = leaf + (i << a.lb);
        const int n = 1 << a.lb;
        int m = INF_I32;
        for (int k = 0; k < n; ++k) m = imin(m, run[(k + i) & (n - 1)]);
        tbl[i] = m;
      }
      __syncthreads();
      for (int j = 1; j < lv; ++j) {
        const int h = 1 << (j - 1);
        for (int i = tid; i < bpt; i += blockDim.x) {
          const int x = tbl[(j - 1) * bpt + i];
          const int y = i + h < bpt ? tbl[(j - 1) * bpt + i + h] : INF_I32;
          tbl[j * bpt + i] = imin(x, y);
        }
        __syncthreads();
      }
      int* out = a.intile + (long)t * lv * bpt;
      for (int i = tid; i < lv * bpt; i += blockDim.x) out[i] = tbl[i];
      if (tid == 0) a.tmin[t] = tbl[(lv - 1) * bpt];
      __syncthreads();  // the next tile reuses the shared memory
    }
    grid.sync();
    // --- queries.  The ancestors above the tiles (nodes [1, nt)) were
    // read in the pushdown; reset them for the next round here.
    for (long i = gtid + 1; i < nt; i += gstride)
      if (a.tree[i] != INF_I32) a.tree[i] = INF_I32;
    const int* top = nullptr;
    if (top_shared) {
      int* tt = smem;
      for (int i = tid; i < nt; i += blockDim.x) tt[i] = a.tmin[i];
      __syncthreads();
      for (int j = 1; j <= lnt; ++j) {
        const int h = 1 << (j - 1);
        for (int i = tid; i < nt; i += blockDim.x) {
          const int x = tt[(j - 1) * nt + i];
          const int y = i + h < nt ? tt[(j - 1) * nt + i + h] : INF_I32;
          tt[j * nt + i] = imin(x, y);
        }
        __syncthreads();
      }
      top = tt;
    }
    if (tid < 2) s_hits[tid] = 0;
    __syncthreads();
    for (long r = gtid; r < a.r_cap; r += gstride) {
      if (!a.r_live[r]) continue;
      const int rt = a.r_txn[r];
      const int l = clampi(a.r_pb[r], 0, (int)u);
      const int e = clampi(a.r_pe[r], 0, (int)u);
      if (cover_min(a, top, nt, l, e) < rt) {
        const long d = scatter_index(rt, a.t_cap);
        if (d >= 0 && atomicMax(&nconf[d], 1) < 1)
          atomicAdd(&s_hits[conf[d] == 1 ? 1 : 0], 1);
      }
    }
    __syncthreads();
    if (tid < 2 && s_hits[tid] != 0)
      atomicAdd(&a.counts[cur * 2 + tid], s_hits[tid]);
    grid.sync();
    // This round changed iff it holds a txn the previous round did not, or
    // fewer of the previous round's (a txn beyond the baseline is held iff
    // some read hit it, so counting first hits covers every change).
    const long fresh = *(volatile int*)&a.counts[cur * 2];
    const long kept = *(volatile int*)&a.counts[cur * 2 + 1];
    const bool changed = fresh != 0 || kept != held;
    held = fresh + kept;
    if (!changed) break;
  }
  // Every thread left the rounds after the same barrier, so the final
  // round's buffer is complete and visible here.
  const int* final_conf = a.cbuf + (long)(rounds & 1) * a.t_cap;
  for (long t = gtid; t < a.t_cap; t += gstride)
    a.conf[t] = __ldcg(final_conf + t);
  if (gtid == 0) {
    a.rounds[0] = rounds;
    if (a.rounds_acc != nullptr) a.rounds_acc[0] += rounds;
  }
  if (a.codes != nullptr) write_gen_codes(a, final_conf, gtid, gstride);
}

// scratch: int32[scratch_len] holding FixLayout's sections; a shorter one
// is refused (cudaErrorInvalidValue) before anything is launched, as are
// codes without t_valid, too_old, w_valid and w_ins.  codes null: the
// fixpoint alone.
extern "C" int sg_fixpoint(int t_cap, int r_cap, int w_cap, int log_u,
                           const void* hist, const void* r_txn,
                           const void* r_live, const void* r_pb,
                           const void* r_pe, const void* w_txn,
                           const void* w_ok, const void* w_pb,
                           const void* w_pe, void* scratch, long scratch_len,
                           void* conf, void* rounds, void* rounds_acc,
                           const void* t_valid, const void* too_old,
                           const void* w_valid, void* codes, void* w_ins,
                           void* stream) {
  FixArgs a;
  a.t_cap = t_cap;
  a.r_cap = r_cap;
  a.w_cap = w_cap;
  a.log_u = log_u;
  a.tl = log_u < FIX_TILE_LOG ? log_u : FIX_TILE_LOG;
  a.lb = a.tl < FIX_BLOCK_LOG ? a.tl : FIX_BLOCK_LOG;
  const FixLayout lay = fix_layout(t_cap, log_u, a.tl, a.lb);
  if (t_cap < 1 || log_u < 1 || log_u > 30 || scratch_len < lay.total ||
      (codes != nullptr && (t_valid == nullptr || too_old == nullptr ||
                            w_valid == nullptr || w_ins == nullptr)))
    return (int)cudaErrorInvalidValue;
  int* s = (int*)scratch;
  a.hist = (const int*)hist;
  a.r_txn = (const int*)r_txn;
  a.r_live = (const int*)r_live;
  a.r_pb = (const int*)r_pb;
  a.r_pe = (const int*)r_pe;
  a.w_txn = (const int*)w_txn;
  a.w_ok = (const int*)w_ok;
  a.w_pb = (const int*)w_pb;
  a.w_pe = (const int*)w_pe;
  a.tree = s + lay.tree;
  a.cover = s + lay.cover;
  a.intile = s + lay.intile;
  a.tmin = s + lay.tmin;
  a.cbuf = s + lay.cbuf;
  a.counts = s + lay.counts;
  a.conf = (int*)conf;
  a.rounds = (int*)rounds;
  a.rounds_acc = (int*)rounds_acc;
  a.t_valid = (const int*)t_valid;
  a.too_old = (const int*)too_old;
  a.w_valid = (const int*)w_valid;
  a.codes = (int8_t*)codes;
  a.w_ins = (int*)w_ins;
  a.vec = (uintptr_t)t_valid % 16 == 0 && (uintptr_t)too_old % 16 == 0 &&
          (uintptr_t)w_txn % 16 == 0 && (uintptr_t)w_valid % 16 == 0 &&
          (uintptr_t)w_ins % 16 == 0 && (uintptr_t)codes % 4 == 0;
  const int ts = 1 << a.tl;
  const int lnt = log_u - a.tl;
  const int nt = 1 << lnt;
  const int lv = a.tl - a.lb + 1;
  size_t smem = (size_t)(2 * ts + lv * (ts >> a.lb)) * sizeof(int);
  if (nt > 1 && nt <= FIX_TOP_MAX) {
    const size_t top = (size_t)(lnt + 1) * nt * sizeof(int);
    if (top > smem) smem = top;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Set before the occupancy query, or a launch above 48 KB is refused.
  err = cudaFuncSetAttribute(k_fixpoint,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_fixpoint,
                                                      FIXG_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  long work = 2L << log_u;
  if (r_cap > work) work = r_cap;
  if (w_cap > work) work = w_cap;
  if (t_cap > work) work = t_cap;
  long want = (work + FIXG_THREADS - 1) / FIXG_THREADS;
  long most = (long)sms * (per_sm > 0 ? per_sm : 1);
  int grid = (int)(want < most ? want : most);
  if (grid < 1) grid = 1;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)k_fixpoint, dim3(grid),
                                    dim3(FIXG_THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
