// window: the window programs' own kernels.
//
// Replaces (foundationdb_tpu, conflict/window.py):
//   wq_query     -- :66-82 window_query: searchsorted_right(begin) - 1,
//                   searchsorted_left(end), the range max over the sparse
//                   table, `valid & max > snap`, fused per query;
//   wu_endpoints -- :95-104 _union_ranges' sweep input: begins then ends
//                   (MAX where invalid), the begins-first tie, +1 / -1, and
//                   the MAX rows of its outputs (:115);
//   wu_sweep     -- :107-123 the coverage cumsum, the merged starts and
//                   ends, their ranks and the compactions, one single-pass
//                   launch after the sort (sort.cu's sort_rows);
//   wg_gc        -- :219-240 window_gc: removeBefore's keep mask, the
//                   compaction of the kept rows, the rebase and the new
//                   size, in place, one cooperative launch.
// window_insert's insert proper (:139-213) is insert.cu's ri_insert, which
// it shares with the point insert.
//
// Bound on the card: bytes.  Every kernel here reads its inputs once and
// writes its outputs once; wq_query adds the table rows its binary
// searches touch and two range-max gathers per query; wg_gc reads the
// live versions, moves the kept rows from the first dropped one on and
// refills the rows it frees (k_gc).
//
// Design: the elementwise kernels take one thread per element in
// grid-stride loops; digests move as 32-byte rows (common.cuh).  The
// union's sweep is one single-pass launch whose two look-back chains carry
// the coverage and the starts' and ends' ranks (k_sweep).  wq_query is
// bound by the load instructions of its scattered rows, not by their
// bytes: its searches walk a staged top in shared memory, read half rows,
// share each load where begin and end meet the same midpoint, and only
// valid queries search (probe_max, for_live).  wg_gc works in place over
// the live rows only, chunk by chunk behind grid barriers (k_gc).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// A range probe a valid query (probe_max over the one tier); invalid
// queries answer 0 without a search, the valid ones queued per warp
// (for_live).
__global__ void __launch_bounds__(PROBE_THREADS)
    k_query(const uint32_t* __restrict__ bk, int cap,
            const int* __restrict__ table, const uint32_t* __restrict__ qb,
            const uint32_t* __restrict__ qe, const int* __restrict__ snap,
            const int* __restrict__ valid, long nq, int* __restrict__ out) {
  __shared__ uint4 top[PROBE_NODES];
  __shared__ int queue[PROBE_QUEUE];
  ProbeTier tier;
  stage_tier(tier, bk, table, cap, top);
  __syncthreads();
  for_live<1>(
      nq, queue, [&](long i) { return valid[i] != 0; },
      [&](int i, int, bool active) {
        const int m = probe_max<1>(&tier, load_key(qb, i), load_key(qe, i));
        if (active) out[i] = m > snap[i] ? 1 : 0;
      },
      [&](long i) { out[i] = 0; });
}

// _union_ranges' first launch: the 2w endpoint rows (begins, then ends;
// MAX where invalid), their tie and delta; mb and me as w MAX rows each;
// the sweep's ticket and descriptors zeroed (so the sweep, two launches
// later on the stream, needs no fill of its own).
__global__ void k_endpoints(long w, const uint32_t* __restrict__ wb,
                            const uint32_t* __restrict__ we,
                            const int* __restrict__ wvalid,
                            uint32_t* __restrict__ digests,
                            int* __restrict__ tie, int* __restrict__ delta,
                            uint32_t* __restrict__ mb,
                            uint32_t* __restrict__ me,
                            unsigned long long* __restrict__ scratch,
                            long scratch_len) {
  GRID_STRIDE(i, w) {
    bool v = wvalid[i] != 0;
    store_row(digests, i, v ? load_row(wb, i) : max_row());
    store_row(digests, w + i, v ? load_row(we, i) : max_row());
    tie[i] = 0;
    tie[w + i] = 1;
    delta[i] = v ? 1 : 0;
    delta[w + i] = v ? -1 : 0;
    store_row(mb, i, max_row());
    store_row(me, i, max_row());
  }
  GRID_STRIDE(j, scratch_len) scratch[j] = 0ull;
}

// _union_ranges' sweep over the sorted endpoints (s_rows, s_delta), one
// single-pass launch: tiles of SW_TILE elements (SW_VT consecutive ones a
// thread) taken by an atomicAdd ticket, with two look-back chains
// (common.cuh look_back):
//   1. coverage: a tile publishes the sum of its deltas at once and looks
//      back for its exclusive prefix c0, which gives each element's
//      coverage cov (the reference's cumsum) and its marks, exactly the
//      reference's: a start where d > 0 and cov == 1, an end where d < 0
//      and cov == 0;
//   2. starts and ends: the tile's two counts, packed as a pair, published
//      once chain 1 resolves, looked back on a second descriptor array for
//      the exclusive (S0, E0).  The end count is counted, never derived
//      from the starts (ends = starts - (cov > 0) fails once coverage goes
//      below 0, as a valid range with begin > end makes it).
// Then m_incl[i] = S0 + the tile's inclusive starts up to i, each start's
// row to mb[S0 + its rank in the tile] and each end's to me[E0 + rank],
// stores past w dropped (the reference's mode="drop").
// scratch: uint64[1 + 2 * tiles], zeroed by k_endpoints: the ticket, the
// coverage descriptors, the pair descriptors.
// Timed on the H100 at 256 threads x 4, 8 and 16 elements, 128 x 4 and 8,
// and 64 x 4: 256 x 4 was the fastest at config 3's 2w = 131,072.
#define SW_THREADS 256
#define SW_VT 4  // elements a thread: one int4 of deltas
#define SW_WARPS (SW_THREADS / 32)
#define SW_TILE (SW_THREADS * SW_VT)  // 1024: conflict/window.py's UNION_TILE

// Exclusive block scan of one value a thread; *total gets the block's sum.
// Ends with a barrier, so `warp_sums` may be reused at once.
template <class T>
__device__ __forceinline__ T block_exclusive(T v, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T incl = warp_inclusive_scan<T>(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  T off = incl - v, sum = 0;
#pragma unroll
  for (int k = 0; k < SW_WARPS; ++k) {
    if (k < warp) off += warp_sums[k];
    sum += warp_sums[k];
  }
  *total = sum;
  __syncthreads();
  return off;
}

// s_delta and m_incl are 16-byte aligned (wu_sweep checks), so a thread's
// SW_VT (4) values move as one int4 (a thread's base is a multiple of 4).
__global__ void __launch_bounds__(SW_THREADS)
    k_sweep(long n2, const uint32_t* __restrict__ s_rows,
            const int* __restrict__ s_delta,
            unsigned long long* __restrict__ scratch, long tiles,
            uint32_t* __restrict__ mb, uint32_t* __restrict__ me, long w,
            int* __restrict__ m_incl) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_warp[SW_WARPS];
  __shared__ unsigned long long s_warp2[SW_WARPS];
  __shared__ unsigned s_prefix;
  __shared__ unsigned long long s_prefix2;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const long tile = s_tile;
  unsigned long long* cov_desc = scratch + 1;
  unsigned long long* pair_desc = scratch + 1 + tiles;
  const long base = tile * SW_TILE + (long)threadIdx.x * SW_VT;
  const bool full = base + SW_VT <= n2;
  int d[SW_VT];
  if (full) {
    const int4 x = *reinterpret_cast<const int4*>(s_delta + base);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < SW_VT; ++k)
      d[k] = base + k < n2 ? s_delta[base + k] : 0;
  }
  // Chain 1: coverage (sums wrap in int32, as the reference's cumsum).
  unsigned run = 0u;
#pragma unroll
  for (int k = 0; k < SW_VT; ++k) run += (unsigned)d[k];
  unsigned agg;
  unsigned cov = block_exclusive<unsigned>(run, s_warp, &agg);
  if (tile == 0) {
    if (threadIdx.x == 0) store_relaxed(cov_desc, (SCAN_PREFIX << 32) | agg);
  } else {
    if (threadIdx.x == 0)
      store_relaxed(cov_desc + tile, (SCAN_AGGREGATE << 32) | agg);
    cov += look_back<unsigned, 32>(cov_desc, tile, agg, &s_prefix);
  }
  unsigned start = 0u, end = 0u;  // bit k: element k is a start / an end
#pragma unroll
  for (int k = 0; k < SW_VT; ++k) {
    cov += (unsigned)d[k];
    if (d[k] > 0 && (int)cov == 1) start |= 1u << k;
    if (d[k] < 0 && (int)cov == 0) end |= 1u << k;
  }
  // Chain 2: the starts and ends before this thread's elements.
  const unsigned long long mine =
      ((unsigned long long)__popc(start) << PAIR_SHIFT) | __popc(end);
  unsigned long long agg2;
  unsigned long long pre =
      block_exclusive<unsigned long long>(mine, s_warp2, &agg2);
  if (tile == 0) {
    if (threadIdx.x == 0)
      store_relaxed(pair_desc, (SCAN_PREFIX << 62) | agg2);
  } else {
    if (threadIdx.x == 0)
      store_relaxed(pair_desc + tile, (SCAN_AGGREGATE << 62) | agg2);
    pre += look_back<unsigned long long, 62>(pair_desc, tile, agg2,
                                             &s_prefix2);
  }
  long s_at = (long)(pre >> PAIR_SHIFT);              // starts before
  long e_at = (long)(pre & ((1ull << PAIR_SHIFT) - 1));  // ends before
  int incl[SW_VT];
#pragma unroll
  for (int k = 0; k < SW_VT; ++k) {
    if ((start | end) >> k & 1u) {
      const long at = start >> k & 1u ? s_at++ : e_at++;
      const long dst = scatter_index(at, w);
      if (dst >= 0) store_row(start >> k & 1u ? mb : me, dst,
                              load_row(s_rows, base + k));
    }
    incl[k] = (int)s_at;
  }
  if (full) {
    *reinterpret_cast<int4*>(m_incl + base) =
        make_int4(incl[0], incl[1], incl[2], incl[3]);
  } else {
#pragma unroll
    for (int k = 0; k < SW_VT; ++k)
      if (base + k < n2) m_incl[base + k] = incl[k];
  }
}

// ------------------------------------------------------------- window_gc
// removeBefore and the rebase, IN PLACE on bk / bv / size, one cooperative
// launch (coop_grid: at most GC_BLOCKS_PER_SM blocks an SM, as many as the
// card holds at once), sized by size[0] read on the device.  The live rows
// [0, sz) fall into tiles of GC_TILE elements (element k * GC_THREADS +
// tid of a tile is thread tid's k-th, so a warp's 32 are consecutive);
// block b owns tiles b, b + G, b + 2G, ... (G the grid), and chunk c is
// tiles [c * G, (c + 1) * G).
//   1. keep: every keep bit from the original bv (keep[i] = i < sz and
//      (i == 0 or bv[i] >= oldest or bv[i - 1] >= oldest)), a warp's 32 as
//      one mask word, and each tile's kept count (scratch).  grid.sync.
//   2. Each block scans the tile counts itself (a few thousand int32
//      through L2) for its own tiles' exclusive prefixes, the kept total
//      and the first tile that drops a row; a kept element's destination
//      is its tile's prefix plus its rank in the tile (the mask words).
//   3. Move in index order, chunk by chunk: a chunk loads its kept rows
//      that move (those past the first dropped row) and its versions,
//      then, if any of its rows moves, grid.sync, then stores them.  A
//      destination is at most its source, so chunk c writes only below
//      the end of chunk c, into rows loaded before this chunk's barrier
//      (its own) or an earlier one: one barrier a chunk that moves rows.
//      A kept row before the first dropped one keeps its place, and only
//      its version is rewritten, where the rebase changes it (no row is
//      read, and no barrier taken, for a chunk of such rows).
//   4. Rows [total, sz) become MAX rows at NEG_INF (every load is behind
//      the last barrier by now: a row is freed only past a drop, and the
//      chunks with drops come last); thread 0 writes size[0] = total
//      (every block read it before the first barrier).
// Rows past sz are left as they are: the window's invariant (insert.cu)
// holds them MAX at NEG_INF already, which is what the reference writes
// over all of [total, cap).  Versions are rebased as rs_compact does:
// (v - rebase) wrapping as uint32, then the signed clamp at NEG_INF + 1.
// Scratch (int32, uninitialised; the kernel writes all it reads): the
// tile counts, then the mask words, for ceil(cap / GC_TILE) tiles.
#define GC_THREADS SW_THREADS  // block_exclusive's warps
#define GC_VT 8                // elements a thread a tile
#define GC_TILE (GC_THREADS * GC_VT)  // 2,048: conflict/window.py GC_TILE
#define GC_WORDS (GC_TILE / 32)       // mask words a tile
#define GC_BLOCKS_PER_SM 2            // 8 rows a thread in registers
#define GC_MAX_CHUNKS 64
static_assert(GC_WORDS == 64, "k_gc scans a tile's words two a lane");

struct GcArgs {
  int cap, oldest, rebase;
  uint32_t* bk;      // [cap, 8]
  int* bv;           // [cap]
  int* size;         // [1]
  int* counts;       // [ceil(cap / GC_TILE)]
  unsigned* mask;    // [ceil(cap / GC_TILE) * GC_WORDS]
};

// A row through L2 (ld.global.cg): rows this kernel may have written
// elsewhere on the card are never read through L1.
__device__ __forceinline__ Row load_row_cg(const uint32_t* rows, long i) {
  const uint4* p = reinterpret_cast<const uint4*>(rows + i * 8);
  const uint4 x = __ldcg(p), y = __ldcg(p + 1);
  Row r;
  r.l[0] = x.x; r.l[1] = x.y; r.l[2] = x.z; r.l[3] = x.w;
  r.l[4] = y.x; r.l[5] = y.y; r.l[6] = y.z; r.l[7] = y.w;
  return r;
}

__device__ __forceinline__ int gc_rebase(int v, int rebase) {
  const int w = (int)((uint32_t)v - (uint32_t)rebase);
  return w > NEG_INF_I32 + 1 ? w : NEG_INF_I32 + 1;
}

__global__ void __launch_bounds__(GC_THREADS, GC_BLOCKS_PER_SM)
    k_gc(GcArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned s_word[GC_WORDS];
  __shared__ int s_wpre[GC_WORDS];
  __shared__ int s_tile_pre[GC_MAX_CHUNKS];
  __shared__ int s_warp[SW_WARPS];
  __shared__ int s_first_drop;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long G = gridDim.x, b = blockIdx.x;
  int sz = a.size[0];
  sz = sz < 0 ? 0 : (sz > a.cap ? a.cap : sz);
  const long tiles = (sz + GC_TILE - 1) / GC_TILE;
  const long chunks = (tiles + G - 1) / G;

  // 1. The keep bits and each tile's count.
  for (long t = b; t < tiles; t += G) {
    const long base = t * GC_TILE;
    int n = 0;
#pragma unroll
    for (int k = 0; k < GC_VT; ++k) {
      const long i = base + k * GC_THREADS + tid;
      const bool in = i < sz;
      const int v = in ? a.bv[i] : 0;
      int prev = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0 && in && i > 0) prev = a.bv[i - 1];
      const bool keep =
          in && (i == 0 || v >= a.oldest || prev >= a.oldest);
      const unsigned word = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) a.mask[t * GC_WORDS + k * SW_WARPS + warp] = word;
      n += __popc(word);
    }
    if (lane == 0) s_warp[warp] = n;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < SW_WARPS; ++w) total += s_warp[w];
      a.counts[t] = total;
    }
    __syncthreads();
  }
  grid.sync();

  // 2. Each own tile's exclusive prefix, the kept total, and the first
  // tile holding a dropped row (tiles if none).
  if (tid == 0) s_first_drop = (int)tiles;
  __syncthreads();
  int carry = 0;
  for (long j0 = 0; j0 < tiles; j0 += GC_THREADS) {
    const long j = j0 + tid;
    const int x = j < tiles ? __ldcg(a.counts + j) : 0;
    const long live = sz - j * GC_TILE < GC_TILE ? sz - j * GC_TILE
                                                 : GC_TILE;
    if (j < tiles && x < live) atomicMin(&s_first_drop, (int)j);
    int sum;
    const int ex = block_exclusive<int>(x, s_warp, &sum);
    if (j < tiles && j % G == b) s_tile_pre[j / G] = carry + ex;
    carry += sum;
  }
  const int total = carry;
  __syncthreads();
  const long first_drop = s_first_drop;

  // 3. The moves, chunk by chunk.
  for (long c = 0; c < chunks; ++c) {
    const long t = c * G + b;
    const long base = t * GC_TILE;
    const long last = (c + 1) * G < tiles ? (c + 1) * G - 1 : tiles - 1;
    const bool moves = last >= first_drop;  // the same in every block
    Row row[GC_VT];
    int val[GC_VT];
    long dst[GC_VT];
    unsigned kbits = 0;
    if (t < tiles) {
      if (tid < 32) {  // the words' exclusive prefix, two words a lane
        const unsigned w0 = __ldcg(a.mask + t * GC_WORDS + 2 * lane);
        const unsigned w1 = __ldcg(a.mask + t * GC_WORDS + 2 * lane + 1);
        const int n0 = __popc(w0), n1 = __popc(w1);
        const int incl = warp_inclusive_scan<int>(n0 + n1, lane);
        s_word[2 * lane] = w0;
        s_word[2 * lane + 1] = w1;
        s_wpre[2 * lane] = incl - n0 - n1;
        s_wpre[2 * lane + 1] = incl - n1;
      }
      __syncthreads();
      const int pre = s_tile_pre[c];
#pragma unroll
      for (int k = 0; k < GC_VT; ++k) {
        const long i = base + k * GC_THREADS + tid;
        const unsigned w = s_word[k * SW_WARPS + warp];
        dst[k] = pre + s_wpre[k * SW_WARPS + warp] + __popc(w & lt);
        if (w >> lane & 1u) {
          kbits |= 1u << k;
          val[k] = __ldcg(a.bv + i);
          if (dst[k] != i) row[k] = load_row_cg(a.bk, i);
        }
      }
      __syncthreads();  // s_word / s_wpre are the next tile's
    }
    if (moves) grid.sync();
    if (t < tiles) {
#pragma unroll
      for (int k = 0; k < GC_VT; ++k) {
        if (!(kbits >> k & 1u)) continue;
        const long i = base + k * GC_THREADS + tid;
        const int nv = gc_rebase(val[k], a.rebase);
        if (dst[k] != i) {
          store_row(a.bk, dst[k], row[k]);
          a.bv[dst[k]] = nv;
        } else if (nv != val[k]) {
          a.bv[i] = nv;
        }
      }
    }
  }

  // 4. The freed rows and the size.
  const long gtid = b * GC_THREADS + tid;
  for (long i = total + gtid; i < sz; i += G * GC_THREADS) {
    store_row(a.bk, i, max_row());
    a.bv[i] = NEG_INF_I32;
  }
  if (gtid == 0) a.size[0] = total;
}

#define S(stream) (cudaStream_t)(stream)
#define RET return (int)cudaGetLastError()

// A persistent grid (probe_grid).
extern "C" int wq_query(const void* bk, int cap, const void* table,
                        const void* qb, const void* qe, const void* snap,
                        const void* valid, long nq, void* out, void* stream) {
  int grid = 0;
  int err = probe_grid((const void*)k_query, nq, &grid);
  if (err != 0) return err;
  k_query<<<grid, PROBE_THREADS, 0, S(stream)>>>(
      (const uint32_t*)bk, cap, (const int*)table, (const uint32_t*)qb,
      (const uint32_t*)qe, (const int*)snap, (const int*)valid, nq,
      (int*)out);
  RET;
}

// The sweep's tiles for n2 endpoints (at least one), which sizes its
// scratch: 1 + 2 * tiles.
static long sweep_tiles(long n2) {
  return n2 > 0 ? (n2 + SW_TILE - 1) / SW_TILE : 1;
}

extern "C" int wu_endpoints(long w, const void* wb, const void* we,
                            const void* wvalid, void* digests, void* tie,
                            void* delta, void* mb, void* me, void* scratch,
                            long scratch_len, void* stream) {
  if (scratch_len < 1 + 2 * sweep_tiles(2 * w))
    return (int)cudaErrorInvalidValue;
  k_endpoints<<<blocks_for(w, THREADS), THREADS, 0, S(stream)>>>(
      w, (const uint32_t*)wb, (const uint32_t*)we, (const int*)wvalid,
      (uint32_t*)digests, (int*)tie, (int*)delta, (uint32_t*)mb,
      (uint32_t*)me, (unsigned long long*)scratch, scratch_len);
  RET;
}

// scratch: as zeroed by wu_endpoints for the same n2 = 2w.  s_delta and
// m_incl must be 16-byte aligned, as _union_ranges' fresh allocations are.
extern "C" int wu_sweep(long n2, const void* s_rows, const void* s_delta,
                        void* scratch, long scratch_len, void* mb, void* me,
                        long w, void* m_incl, void* stream) {
  const long tiles = sweep_tiles(n2);
  if (scratch_len < 1 + 2 * tiles || tiles > 0x7fffffffL ||
      (uintptr_t)s_delta % 16 != 0 || (uintptr_t)m_incl % 16 != 0)
    return (int)cudaErrorInvalidValue;
  k_sweep<<<(unsigned)tiles, SW_THREADS, 0, S(stream)>>>(
      n2, (const uint32_t*)s_rows, (const int*)s_delta,
      (unsigned long long*)scratch, tiles, (uint32_t*)mb, (uint32_t*)me, w,
      (int*)m_incl);
  RET;
}

// scratch: int32[scratch_len] of ceil(cap / GC_TILE) * (1 + GC_WORDS)
// (the tile counts, then the mask words), uninitialised; a shorter one, or
// a capacity past GC_MAX_CHUNKS chunks of the grid, is refused
// (cudaErrorInvalidValue) before anything is launched.
extern "C" int wg_gc(void* bk, void* bv, void* size, int cap, int oldest,
                     int rebase, void* scratch, long scratch_len,
                     void* stream) {
  const long tiles_cap = ((long)cap + GC_TILE - 1) / GC_TILE;
  if (cap < 1 || scratch_len < tiles_cap * (1 + GC_WORDS))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = (cudaError_t)coop_grid(
      (const void*)k_gc, GC_THREADS, GC_BLOCKS_PER_SM, tiles_cap, &grid);
  if (err != cudaSuccess) return (int)err;
  if ((tiles_cap + grid - 1) / grid > GC_MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  GcArgs a{cap, oldest, rebase, (uint32_t*)bk, (int*)bv, (int*)size,
           (int*)scratch, (unsigned*)((int*)scratch + tiles_cap)};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)k_gc, dim3(grid),
                                    dim3(GC_THREADS), args, 0, S(stream));
  if (err != cudaSuccess) return (int)err;
  RET;
}
