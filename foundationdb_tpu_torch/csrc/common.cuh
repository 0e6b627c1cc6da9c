// Shared device helpers for the conflict-path kernels.
//
// Digests are 8 big-endian uint32 lanes (ops/digest.py).  On the card they
// live as ROWS: uint32[N, 8], one 32-byte row per key = one DRAM sector, so
// a probe or a row scatter moves exactly one sector.  The PyTorch side
// stores the same bits as int32 and the kernels reinterpret them as
// uint32_t, which is how the lexicographic order over unsigned lanes is
// kept without biasing.
//
// Index semantics follow the JAX reference bit for bit:
//   * gathers normalise a negative index by adding the length, then clamp
//     to [0, n-1]                                   (gather_index below);
//   * scatters written with mode="drop" normalise a negative index the
//     same way and drop anything still outside [0, n) (scatter_index).
#pragma once

#include <climits>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#define NEG_INF_I32 (-2147483647)  // ops/rangemax.py NEG_INF = -(1<<31)+1
#define INF_I32 2147483647         // ops/segtree.py INF_I32

struct Row {
  uint32_t l[8];
};

__device__ __forceinline__ Row load_row(const uint32_t* rows, long i) {
  const uint4* p = reinterpret_cast<const uint4*>(rows + i * 8);
  uint4 a = p[0];
  uint4 b = p[1];
  Row r;
  r.l[0] = a.x; r.l[1] = a.y; r.l[2] = a.z; r.l[3] = a.w;
  r.l[4] = b.x; r.l[5] = b.y; r.l[6] = b.z; r.l[7] = b.w;
  return r;
}

__device__ __forceinline__ void store_row(uint32_t* rows, long i,
                                          const Row& r) {
  uint4* p = reinterpret_cast<uint4*>(rows + i * 8);
  p[0] = make_uint4(r.l[0], r.l[1], r.l[2], r.l[3]);
  p[1] = make_uint4(r.l[4], r.l[5], r.l[6], r.l[7]);
}

__device__ __forceinline__ Row max_row() {
  Row r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.l[i] = 0xFFFFFFFFu;
  return r;
}

// Lexicographic three-way compare; lane 0 is the most significant.
__device__ __forceinline__ int row_cmp(const Row& a, const Row& b) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (a.l[i] != b.l[i]) return a.l[i] < b.l[i] ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ bool row_eq(const Row& a, const Row& b) {
  return row_cmp(a, b) == 0;
}

// Three-way compare of two 16-byte halves of rows (lanes 0-3 or 4-7).
__device__ __forceinline__ int cmp4(uint4 a, uint4 b) {
  if (a.x != b.x) return a.x < b.x ? -1 : 1;
  if (a.y != b.y) return a.y < b.y ? -1 : 1;
  if (a.z != b.z) return a.z < b.z ? -1 : 1;
  if (a.w != b.w) return a.w < b.w ? -1 : 1;
  return 0;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int gather_index(int i, int n) {
  if (i < 0) i += n;
  return clampi(i, 0, n - 1);
}

// Returns -1 when the write is dropped.
__device__ __forceinline__ long scatter_index(long i, long n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// max(values[lo:hi)) from the doubling table int32[LOG+1, cap]
// (ops/rangemax.py range_max); empty ranges give NEG_INF.
__device__ __forceinline__ int range_max(const int* table, int cap, int lo,
                                         int hi) {
  int len = hi - lo;
  int safe = len > 1 ? len : 1;
  int j = 31 - __clz(safe);
  int r = hi - (1 << j);
  r = r > 0 ? r : 0;
  int a = table[(long)j * cap + gather_index(lo, cap)];
  int b = table[(long)j * cap + gather_index(r, cap)];
  return len > 0 ? (a > b ? a : b) : NEG_INF_I32;
}

// ---------------------------------------------------------------------------
// Range probes: the reference's two searches of a range [b, e) (the upper
// bound of b, the lower bound of e: searchsorted_interval, ops/digest.py
// :322) and the range max over [ub(b) - 1, lb(e)), with the searches' top
// levels in shared memory, half-row compares and independent chains
// interleaved.
//
// The staged top.  The midpoints of the reference's branchless search
// (ops/digest.py _searchsorted) over [0, cap) (cap = 2^nbits) form a
// fixed binary tree: node 1 is the midpoint (lo + hi) >> 1 of
// [0, cap), and node t's children 2t and 2t + 1 are the midpoints after
// going left (hi = mid) and right (lo = mid + 1).  Every node of its first
// nbits levels has a non-empty interval, so any search of any table,
// sorted or not, reads exactly those of its first `levels` (<= nbits)
// midpoints that lie on its path through this tree.  A block stages lanes
// 0-3 of the tree's first min(PROBE_LEVELS, nbits) levels (digest_search.cu
// ds_search: SEARCH_LEVELS), breadth first (top_mid;
// tests/test_torch_probe.py search_top mirrors it); a search walks them
// there and goes on from its own (lo, hi) in global memory: the
// reference's midpoints in the reference's order, so the result is the
// reference's on any table.
//
// Half rows.  A row is compared by its lanes 0-3 first; lanes 4-7 are
// read only when those tie (a key's own row, MAX against MAX), so a level
// costs one 16-byte load, not two: the searches of many queries are bound
// by the load instructions of scattered rows, not by their bytes.
//
// The chains.  A range's two searches read the same midpoint while their
// intervals agree (always, for a point range [k, k + \x00): no row lies
// strictly between its ends); one load serves both there.  The searches
// of NT tiers advance in lockstep, every load of a level issued before
// the first compare.

// Staged levels a tier (8: 255 rows, 4,080 bytes; 10 and 12 were slower
// on the H100 at the paths' shapes, PERF.md).
#define PROBE_LEVELS 8
#define PROBE_NODES ((1 << PROBE_LEVELS) - 1)

struct Key {
  uint4 a, b;  // lanes 0-3, lanes 4-7
};

__device__ __forceinline__ Key load_key(const uint32_t* rows, long i) {
  const uint4* p = reinterpret_cast<const uint4*>(rows + i * 8);
  return Key{p[0], p[1]};
}

__device__ __forceinline__ uint4 load_half(const uint32_t* rows, long i,
                                           int half) {
  return reinterpret_cast<const uint4*>(rows + i * 8)[half];
}

// The row index of node t (1-based, breadth first) of the search tree
// over [0, cap): the path to t is the bits of t below its leading one.
__device__ __forceinline__ int top_mid(int cap, int t) {
  int lo = 0, hi = cap;
  for (int bit = 30 - __clz(t); bit >= 0; --bit) {
    const int mid = (lo + hi) >> 1;
    if ((t >> bit) & 1) lo = mid + 1; else hi = mid;
  }
  return (lo + hi) >> 1;
}

// A row table as a probe sees it: its rows and range-max table, and the
// staged top (shared memory: lanes 0-3 of nodes 1 .. 2^levels - 1).
struct ProbeTier {
  const uint32_t* rows;  // [cap, 8]
  const int* table;      // [LOG+1, cap]
  int cap, levels;
  const uint4* top;
};

// Sets up a tier whose top (2^LEVELS - 1 entries) starts at `top` and
// stages min(LEVELS, log2 cap) levels of it (block-wide; __syncthreads()
// before the first search).
template <int LEVELS = PROBE_LEVELS>
__device__ __forceinline__ void stage_tier(ProbeTier& t, const uint32_t* rows,
                                           const int* table, int cap,
                                           uint4* top) {
  const int nbits = cap > 1 ? 31 - __clz(cap) : 0;
  t.rows = rows;
  t.table = table;
  t.cap = cap;
  t.levels = nbits < LEVELS ? nbits : LEVELS;
  t.top = top;
  for (int i = threadIdx.x; i < (1 << t.levels) - 1; i += blockDim.x)
    top[i] = load_half(rows, top_mid(cap, i + 1), 0);
}

// Compare of row `mid` (its lanes 0-3 already in `lo4`) with q.
__device__ __forceinline__ int half_cmp(const uint32_t* rows, int mid,
                                        uint4 lo4, const Key& q) {
  const int c = cmp4(lo4, q.a);
  return c != 0 ? c : cmp4(load_half(rows, mid, 1), q.b);
}

// max over the NT tiers of range_max(table, ub(qb) - 1, lb(qe)): the
// reference's searchsorted_interval and range_max per tier.
template <int NT>
__device__ __forceinline__ int probe_max(const ProbeTier* tiers,
                                         const Key& qb, const Key& qe) {
  int lob[NT], hib[NT], loe[NT], hie[NT], tb[NT], te[NT];
  int depth = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    lob[j] = loe[j] = 0;
    hib[j] = hie[j] = tiers[j].cap;
    tb[j] = te[j] = 1;
    depth = tiers[j].levels > depth ? tiers[j].levels : depth;
  }
  // The staged levels: every interval there is non-empty.
  for (int lvl = 0; lvl < depth; ++lvl) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (lvl >= tiers[j].levels) continue;
      const int mb = (lob[j] + hib[j]) >> 1, me = (loe[j] + hie[j]) >> 1;
      const uint4 rb = tiers[j].top[tb[j] - 1];
      const uint4 re = te[j] == tb[j] ? rb : tiers[j].top[te[j] - 1];
      const bool gb = half_cmp(tiers[j].rows, mb, rb, qb) <= 0;  // ub(b)
      const bool ge = half_cmp(tiers[j].rows, me, re, qe) < 0;   // lb(e)
      if (gb) lob[j] = mb + 1; else hib[j] = mb;
      if (ge) loe[j] = me + 1; else hie[j] = me;
      tb[j] = 2 * tb[j] + gb;
      te[j] = 2 * te[j] + ge;
    }
  }
  // The rest in global memory, until every interval is empty (the
  // reference's remaining iterations are no-ops).
  for (;;) {
    uint4 rb[NT], re[NT];
    bool ab[NT], ae[NT], oe[NT];
    int mb[NT], me[NT];
    bool any = false;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      ab[j] = lob[j] < hib[j];
      ae[j] = loe[j] < hie[j];
      mb[j] = (lob[j] + hib[j]) >> 1;
      me[j] = (loe[j] + hie[j]) >> 1;
      oe[j] = ae[j] && !(ab[j] && me[j] == mb[j]);
      if (ab[j]) rb[j] = load_half(tiers[j].rows, mb[j], 0);
      if (oe[j]) re[j] = load_half(tiers[j].rows, me[j], 0);
      any = any || ab[j] || ae[j];
    }
    if (!any) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!oe[j]) re[j] = rb[j];  // by value: the rows stay in registers
      if (ab[j]) {
        if (half_cmp(tiers[j].rows, mb[j], rb[j], qb) <= 0) lob[j] = mb[j] + 1;
        else hib[j] = mb[j];
      }
      if (ae[j]) {
        if (half_cmp(tiers[j].rows, me[j], re[j], qe) < 0) loe[j] = me[j] + 1;
        else hie[j] = me[j];
      }
    }
  }
  int m = NEG_INF_I32;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int v = range_max(tiers[j].table, tiers[j].cap, hib[j] - 1, hie[j]);
    m = v > m ? v : m;
  }
  return m;
}

#define PROBE_THREADS 256
#define PROBE_QUEUE (PROBE_THREADS / 32 * 64)  // for_live's, a block's

// Runs work(i, part, active) for every i in [0, n) with live(i) and
// skip(i) for the rest.  A warp walks chunks of B = 32 / PER indices
// (grid-stride) and queues its live ones in `queue` (64 ints a warp,
// shared memory), running them B at a time, PER lanes a query (part =
// lane % PER): a mask that leaves most queries dead leaves no lane idle.
// work is called by every lane of the warp (it may shuffle); lanes past
// the last queued query get active = false and a duplicate index.
template <int PER, class Live, class Work, class Skip>
__device__ __forceinline__ void for_live(long n, int* queue, Live live,
                                         Work work, Skip skip) {
  constexpr int B = 32 / PER;
  const int lane = threadIdx.x & 31;
  int* q = queue + (threadIdx.x >> 5) * 64;
  int count = 0;
  const long chunks = (n + B - 1) / B;
  const long warps = (long)gridDim.x * (blockDim.x >> 5);
  for (long c = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       c < chunks; c += warps) {
    const long i = c * B + lane;
    const bool in = lane < B && i < n;
    const bool lv = in && live(i);
    if (in && !lv) skip(i);
    const unsigned m = __ballot_sync(0xFFFFFFFFu, lv);
    if (lv) q[count + __popc(m & ((1u << lane) - 1u))] = (int)i;
    count += __popc(m);  // < 2B <= 64
    __syncwarp();
    if (count >= B) {
      work(q[lane / PER], lane % PER, true);
      count -= B;
      const int rest = lane < count ? q[B + lane] : 0;
      __syncwarp();
      if (lane < count) q[lane] = rest;
      __syncwarp();
    }
  }
  if (count > 0) {
    const int slot = lane / PER;
    work(q[slot < count ? slot : count - 1], lane % PER, slot < count);
  }
}

// hist[idx[k]] += 1 for every k with idx[k] >= 0, called by every lane of
// the warp: the warp's least and greatest index take one atomic each for
// all their items (a warp's run of sorted indices spans one or two), any
// other item its own, so serialised atomics on one address never pile up
// for sorted input, and any input is counted exactly.
template <int N>
__device__ __forceinline__ void count_runs(int* hist, const int (&idx)[N]) {
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (idx[k] >= 0) {
      lo = idx[k] < lo ? idx[k] : lo;
      hi = idx[k] > hi ? idx[k] : hi;
    }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (hi < 0) return;  // no lane has an item
  unsigned n_lo = 0, n_hi = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    n_lo += idx[k] == lo;
    n_hi += idx[k] == hi && hi != lo;
  }
  n_lo = __reduce_add_sync(0xffffffffu, n_lo);
  n_hi = __reduce_add_sync(0xffffffffu, n_hi);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&hist[lo], (int)n_lo);
    if (n_hi) atomicAdd(&hist[hi], (int)n_hi);
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (idx[k] >= 0 && idx[k] != lo && idx[k] != hi)
      atomicAdd(&hist[idx[k]], 1);
}

__host__ __forceinline__ int blocks_for(long n, int threads) {
  long b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 1048576) b = 1048576;
  return (int)b;
}

#define GRID_STRIDE(i, n)                                             \
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < (n); \
       i += (long)gridDim.x * blockDim.x)

#define THREADS 256

// A persistent or cooperative grid: `want` blocks (at least one) of
// `threads` threads, cut to as many as the card holds at once with at
// most `per_sm_cap` an SM (0: no cap).  The occupancy query is made once
// per kernel, block size and device, and kept; *fits: whether all `want`
// fit.
__host__ inline int coop_grid(const void* kern, int threads, int per_sm_cap,
                              long want, int* grid, bool* fits = nullptr) {
  struct Seen { const void* kern; int threads, dev, per_sm, sms; };
  static std::mutex lock;
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (int i = 0; i < n_seen; ++i)
      if (seen[i].kern == kern && seen[i].threads == threads &&
          seen[i].dev == dev) {
        per_sm = seen[i].per_sm;
        sms = seen[i].sms;
      }
  }
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          threads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
    std::lock_guard<std::mutex> hold(lock);
    if (n_seen < 64) seen[n_seen++] = Seen{kern, threads, dev, per_sm, sms};
  }
  if (per_sm_cap > 0 && per_sm > per_sm_cap) per_sm = per_sm_cap;
  const long most = (long)sms * per_sm;
  if (want < 1) want = 1;
  *grid = (int)(want < most ? want : most);
  if (fits != nullptr) *fits = want <= most;
  return 0;
}

// The persistent grid of a probe kernel: as many blocks as fit on the
// card at once, and no more than `lanes` working lanes need.
__host__ inline int probe_grid(const void* kern, long lanes, int* grid,
                               bool* fits = nullptr) {
  return coop_grid(kern, PROBE_THREADS, 0,
                   (lanes + PROBE_THREADS - 1) / PROBE_THREADS, grid, fits);
}

// ---------------------------------------------------------------------------
// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", NVR-2016-002), for the single-pass kernels
// whose tiles take an atomicAdd ticket (rank_scan.cu rs_scan and the
// merge's kept count, window.cu wu_sweep).  A tile publishes its aggregate,
// then its inclusive prefix, in a 64-bit descriptor: the status in the bits
// from SHIFT up, the value below them, one 64-bit store, so a reader never
// sees a status beside a stale value.  SHIFT 32: one 32-bit value whose
// sums wrap in two's complement; SHIFT 62: a pair of counts packed as
// (hi << 31) | lo, each below 2^31 in every prefix, so adding the packed
// words adds both counts.  The descriptor carries its own value and
// nothing else is published through it, so its stores and loads are
// relaxed (strong, gpu scope): a release store would fence every publish
// for no reader.  Descriptors start zeroed (status 0: nothing published).
#define SCAN_AGGREGATE 1ull  // descriptor status
#define SCAN_PREFIX 2ull
#define PAIR_SHIFT 31

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <class T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp 0 of tile `tile` (> 0): sums its predecessors' published values
// back to the nearest inclusive prefix and publishes the tile's own;
// returns the tile's exclusive prefix to every thread.  V is `unsigned`
// for SHIFT 32 and `unsigned long long` for SHIFT 62.
template <class V, int SHIFT>
__device__ __forceinline__ V look_back(unsigned long long* desc, long tile,
                                       V aggregate, V* s_prefix) {
  const unsigned long long mask = (1ull << SHIFT) - 1;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    V prefix = 0;
    for (long last = tile - 1;; last -= 32) {
      const long j = last - lane;  // lane 0: the nearest predecessor
      unsigned long long d = SCAN_PREFIX << SHIFT;  // before tile 0: 0
      if (j >= 0) {
        do {
          d = load_relaxed(desc + j);
        } while ((d >> SHIFT) == 0);
      }
      const unsigned has_prefix = __ballot_sync(0xffffffffu,
                                                (d >> SHIFT) == SCAN_PREFIX);
      const int stop = has_prefix ? __ffs(has_prefix) - 1 : 31;
      prefix += warp_sum<V>(lane <= stop ? (V)(d & mask) : (V)0);
      if (has_prefix) break;
    }
    if (lane == 0) {
      store_relaxed(desc + tile,
                    (SCAN_PREFIX << SHIFT) |
                        ((unsigned long long)(V)(prefix + aggregate) & mask));
      *s_prefix = prefix;
    }
  }
  __syncthreads();
  return *s_prefix;
}
