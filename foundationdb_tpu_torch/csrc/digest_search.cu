// digest_search: binary searches of 8-lane digests into a sorted row table.
//
// Replaces (foundationdb_tpu):
//   ds_search  -- ops/digest.py:243 _searchsorted (searchsorted_left/right),
//                 whose one caller on the card is the general step's
//                 endpoint placement (conflict/fused.py:526-529);
//   ds_history -- conflict/fused.py:351-355: searchsorted_interval
//                 (ops/digest.py:322) over base and delta, each fused with
//                 range_max (ops/rangemax.py:35), max of the two tiers;
//                 with an owned mask (a key-range shard's, fused.py:357)
//                 NEG_INF where the key is not owned.
//
// Bound on the card: bytes.  All of it is integer data movement; each probe
// reads one 32-byte row (one sector) of the table, so the floor is the
// queries and outputs once plus the table rows the probes touch.
//
// Design.  ds_search places every endpoint of a general batch in the
// batch's sorted universe (conflict/fused.py GeneralStep.resolve): 1.18M
// queries into a 2^21-row table at config 3, in one launch.  What bounds
// it is the rate at which a warp's scattered row loads are served: each
// level below the first ~12 loads 32 distinct rows a warp, and a 2^16
// table that sits in L2 costs nearly as much as the 2^21 one (PERF.md).
// So it walks the probes' path-exact staged top: the reference's first
// SEARCH_LEVELS midpoints (lanes 0-3) in shared memory, the rest as half
// rows with lanes 4-7 read only on a tie (half_cmp), SEARCH_CHAINS
// queries a thread in lockstep, over a persistent grid; the result is
// the reference's on any table, sorted or not.  Deeper tops, more
// chains, L2 eviction hints, a lanes 0-3 copy of the table and a
// bucket-sorted search were measured and were not faster.  Against a
// thread a query walking full rows from L1/L2 it gains ~3% on the step's
// unsorted queries and loses ~50% on sorted ones, whose paths L1 already
// shares (PERF.md): a caller that sorts its queries wants that loop.
//
// ds_history is far from its floor: at config 2 its keys
// fill a fraction of the card and the chain of dependent row reads sets
// its time; at the general step's 524,288 reads the load instructions of
// scattered rows do.  So its four searches (begin and end over base and
// delta) walk staged tops in shared memory, read half rows, share one
// load where begin and end meet the same midpoint, run a lane a tier
// when the keys fit on the card at once (else both tiers in lockstep in
// one thread), and unowned keys leave no lane idle (probe_max, for_live
// in common.cuh).
#include "common.cuh"

// Staged levels (2^10 - 1 nodes: 16,368 bytes of shared memory a block)
// and independent queries a thread of ds_search.
#define SEARCH_LEVELS 10
#define SEARCH_CHAINS 2

// The lower (left) or upper bound of each query: thread t of T takes
// queries t, t + T, t + 2T, ..., SEARCH_CHAINS of them at a time, their
// searches in lockstep.
__global__ void __launch_bounds__(PROBE_THREADS)
    k_search(const uint32_t* __restrict__ table, int cap,
             const uint32_t* __restrict__ q, int nq, int left,
             int* __restrict__ out) {
  constexpr int C = SEARCH_CHAINS;
  __shared__ uint4 top[(1 << SEARCH_LEVELS) - 1];
  ProbeTier t;
  stage_tier<SEARCH_LEVELS>(t, table, nullptr, cap, top);
  __syncthreads();
  const long threads = (long)gridDim.x * blockDim.x;
  for (long first = blockIdx.x * (long)blockDim.x + threadIdx.x; first < nq;
       first += C * threads) {
    Key k[C];
    int lo[C], hi[C], node[C];
    bool on[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const long i = first + j * threads;
      on[j] = i < nq;
      if (on[j]) k[j] = load_key(q, i);
      lo[j] = 0;
      hi[j] = cap;
      node[j] = 1;
    }
    // The staged levels: every interval there is non-empty.
    for (int lvl = 0; lvl < t.levels; ++lvl) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (!on[j]) continue;
        const int mid = (lo[j] + hi[j]) >> 1;
        const int c = half_cmp(table, mid, t.top[node[j] - 1], k[j]);
        const bool right = left ? c < 0 : c <= 0;
        if (right) lo[j] = mid + 1; else hi[j] = mid;
        node[j] = 2 * node[j] + right;
      }
    }
    // The rest in global memory, until every interval is empty (the
    // reference's remaining iterations are no-ops).
    for (;;) {
      uint4 r[C];
      int mid[C];
      bool a[C];
      bool any = false;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        a[j] = on[j] && lo[j] < hi[j];
        mid[j] = (lo[j] + hi[j]) >> 1;
        if (a[j]) r[j] = load_half(table, mid[j], 0);
        any = any || a[j];
      }
      if (!any) break;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (!a[j]) continue;
        const int c = half_cmp(table, mid[j], r[j], k[j]);
        if (left ? c < 0 : c <= 0) lo[j] = mid[j] + 1; else hi[j] = mid[j];
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (on[j]) out[first + j * threads] = hi[j];
  }
}

// One range probe a query over both tiers (PER = 1: the four searches in
// lockstep in one thread) or a tier a lane (PER = 2: two lanes a query,
// their maxima combined by a shuffle).  Unowned keys get NEG_INF without
// a search; the owned ones are queued per warp (for_live).
template <int PER>
__global__ void __launch_bounds__(PROBE_THREADS)
    k_history(const uint32_t* __restrict__ bk, int cap,
              const int* __restrict__ table, const uint32_t* __restrict__ dk,
              int dcap, const int* __restrict__ dtable,
              const uint32_t* __restrict__ u_b,
              const uint32_t* __restrict__ u_e, int u_pad,
              const int* __restrict__ own, int* __restrict__ vmax) {
  __shared__ uint4 top[2 * PROBE_NODES];
  __shared__ int queue[PROBE_QUEUE];
  ProbeTier tiers[2];
  stage_tier(tiers[0], bk, table, cap, top);
  stage_tier(tiers[1], dk, dtable, dcap, top + PROBE_NODES);
  __syncthreads();
  for_live<PER>(
      u_pad, queue,
      [&](long u) { return own == nullptr || own[u] != 0; },
      [&](int u, int part, bool active) {
        const Key b = load_key(u_b, u), e = load_key(u_e, u);
        int m;
        if constexpr (PER == 1) {
          m = probe_max<2>(tiers, b, e);
        } else {
          const ProbeTier t = part ? tiers[1] : tiers[0];
          m = probe_max<1>(&t, b, e);
          const int o = __shfl_xor_sync(0xFFFFFFFFu, m, 1);
          m = o > m ? o : m;
        }
        if (active && part == 0) vmax[u] = m;
      },
      [&](long u) { vmax[u] = NEG_INF_I32; });
}

// The persistent grid: as many blocks as fit on the card at once, and no
// more than SEARCH_CHAINS queries a thread need.
extern "C" int ds_search(const void* table, int cap, const void* q, int nq,
                         int left, void* out, void* stream) {
  if (nq <= 0) return 0;
  int grid = 0;
  const int err = probe_grid((const void*)k_search,
                             ((long)nq + SEARCH_CHAINS - 1) / SEARCH_CHAINS,
                             &grid);
  if (err != 0) return err;
  k_search<<<grid, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, cap, (const uint32_t*)q, nq, left, (int*)out);
  return (int)cudaGetLastError();
}

// A lane a tier (PER = 2) when the keys' lanes all fit on the card at
// once (the searches are then latency-bound, and twice the lanes halve
// the chain), a thread a key (PER = 1) otherwise (they are bound by their
// loads, which the lockstep thread issues as many of).  The grid is
// persistent: at most as many blocks as fit on the card at once, and no
// more than the keys need.
extern "C" int ds_history(const void* bk, int cap, const void* table,
                          const void* dk, int dcap, const void* dtable,
                          const void* u_b, const void* u_e, int u_pad,
                          const void* own, void* vmax, void* stream) {
  int grid = 0;
  bool fits = false;
  int err = probe_grid((const void*)k_history<2>, 2L * u_pad, &grid, &fits);
  if (err == 0 && !fits)
    err = probe_grid((const void*)k_history<1>, u_pad, &grid);
  if (err != 0) return err;
  auto kern = fits ? k_history<2> : k_history<1>;
  kern<<<grid, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bk, cap, (const int*)table, (const uint32_t*)dk, dcap,
      (const int*)dtable, (const uint32_t*)u_b, (const uint32_t*)u_e, u_pad,
      (const int*)own, (int*)vmax);
  return (int)cudaGetLastError();
}
