// digest_search: binary searches of 8-lane digests into a sorted row table.
//
// Replaces (foundationdb_tpu):
//   ds_search  -- ops/digest.py:243 _searchsorted (searchsorted_left/right);
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
// Design: one thread per query, the branchless loop of the reference with
// an early exit.  ds_history is far from that floor: at config 2 its keys
// fill a fraction of the card and the chain of dependent row reads sets
// its time; at the general step's 524,288 reads the load instructions of
// scattered rows do.  So its four searches (begin and end over base and
// delta) walk staged tops in shared memory, read half rows, share one
// load where begin and end meet the same midpoint, run a lane a tier
// when the keys fit on the card at once (else both tiers in lockstep in
// one thread), and unowned keys leave no lane idle (probe_max, for_live
// in common.cuh).
#include "common.cuh"

__global__ void k_search(const uint32_t* __restrict__ table, int cap,
                         int nbits, const uint32_t* __restrict__ q, int nq,
                         int left, int* __restrict__ out) {
  GRID_STRIDE(i, nq) {
    out[i] = search_rows(table, cap, nbits, load_row(q, i), left != 0);
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

extern "C" int ds_search(const void* table, int cap, const void* q, int nq,
                         int left, void* out, void* stream) {
  k_search<<<blocks_for(nq, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, cap, log2_pow2(cap), (const uint32_t*)q, nq,
      left, (int*)out);
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
