// window: the window programs' own kernels.
//
// Replaces (foundationdb_tpu, conflict/window.py):
//   wq_query     -- :66-82 window_query: searchsorted_right(begin) - 1,
//                   searchsorted_left(end), the range max over the sparse
//                   table, `valid & max > snap`, fused per query;
//   wu_endpoints -- :95-104 _union_ranges' sweep input: begins then ends
//                   (MAX where invalid), the begins-first tie, +1 / -1;
//   wu_marks     -- :110-112 the merged starts and ends of the coverage
//                   sweep (the sort, cumsum and compactions are sort.cu's
//                   and rank_scan.cu's);
//   wg_keep      -- :226-231 window_gc's removeBefore keep mask.
// window_insert's insert proper (:139-213) is insert.cu's ri_insert, which
// it shares with the point insert.
//
// Bound on the card: bytes.  Every kernel here reads its inputs once and
// writes its outputs once; wq_query adds the table rows its binary
// searches touch and two range-max gathers per query.
//
// Design: one thread per element, grid-stride loops; digests move as
// 32-byte rows (common.cuh).  wq_query is bound by the load instructions
// of its scattered rows, not by their bytes: its searches walk a staged
// top in shared memory, read half rows, share each load where begin and
// end meet the same midpoint, and only valid queries search (probe_max,
// for_live).
#include "common.cuh"

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

__global__ void k_endpoints(long w, const uint32_t* __restrict__ wb,
                            const uint32_t* __restrict__ we,
                            const int* __restrict__ wvalid,
                            uint32_t* __restrict__ digests,
                            int* __restrict__ tie, int* __restrict__ delta) {
  GRID_STRIDE(i, w) {
    bool v = wvalid[i] != 0;
    store_row(digests, i, v ? load_row(wb, i) : max_row());
    store_row(digests, w + i, v ? load_row(we, i) : max_row());
    tie[i] = 0;
    tie[w + i] = 1;
    delta[i] = v ? 1 : 0;
    delta[w + i] = v ? -1 : 0;
  }
}

__global__ void k_marks(long n2, const int* __restrict__ s_delta,
                        const int* __restrict__ cov,
                        int* __restrict__ is_start, int* __restrict__ is_end) {
  GRID_STRIDE(i, n2) {
    int d = s_delta[i];
    int c = cov[i];
    is_start[i] = (d > 0 && c == 1) ? 1 : 0;
    is_end[i] = (d < 0 && c == 0) ? 1 : 0;
  }
}

__global__ void k_gc_keep(int cap, const int* __restrict__ size,
                          const int* __restrict__ bv, int oldest,
                          int* __restrict__ keep) {
  const int sz = size[0];
  GRID_STRIDE(i, cap) {
    bool above = bv[i] >= oldest;
    bool prev = i == 0 ? true : bv[i - 1] >= oldest;
    keep[i] = (i < sz && (i == 0 || above || prev)) ? 1 : 0;
  }
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

extern "C" int wu_endpoints(long w, const void* wb, const void* we,
                            const void* wvalid, void* digests, void* tie,
                            void* delta, void* stream) {
  k_endpoints<<<blocks_for(w, THREADS), THREADS, 0, S(stream)>>>(
      w, (const uint32_t*)wb, (const uint32_t*)we, (const int*)wvalid,
      (uint32_t*)digests, (int*)tie, (int*)delta);
  RET;
}

extern "C" int wu_marks(long n2, const void* s_delta, const void* cov,
                        void* is_start, void* is_end, void* stream) {
  k_marks<<<blocks_for(n2, THREADS), THREADS, 0, S(stream)>>>(
      n2, (const int*)s_delta, (const int*)cov, (int*)is_start,
      (int*)is_end);
  RET;
}

extern "C" int wg_keep(int cap, const void* size, const void* bv, int oldest,
                       void* keep, void* stream) {
  k_gc_keep<<<blocks_for(cap, THREADS), THREADS, 0, S(stream)>>>(
      cap, (const int*)size, (const int*)bv, oldest, (int*)keep);
  RET;
}
