// digest_search: binary searches of 8-lane digests into a sorted row table.
//
// Replaces (foundationdb_tpu):
//   ds_widen   -- conflict/fused.py:300-321, the unique-key byte rows of
//                 the compact buffer widened to 8-lane digests (begin) and
//                 begin-with-marker+1 (end);
//   ds_search  -- ops/digest.py:243 _searchsorted (searchsorted_left/right);
//   ds_history -- conflict/fused.py:351-355: searchsorted_interval
//                 (ops/digest.py:322) over base and delta, each fused with
//                 range_max (ops/rangemax.py:35), max of the two tiers;
//                 with an owned mask (a key-range shard's, fused.py:357)
//                 NEG_INF where the key is not owned.
//
// Bound on the card: bytes.  All of it is integer data movement; each probe
// reads one 32-byte row (one sector) of the table, so the floor is the
// queries and outputs once plus the table rows the probes touch.  The top
// levels of every binary search hit the same few rows and stay in L2.
//
// Design: one thread per query, the branchless loop of the reference with
// an early exit; rows are read as two 16-byte loads.
#include "common.cuh"

__global__ void k_widen(const uint8_t* __restrict__ ub, int u_pad, int lw,
                        const int* __restrict__ scal,
                        uint32_t* __restrict__ u_b, uint32_t* __restrict__ u_e) {
  const int L = lw - 1;
  const int u_n = scal[0];
  GRID_STRIDE(u, u_pad) {
    Row r;
    if (u >= u_n) {
      r = max_row();
      store_row(u_b, u, r);
      store_row(u_e, u, r);
      continue;
    }
    const uint8_t* src = ub + u * (long)lw;
#pragma unroll
    for (int lane = 0; lane < 8; ++lane) {
      uint32_t acc = 0;
#pragma unroll
      for (int bi = 0; bi < 4; ++bi) {
        int pos = 4 * lane + bi;
        acc = acc * 256u;
        if (pos < L) acc += src[pos];
        else if (pos == 31) acc += src[L];  // the length-marker byte
      }
      r.l[lane] = acc;
    }
    store_row(u_b, u, r);
    r.l[7] += 1u;
    store_row(u_e, u, r);
  }
}

__global__ void k_search(const uint32_t* __restrict__ table, int cap,
                         int nbits, const uint32_t* __restrict__ q, int nq,
                         int left, int* __restrict__ out) {
  GRID_STRIDE(i, nq) {
    out[i] = search_rows(table, cap, nbits, load_row(q, i), left != 0);
  }
}

__global__ void k_history(const uint32_t* __restrict__ bk, int cap, int nb,
                          const int* __restrict__ table,
                          const uint32_t* __restrict__ dk, int dcap, int nd,
                          const int* __restrict__ dtable,
                          const uint32_t* __restrict__ u_b,
                          const uint32_t* __restrict__ u_e, int u_pad,
                          const int* __restrict__ own,
                          int* __restrict__ vmax) {
  GRID_STRIDE(u, u_pad) {
    if (own != nullptr && !own[u]) {
      vmax[u] = NEG_INF_I32;
      continue;
    }
    Row b = load_row(u_b, u);
    Row e = load_row(u_e, u);
    int pb = search_rows(bk, cap, nb, b, false);
    int hb = search_rows(bk, cap, nb, e, true);
    int mb = range_max(table, cap, pb - 1, hb);
    int pd = search_rows(dk, dcap, nd, b, false);
    int hd = search_rows(dk, dcap, nd, e, true);
    int md = range_max(dtable, dcap, pd - 1, hd);
    vmax[u] = mb > md ? mb : md;
  }
}

extern "C" int ds_widen(const void* ub, int u_pad, int lw, const void* scal,
                        void* u_b, void* u_e, void* stream) {
  k_widen<<<blocks_for(u_pad, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ub, u_pad, lw, (const int*)scal, (uint32_t*)u_b,
      (uint32_t*)u_e);
  return (int)cudaGetLastError();
}

extern "C" int ds_search(const void* table, int cap, const void* q, int nq,
                         int left, void* out, void* stream) {
  k_search<<<blocks_for(nq, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, cap, log2_pow2(cap), (const uint32_t*)q, nq,
      left, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int ds_history(const void* bk, int cap, const void* table,
                          const void* dk, int dcap, const void* dtable,
                          const void* u_b, const void* u_e, int u_pad,
                          const void* own, void* vmax, void* stream) {
  k_history<<<blocks_for(u_pad, THREADS), THREADS, 0,
              (cudaStream_t)stream>>>(
      (const uint32_t*)bk, cap, log2_pow2(cap), (const int*)table,
      (const uint32_t*)dk, dcap, log2_pow2(dcap), (const int*)dtable,
      (const uint32_t*)u_b, (const uint32_t*)u_e, u_pad, (const int*)own,
      (int*)vmax);
  return (int)cudaGetLastError();
}
