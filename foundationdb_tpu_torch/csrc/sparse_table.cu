// sparse_table: the doubling range-max table M[j][i] = max(v[i .. i+2^j)).
//
// Replaces (foundationdb_tpu): ops/rangemax.py:20 build_sparse_table, which
// is all of conflict/fused.py:154 delta_table_step and the tail of the merge
// (fused.py:676).
//
// Bound on the card: bytes -- read v once, write (LOG+1) * CAP int32.
//
// Design: one launch per level; level j reads level j-1 (L2-resident at the
// delta's 4 MB, streamed at the base's 8 MB) and writes level j, with
// NEG_INF past the end exactly as the reference's shifted concatenate.
#include "common.cuh"

__global__ void k_level(const int* __restrict__ values, int* __restrict__ table,
                        int cap, int j) {
  GRID_STRIDE(i, cap) {
    if (j == 0) {
      table[i] = values[i];
    } else {
      const int* prev = table + (long)(j - 1) * cap;
      long shift = 1L << (j - 1);
      int a = prev[i];
      int b = i + shift < cap ? prev[i + shift] : NEG_INF_I32;
      table[(long)j * cap + i] = a > b ? a : b;
    }
  }
}

extern "C" int st_level(const void* values, void* table, int cap, int j,
                        void* stream) {
  k_level<<<blocks_for(cap, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)values, (int*)table, cap, j);
  return (int)cudaGetLastError();
}
