// shard: what key-range sharding adds to the conflict path.
//
// Replaces (foundationdb_tpu):
//   sh_clip    -- the clip of digest ranges to a shard's [lo, hi) bounds
//                 (ops/digest.py lex_max_cols / lex_min_cols) with the
//                 owned mask lex_less(clipped begin, clipped end):
//                 conflict/fused.py:344-346 (the compact step's unique
//                 keys), :489-491 and :553-555 (the general step's reads
//                 and writes), parallel/sharded_window.py:166-175 (the
//                 window's queries and writes); and the begin-in-[lo, hi)
//                 mask of fused.py:391-393, which is a separate output;
//   sh_combine -- the collectives over mesh axis "kr": D per-shard int32[n]
//                 partials to [n], by max on the columns below n_max and
//                 by sum on the rest.  It serves the pmax of history bits
//                 (fused.py:362-364, :506-508), the psum(...) > 0 of the
//                 window's query bits (sharded_window.py:170; for 0/1 bits
//                 sum > 0 is max), the reply tail's pmax / pmax / psum
//                 (fused.py:406-409, :571-573) and the overflow psum
//                 (sharded_window.py:183);
//   sh_commit  -- the window insert's mesh-wide all-or-nothing
//                 (sharded_window.py:184-186): with the combined overflow
//                 set, a shard's pre-insert state is put back.
//
// Bound on the card: bytes.  sh_clip reads two rows and writes two rows and
// two masks per range; sh_combine reads D*n and writes n int32; sh_commit
// reads the one flag and, only on overflow, copies the saved state back.
//
// Design: one thread per row or column, grid-stride loops.  The shard's
// bounds are two rows every thread reads (L1-resident).  sh_combine is
// a launch of well under a microsecond of work, so what it costs is the
// operations queued around it: it takes the D <= COMBINE_MAX partials as
// pointers by value and reads each where it lies (a shard's hist in
// compact_prep's scratch, a window_query's bits, a tail), at any offset,
// so no staging buffer is filled first; sums wrap as int32 (computed in
// uint32).  sh_commit reads the combined flag on the device, so the host
// never synchronises to decide.
#include "common.cuh"

__global__ void k_clip(long n, const uint32_t* __restrict__ b,
                       const uint32_t* __restrict__ e,
                       const uint32_t* __restrict__ lo,
                       const uint32_t* __restrict__ hi,
                       const int* __restrict__ valid,
                       uint32_t* __restrict__ cb, uint32_t* __restrict__ ce,
                       int* __restrict__ owned, int* __restrict__ b_in) {
  const Row l = load_row(lo, 0);
  const Row h = load_row(hi, 0);
  GRID_STRIDE(i, n) {
    Row rb = load_row(b, i);
    Row re = load_row(e, i);
    bool below = row_cmp(rb, l) < 0;
    Row c0 = below ? l : rb;
    Row c1 = row_cmp(h, re) < 0 ? h : re;
    store_row(cb, i, c0);
    store_row(ce, i, c1);
    bool v = valid == nullptr || valid[i] != 0;
    owned[i] = (v && row_cmp(c0, c1) < 0) ? 1 : 0;
    b_in[i] = (!below && row_cmp(rb, h) < 0) ? 1 : 0;
  }
}

#define COMBINE_MAX 8  // ops/shard.py COMBINE_MAX

struct CombineParts {
  const int* p[COMBINE_MAX];  // the first d are the partials, int32[n] each
};

__global__ void k_combine(CombineParts parts, int d, long n, long n_max,
                          int* __restrict__ out) {
  GRID_STRIDE(j, n) {
    const bool by_max = j < n_max;
    int acc = parts.p[0][j];
#pragma unroll
    for (int s = 1; s < COMBINE_MAX; ++s) {
      if (s >= d) break;
      const int v = parts.p[s][j];
      acc = by_max ? (v > acc ? v : acc)
                   : (int)((uint32_t)acc + (uint32_t)v);
    }
    out[j] = acc;
  }
}

__global__ void k_commit(const int* __restrict__ ovf, int cap,
                         const uint32_t* __restrict__ saved_bk,
                         const int* __restrict__ saved_bv,
                         const int* __restrict__ saved_size,
                         uint32_t* __restrict__ bk, int* __restrict__ bv,
                         int* __restrict__ size) {
  if (ovf[0] == 0) return;
  GRID_STRIDE(i, cap) {
    store_row(bk, i, load_row(saved_bk, i));
    bv[i] = saved_bv[i];
    if (i == 0) size[0] = saved_size[0];
  }
}

#define S(stream) (cudaStream_t)(stream)
#define RET return (int)cudaGetLastError()

extern "C" int sh_clip(long n, const void* b, const void* e, const void* lo,
                       const void* hi, const void* valid, void* cb, void* ce,
                       void* owned, void* b_in, void* stream) {
  k_clip<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      n, (const uint32_t*)b, (const uint32_t*)e, (const uint32_t*)lo,
      (const uint32_t*)hi, (const int*)valid, (uint32_t*)cb, (uint32_t*)ce,
      (int*)owned, (int*)b_in);
  RET;
}

// p0 .. p7: the d partials' pointers (the rest null).
extern "C" int sh_combine(const void* p0, const void* p1, const void* p2,
                          const void* p3, const void* p4, const void* p5,
                          const void* p6, const void* p7, int d, long n,
                          long n_max, void* out, void* stream) {
  if (d < 1 || d > COMBINE_MAX) return (int)cudaErrorInvalidValue;
  const CombineParts parts{{(const int*)p0, (const int*)p1, (const int*)p2,
                            (const int*)p3, (const int*)p4, (const int*)p5,
                            (const int*)p6, (const int*)p7}};
  for (int s = 0; s < d; ++s)
    if (parts.p[s] == nullptr) return (int)cudaErrorInvalidValue;
  k_combine<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      parts, d, n, n_max, (int*)out);
  RET;
}

extern "C" int sh_commit(const void* ovf, int cap, const void* saved_bk,
                         const void* saved_bv, const void* saved_size,
                         void* bk, void* bv, void* size, void* stream) {
  k_commit<<<blocks_for(cap, THREADS), THREADS, 0, S(stream)>>>(
      (const int*)ovf, cap, (const uint32_t*)saved_bk,
      (const int*)saved_bv, (const int*)saved_size, (uint32_t*)bk, (int*)bv,
      (int*)size);
  RET;
}
