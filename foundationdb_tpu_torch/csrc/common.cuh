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

#include <cstdint>
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

// Branchless lower (left) / upper (right) bound of q in a sorted,
// capacity-padded row table (cap a power of two, nbits = log2 cap):
// the loop of ops/digest.py _searchsorted, ending early once the
// interval is empty (the remaining iterations of the reference are
// no-ops there).
__device__ __forceinline__ int search_rows(const uint32_t* table, int cap,
                                           int nbits, const Row& q,
                                           bool left) {
  int lo = 0, hi = cap;
  for (int it = 0; it <= nbits; ++it) {
    if (lo >= hi) break;
    int mid = (lo + hi) >> 1;
    int midc = mid < cap - 1 ? mid : cap - 1;
    int c = row_cmp(load_row(table, midc), q);
    bool right = left ? (c < 0) : (c <= 0);
    if (right) lo = mid + 1; else hi = mid;
  }
  return hi;
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

// hist[idx] += 1 for every calling thread, with one atomic per distinct
// index among the warp's active threads: many queries share a position
// (every padding query lands on the same slot), and serialised atomics on
// one address would otherwise dominate the histograms.
__device__ __forceinline__ void count_at(int* hist, int idx) {
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, idx);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[idx], __popc(peers));
}

__host__ __forceinline__ int log2_pow2(int cap) {
  int n = 0;
  while ((1 << n) < cap) ++n;
  return n;
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
