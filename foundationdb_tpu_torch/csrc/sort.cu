// sort: stable lexicographic sort of 8-lane digest rows (+ an int32 tie key,
// + an int32 payload).
//
// Replaces (foundationdb_tpu): the jax.lax.sort calls of the general path --
//   conflict/fused.py:524  the endpoint universe (8 key lanes);
//   conflict/window.py:105 _union_ranges (8 lanes + the begins-first tie,
//                          with the +1/-1 delta as payload);
//   conflict/window.py:184 window_insert's new boundaries (8 lanes, with
//                          the version as payload).
//
// Bound on the card: bytes.  Each radix pass reads one key word of every
// row through the current permutation (one 32-byte sector per row, in
// random order) and reads and writes the permutation; the floor is the
// rows and payload read once and written once.
//
// Design: an LSD radix sort of a row-index permutation, 8-bit digits,
// least significant key word first (the tie, flipped to unsigned order,
// then lanes 7..0).  A pass is a per-block histogram (shared-memory
// atomics), one exclusive scan of the digit-major block counts, and a
// stable scatter that ranks each 256-row chunk with __match_any_sync per
// warp and per-warp digit counts in shared memory.  Passes whose digit is
// the same on every non-MAX row are skipped on the device (masks of AND
// and OR over those rows; the tie word's masks cover every row), and a
// last one-bit pass moves the MAX rows behind the rest, stably, which is
// what makes skipping a byte the MAX rows do not share sound.  The rows
// and the payload are gathered once at the end.  The host loop in
// so_sort only enqueues launches; it never synchronises.
#include "common.cuh"

#define SORT_THREADS 256
#define SORT_WARPS (SORT_THREADS / 32)
#define SORT_TILE 4096
#define KEY_WORDS 9  // 8 lanes + the tie

__device__ __forceinline__ bool row_is_max(const uint32_t* rows, long i) {
  const uint4* p = reinterpret_cast<const uint4*>(rows + i * 8);
  uint4 a = p[0];
  uint4 b = p[1];
  return (a.x & a.y & a.z & a.w & b.x & b.y & b.z & b.w) == 0xFFFFFFFFu;
}

__device__ __forceinline__ uint32_t key_word(const uint32_t* rows,
                                             const int* tie, long i, int w) {
  return w < 8 ? rows[i * 8 + w] : ((uint32_t)tie[i] ^ 0x80000000u);
}

// A pass is (w, shift): the byte of key word w at `shift`, or w < 0 for
// the final MAX partition (digit 1 for a MAX row).
__device__ __forceinline__ bool pass_skipped(const uint32_t* masks, int w,
                                             int shift) {
  if (w < 0) return false;
  return (((masks[w] ^ masks[KEY_WORDS + w]) >> shift) & 0xFFu) == 0u;
}

__device__ __forceinline__ int digit_of(const uint32_t* rows, const int* tie,
                                        long i, int w, int shift) {
  if (w < 0) return row_is_max(rows, i) ? 1 : 0;
  return (int)((key_word(rows, tie, i, w) >> shift) & 0xFFu);
}

__global__ void k_init(long n, int* perm, uint32_t* masks) {
  GRID_STRIDE(i, n) perm[i] = (int)i;
  if (blockIdx.x == 0 && threadIdx.x < 2 * KEY_WORDS)
    masks[threadIdx.x] = threadIdx.x < KEY_WORDS ? 0xFFFFFFFFu : 0u;
}

// masks[w] = AND, masks[9 + w] = OR of key word w over the non-MAX rows
// (over every row for the tie word).
__global__ void k_masks(long n, const uint32_t* __restrict__ rows,
                        const int* __restrict__ tie, uint32_t* masks) {
  uint32_t a[KEY_WORDS], o[KEY_WORDS];
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w) {
    a[w] = 0xFFFFFFFFu;
    o[w] = 0u;
  }
  GRID_STRIDE(i, n) {
    if (tie != nullptr) {
      uint32_t t = (uint32_t)tie[i] ^ 0x80000000u;
      a[8] &= t;
      o[8] |= t;
    }
    if (row_is_max(rows, i)) continue;
    Row r = load_row(rows, i);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      a[w] &= r.l[w];
      o[w] |= r.l[w];
    }
  }
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a[w] &= __shfl_xor_sync(0xffffffffu, a[w], off);
      o[w] |= __shfl_xor_sync(0xffffffffu, o[w], off);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int w = 0; w < KEY_WORDS; ++w) {
      atomicAnd(&masks[w], a[w]);
      atomicOr(&masks[KEY_WORDS + w], o[w]);
    }
  }
}

// hist[d * nblocks + b] = rows of block b's tile whose digit is d.
__global__ void __launch_bounds__(SORT_THREADS)
    k_hist(long n, const uint32_t* __restrict__ rows,
           const int* __restrict__ tie, int w, int shift,
           const uint32_t* __restrict__ masks, const int* __restrict__ perm,
           int* __restrict__ hist, int nblocks) {
  if (pass_skipped(masks, w, shift)) return;
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  long lo = (long)blockIdx.x * SORT_TILE;
  long hi = lo + SORT_TILE < n ? lo + SORT_TILE : n;
  for (long i = lo + threadIdx.x; i < hi; i += SORT_THREADS)
    atomicAdd(&h[digit_of(rows, tie, perm[i], w, shift)], 1);
  __syncthreads();
  hist[(long)threadIdx.x * nblocks + blockIdx.x] = h[threadIdx.x];
}

// Exclusive scan of hist[0..m) in place, by one block of 1024 threads, each
// scanning a contiguous run serially.
__global__ void __launch_bounds__(1024)
    k_scan(int* hist, long m, int w, int shift,
           const uint32_t* __restrict__ masks) {
  if (pass_skipped(masks, w, shift)) return;
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long per = (m + blockDim.x - 1) / blockDim.x;
  long lo = threadIdx.x * per;
  long hi = lo + per < m ? lo + per : m;
  int s = 0;
  for (long i = lo; i < hi; ++i) s += hist[i];
  int v = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += t;
    }
    warp_sums[lane] = x;
  }
  __syncthreads();
  int run = v - s + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (long i = lo; i < hi; ++i) {
    int c = hist[i];
    hist[i] = run;
    run += c;
  }
}

// Stable scatter: perm_out[offset of (digit, block) + rank] = perm_in[i].
// A skipped pass copies the permutation unchanged.
__global__ void __launch_bounds__(SORT_THREADS)
    k_scatter(long n, const uint32_t* __restrict__ rows,
              const int* __restrict__ tie, int w, int shift,
              const uint32_t* __restrict__ masks,
              const int* __restrict__ perm_in, int* __restrict__ perm_out,
              const int* __restrict__ offsets, int nblocks) {
  long lo = (long)blockIdx.x * SORT_TILE;
  long hi = lo + SORT_TILE < n ? lo + SORT_TILE : n;
  if (pass_skipped(masks, w, shift)) {
    for (long i = lo + threadIdx.x; i < hi; i += SORT_THREADS)
      perm_out[i] = perm_in[i];
    return;
  }
  __shared__ int base[256];
  __shared__ int wcount[SORT_WARPS][256];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  base[tid] = offsets[(long)tid * nblocks + blockIdx.x];
  for (long c = lo; c < hi; c += SORT_THREADS) {
#pragma unroll
    for (int k = 0; k < SORT_WARPS; ++k) wcount[k][tid] = 0;
    __syncthreads();
    long i = c + tid;
    bool valid = i < hi;
    int src = valid ? perm_in[i] : 0;
    int d = valid ? digit_of(rows, tie, src, w, shift) : 256;
    unsigned peers = __match_any_sync(0xffffffffu, d);
    int rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int pos = base[d] + rank;
      for (int k = 0; k < warp; ++k) pos += wcount[k][d];
      perm_out[pos] = src;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int k = 0; k < SORT_WARPS; ++k) add += wcount[k][tid];
    base[tid] += add;
    __syncthreads();
  }
}

__global__ void k_gather(long n, const int* __restrict__ perm,
                         const uint32_t* __restrict__ rows,
                         const int* __restrict__ payload,
                         uint32_t* __restrict__ out_rows,
                         int* __restrict__ out_payload) {
  GRID_STRIDE(i, n) {
    int p = perm[i];
    store_row(out_rows, i, load_row(rows, p));
    if (payload != nullptr) out_payload[i] = payload[p];
  }
}

#define S(stream) (cudaStream_t)(stream)

// scratch: int32[2n + 256 * nblocks + 2 * KEY_WORDS] (ops/sort.py
// sort_scratch_ints).
extern "C" int so_sort(long n, const void* rows, const void* tie,
                       const void* payload, void* out_rows,
                       void* out_payload, void* scratch, void* stream) {
  if (n <= 0) return 0;
  const int nblocks = (int)((n + SORT_TILE - 1) / SORT_TILE);
  int* perm[2] = {(int*)scratch, (int*)scratch + n};
  int* hist = (int*)scratch + 2 * n;
  uint32_t* masks = (uint32_t*)(hist + 256L * nblocks);
  const uint32_t* r = (const uint32_t*)rows;
  const int* t = (const int*)tie;
  k_init<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(n, perm[0],
                                                             masks);
  k_masks<<<blocks_for(n, THREADS) < 1024 ? blocks_for(n, THREADS) : 1024,
            THREADS, 0, S(stream)>>>(n, r, t, masks);
  int cur = 0;
  const int first_word = tie != nullptr ? 8 : 7;
  for (int w = first_word; w >= -1; --w) {
    for (int shift = 0; shift < 32; shift += 8) {
      if (w < 0 && shift > 0) break;
      k_hist<<<nblocks, SORT_THREADS, 0, S(stream)>>>(
          n, r, t, w, shift, masks, perm[cur], hist, nblocks);
      k_scan<<<1, 1024, 0, S(stream)>>>(hist, 256L * nblocks, w, shift,
                                         masks);
      k_scatter<<<nblocks, SORT_THREADS, 0, S(stream)>>>(
          n, r, t, w, shift, masks, perm[cur], perm[cur ^ 1], hist, nblocks);
      cur ^= 1;
    }
  }
  k_gather<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      n, perm[cur], r, (const int*)payload, (uint32_t*)out_rows,
      (int*)out_payload);
  return (int)cudaGetLastError();
}
