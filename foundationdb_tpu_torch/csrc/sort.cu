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
// Bound on the card: bytes -- the rows (32 bytes), tie and payload read
// once and written once.  A comparison sort moves them once a pass, so what
// bounds it in practice is the number of passes and how close a pass comes
// to streaming; the comparisons are a few shared-memory reads a row.
//
// Design: a merge sort of whole rows whose launches depend only on n
// (1 + 2 * rounds) and whose work does not depend on which key bytes vary
// (the LSD radix sort it replaces ran one pass per live key byte, up to 37,
// each gathering a key word per row through a permutation).
//   k_tile_sort  A block of 512 threads loads a tile of 4,096 rows (lanes
//                with 16-byte loads, the tie) into shared memory.  Each
//                thread sorts its 8 rows in registers by an odd-even
//                transposition network; then 9 merge-path rounds in shared
//                memory merge runs of 8 .. 2,048 rows, moving each row's
//                lanes 0-3 and its 16-bit place in the tile between two
//                buffers (lanes 4-7 and the tie stay put).  The sorted tile
//                is written out with 16-byte coalesced stores, the payload
//                gathered from its input by the rows' places.
//   k_partition  Per merge round: the merge-path split of every merge
//                block's first output, one warp per split by a 32-ary search
//                (each lane probes one point, the ballot narrows the
//                interval), so no merge block waits on dependent global
//                loads before moving its data.
//   k_merge      Per merge round (9 at the config-3 universe of 1,179,648
//                rows): a block of 256 threads owns 1,024 consecutive
//                outputs of one pair of runs, loads its two slices (the
//                splits say where) with 16-byte loads, merges them in shared
//                memory (4 outputs a thread) and writes them coalesced.
// Shared memory holds rows as structure of arrays (lanes 0-3, lanes 4-7)
// at XOR-swizzled slots; a merge keeps each run's head in registers and
// compares lanes 4-7 and the tie only when lanes 0-3 are equal.
// Stability: the order is (lanes 0..7 unsigned, tie signed); equal keys
// take the left run first in every merge, and the transposition network
// swaps only strictly greater neighbours, so equal keys keep their input
// order.  MAX rows need no special case: they sort last.  so_sort only
// enqueues launches; it never synchronises.
#include "common.cuh"

#define TILE_THREADS 512
#define TILE_VT 8                                  // rows a thread sorts
#define TILE_NV (TILE_THREADS * TILE_VT)           // 4,096 rows a tile
#define MERGE_THREADS 256
#define MERGE_VT 4                                 // outputs a thread
#define MERGE_NV (MERGE_THREADS * MERGE_VT)        // 1,024 outputs a block

// A merge block's rows in shared memory, structure of arrays: lanes 0-3
// (h0), lanes 4-7 (h1), the tie and the payload when the call has them,
// and the merged order (idx, rows not slots).  Row p lives at slot(p):
// a thread walks consecutive rows, and the XOR spreads 8 threads' rows
// over the 8 bank groups of a 16-byte access (without it they all hit
// one).  The tile sort uses the same slots.
struct Tile {
  uint4* h0;
  uint4* h1;
  int* tie;  // or nullptr
  int* pay;  // or nullptr
  int* idx;
};

__device__ __forceinline__ int slot(int p) { return p ^ ((p >> 3) & 7); }

__device__ __forceinline__ Tile carve(uint4* smem, bool has_tie,
                                      bool has_pay) {
  Tile s;
  s.h0 = smem;
  s.h1 = smem + MERGE_NV;
  int* p = reinterpret_cast<int*>(smem + 2 * MERGE_NV);
  s.tie = has_tie ? p : nullptr;
  p += has_tie ? MERGE_NV : 0;
  s.pay = has_pay ? p : nullptr;
  p += has_pay ? MERGE_NV : 0;
  s.idx = p;
  return s;
}

static size_t merge_bytes(bool has_tie, bool has_pay) {
  return (size_t)MERGE_NV * (32 + 4 * ((int)has_tie + (int)has_pay + 1));
}

// Key of row a > key of row b, given their first halves (ka, kb): the
// second halves and the ties are read only when the first halves tie.
__device__ __forceinline__ bool gt_s(const Tile& s, int a, uint4 ka, int b,
                                     uint4 kb) {
  int c = cmp4(ka, kb);
  if (c == 0) c = cmp4(s.h1[slot(a)], s.h1[slot(b)]);
  if (c != 0) return c > 0;
  return s.tie != nullptr && s.tie[slot(a)] > s.tie[slot(b)];
}

__device__ __forceinline__ bool gt_s(const Tile& s, int a, int b) {
  return gt_s(s, a, s.h0[slot(a)], b, s.h0[slot(b)]);
}

// Key of global row a > key of global row b.
__device__ __forceinline__ bool gt_g(const uint4* rows, const int* tie,
                                     long a, long b) {
  int c = cmp4(rows[2 * a], rows[2 * b]);
  if (c == 0) c = cmp4(rows[2 * a + 1], rows[2 * b + 1]);
  if (c != 0) return c > 0;
  return tie != nullptr && tie[a] > tie[b];
}

// One thread's part of merging run A = shared rows [0, na) with run B =
// [na, na + nb): outputs d .. d+MERGE_VT of the merge go to idx[d ..], ties
// from A first.  Each run's head stays in registers, so a step reads one
// row.
__device__ __forceinline__ void merge_part(const Tile& s, int na, int nb,
                                           int d) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!gt_s(s, mid, na + d - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int pa = lo, pb = na + d - lo;
  uint4 ka = pa < na ? s.h0[slot(pa)] : make_uint4(0, 0, 0, 0);
  uint4 kb = pb < na + nb ? s.h0[slot(pb)] : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < MERGE_VT; ++k) {
    const bool va = pa < na, vb = pb < na + nb;
    if (!va && !vb) break;
    const bool take_a = !vb || (va && !gt_s(s, pa, ka, pb, kb));
    s.idx[d + k] = take_a ? pa : pb;
    if (take_a) {
      if (++pa < na) ka = s.h0[slot(pa)];
    } else {
      if (++pb < na + nb) kb = s.h0[slot(pb)];
    }
  }
}

// Write the merge block's cnt rows out in the order idx, coalesced.
__device__ __forceinline__ void store_merged(const Tile& s, uint4* o_rows,
                                             int* o_tie, int* o_pay, long o0,
                                             int cnt) {
#pragma unroll
  for (int k = 0; k < 2 * MERGE_NV / MERGE_THREADS; ++k) {
    const int u = threadIdx.x + k * MERGE_THREADS;
    if (u >= 2 * cnt) break;
    const int q = slot(s.idx[u >> 1]);
    o_rows[2 * o0 + u] = (u & 1) ? s.h1[q] : s.h0[q];
  }
#pragma unroll
  for (int k = 0; k < MERGE_NV / MERGE_THREADS; ++k) {
    const int r = threadIdx.x + k * MERGE_THREADS;
    if (r >= cnt) break;
    const int q = slot(s.idx[r]);
    if (o_tie != nullptr) o_tie[o0 + r] = s.tie[q];
    if (o_pay != nullptr) o_pay[o0 + r] = s.pay[q];
  }
}

struct RowReg {
  uint4 h0, h1;
  int tie, row;
};

__device__ __forceinline__ bool gt_r(const RowReg& a, const RowReg& b,
                                     bool has_tie) {
  int c = cmp4(a.h0, b.h0);
  if (c == 0) c = cmp4(a.h1, b.h1);
  if (c != 0) return c > 0;
  return has_tie && a.tie > b.tie;
}

// The tile sort's shared memory: each row's lanes 0-3 (its key) move
// between two buffers in run order, with the row's place in the tile
// beside it; lanes 4-7 and the tie stay at the row's place.  A merge step
// so reads its next key directly, not through a permutation.
struct SortTile {
  uint4* key[2];
  uint16_t* row[2];
  uint4* h1;
  int* tie;  // or nullptr
};

static size_t tile_sort_bytes(bool has_tie) {
  return (size_t)TILE_NV * (3 * 16 + 2 * 2 + (has_tie ? 4 : 0));
}

// Key (ka of tile row ra) > key (kb of tile row rb): lanes 4-7 and the
// tie are read only when lanes 0-3 are equal.
__device__ __forceinline__ bool gt_k(const SortTile& s, uint4 ka, int ra,
                                     uint4 kb, int rb) {
  int c = cmp4(ka, kb);
  if (c == 0) c = cmp4(s.h1[slot(ra)], s.h1[slot(rb)]);
  if (c != 0) return c > 0;
  return s.tie != nullptr && s.tie[slot(ra)] > s.tie[slot(rb)];
}

// One thread's part of a tile round: merge run A = positions [a0, a0+na)
// with run B = [b0, b0+nb) of buffer `in`, outputs d .. d+TILE_VT of the
// merge to positions a0 + d .. of buffer `in ^ 1`, ties from A first.
__device__ __forceinline__ void merge_keys(const SortTile& s, int in, int a0,
                                           int na, int b0, int nb, int d) {
  const uint4* kin = s.key[in];
  const uint16_t* rin = s.row[in];
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int qa = slot(a0 + mid), qb = slot(b0 + d - 1 - mid);
    if (!gt_k(s, kin[qa], rin[qa], kin[qb], rin[qb])) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = d - lo;
  uint4 ka = make_uint4(0, 0, 0, 0), kb = ka;
  int ra = 0, rb = 0;
  if (ia < na) { ka = kin[slot(a0 + ia)]; ra = rin[slot(a0 + ia)]; }
  if (ib < nb) { kb = kin[slot(b0 + ib)]; rb = rin[slot(b0 + ib)]; }
  uint4* kout = s.key[in ^ 1];
  uint16_t* rout = s.row[in ^ 1];
#pragma unroll
  for (int k = 0; k < TILE_VT; ++k) {
    if (ia >= na && ib >= nb) break;
    const bool take_a = ib >= nb || (ia < na && !gt_k(s, ka, ra, kb, rb));
    const int q = slot(a0 + d + k);
    kout[q] = take_a ? ka : kb;
    rout[q] = (uint16_t)(take_a ? ra : rb);
    if (take_a) {
      if (++ia < na) { ka = kin[slot(a0 + ia)]; ra = rin[slot(a0 + ia)]; }
    } else {
      if (++ib < nb) { kb = kin[slot(b0 + ib)]; rb = rin[slot(b0 + ib)]; }
    }
  }
}

// Sort a tile of TILE_NV rows: each thread sorts its TILE_VT rows in
// registers by an odd-even transposition network (stable: only strictly
// greater neighbours swap); then merge-path rounds in shared memory merge
// runs of TILE_VT .. TILE_NV / 2 rows, moving keys between the buffers.
__global__ void __launch_bounds__(TILE_THREADS)
    k_tile_sort(long n, const uint4* __restrict__ rows,
                const int* __restrict__ tie, const int* __restrict__ pay,
                uint4* __restrict__ o_rows, int* __restrict__ o_tie,
                int* __restrict__ o_pay) {
  extern __shared__ uint4 smem[];
  const bool has_tie = tie != nullptr;
  SortTile s;
  s.key[0] = smem;
  s.key[1] = smem + TILE_NV;
  s.h1 = smem + 2 * TILE_NV;
  s.row[0] = reinterpret_cast<uint16_t*>(smem + 3 * TILE_NV);
  s.row[1] = s.row[0] + TILE_NV;
  s.tie = has_tie ? reinterpret_cast<int*>(s.row[1] + TILE_NV) : nullptr;
  const long o0 = (long)blockIdx.x * TILE_NV;
  const int cnt = (int)(n - o0 < TILE_NV ? n - o0 : TILE_NV);
  // Lanes 0-3 land in key[1] (read back below), lanes 4-7 in place.
#pragma unroll
  for (int k = 0; k < 2 * TILE_NV / TILE_THREADS; ++k) {
    const int u = threadIdx.x + k * TILE_THREADS;
    if (u >= 2 * cnt) break;
    const uint4 v = rows[2 * o0 + u];
    if (u & 1) s.h1[slot(u >> 1)] = v;
    else s.key[1][slot(u >> 1)] = v;
  }
  if (has_tie) {
#pragma unroll
    for (int k = 0; k < TILE_NV / TILE_THREADS; ++k) {
      const int r = threadIdx.x + k * TILE_THREADS;
      if (r >= cnt) break;
      s.tie[slot(r)] = tie[o0 + r];
    }
  }
  __syncthreads();
  const int d = threadIdx.x * TILE_VT;
  const int m = cnt - d < TILE_VT ? (cnt > d ? cnt - d : 0) : TILE_VT;
  RowReg reg[TILE_VT];
#pragma unroll
  for (int k = 0; k < TILE_VT; ++k) {
    if (k < m) {
      const int q = slot(d + k);
      reg[k].h0 = s.key[1][q];
      reg[k].h1 = s.h1[q];
      reg[k].tie = has_tie ? s.tie[q] : 0;
      reg[k].row = d + k;
    }
  }
#pragma unroll
  for (int ph = 0; ph < TILE_VT; ++ph) {
#pragma unroll
    for (int k = ph & 1; k + 1 < TILE_VT; k += 2) {
      if (k + 1 < m && gt_r(reg[k], reg[k + 1], has_tie)) {
        const RowReg t = reg[k];
        reg[k] = reg[k + 1];
        reg[k + 1] = t;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TILE_VT; ++k) {
    if (k < m) {
      s.key[0][slot(d + k)] = reg[k].h0;
      s.row[0][slot(d + k)] = (uint16_t)reg[k].row;
    }
  }
  __syncthreads();
  int in = 0;
  for (int w = TILE_VT; w < cnt; w <<= 1) {
    if (d < cnt) {
      const int pb = d / (2 * w) * (2 * w);
      const int na = cnt - pb < w ? cnt - pb : w;
      int nb = cnt - pb - w;
      nb = nb < 0 ? 0 : (nb > w ? w : nb);
      merge_keys(s, in, pb, na, pb + w, nb, d - pb);
    }
    __syncthreads();
    in ^= 1;
  }
#pragma unroll
  for (int k = 0; k < 2 * TILE_NV / TILE_THREADS; ++k) {
    const int u = threadIdx.x + k * TILE_THREADS;
    if (u >= 2 * cnt) break;
    const int q = slot(u >> 1);
    o_rows[2 * o0 + u] = (u & 1) ? s.h1[slot(s.row[in][q])] : s.key[in][q];
  }
#pragma unroll
  for (int k = 0; k < TILE_NV / TILE_THREADS; ++k) {
    const int r = threadIdx.x + k * TILE_THREADS;
    if (r >= cnt) break;
    const int src = s.row[in][slot(r)];
    if (o_tie != nullptr) o_tie[o0 + r] = s.tie[slot(src)];
    if (o_pay != nullptr) o_pay[o0 + r] = pay[o0 + src];
  }
}

// The merge-path split of diagonal b * MERGE_NV within its pair of runs of
// width W (how many of its first outputs come from run A), for every merge
// block b: one warp per split, a 32-ary search (each lane probes one point
// of the interval, the ballot of "A first" answers narrows it), so a split
// of 2^19 candidates takes four dependent loads.  Done in its own launch so
// that no merge block waits on dependent global loads.
__global__ void __launch_bounds__(256)
    k_partition(long n, long W, const uint4* __restrict__ rows,
                const int* __restrict__ tie, int nsplit,
                int* __restrict__ splits) {
  const int b = (int)((blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= nsplit) return;  // whole warps leave together
  const long o = (long)b * MERGE_NV;
  const long pb = o / (2 * W) * (2 * W);
  const long na_run = n - pb < W ? n - pb : W;
  long nb_run = n - pb - W;
  nb_run = nb_run < 0 ? 0 : (nb_run > W ? W : nb_run);
  const long d = o - pb;
  long lo = d > nb_run ? d - nb_run : 0;
  long hi = d < na_run ? d : na_run;
  while (lo < hi) {
    const long step = (hi - lo + 31) / 32;
    const long mid = lo + lane * step;
    const bool p = mid < hi &&
                   !gt_g(rows, tie, pb + mid, pb + W + d - 1 - mid);
    const int c = __popc(__ballot_sync(0xffffffffu, p));
    if (c == 0) {
      hi = lo;
    } else {
      const long top = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = hi < top ? hi : top;
    }
  }
  if (lane == 0) splits[b] = (int)lo;
}

// Merge sorted runs of width W pairwise: block b writes outputs
// [b * MERGE_NV, ...) of the pair that holds them, from the slices of its
// two runs that the splits give.
__global__ void __launch_bounds__(MERGE_THREADS)
    k_merge(long n, long W, const uint4* __restrict__ rows,
            const int* __restrict__ tie, const int* __restrict__ pay,
            const int* __restrict__ splits, uint4* __restrict__ o_rows,
            int* __restrict__ o_tie, int* __restrict__ o_pay) {
  extern __shared__ uint4 smem[];
  const bool has_tie = tie != nullptr, has_pay = pay != nullptr;
  const Tile s = carve(smem, has_tie, has_pay);
  const long o0 = (long)blockIdx.x * MERGE_NV;
  const long o1 = n < o0 + MERGE_NV ? n : o0 + MERGE_NV;
  const long pb = o0 / (2 * W) * (2 * W);       // the pair's first row
  const long na_run = n - pb < W ? n - pb : W;  // run A = [pb, pb + na_run)
  const long b_lo = pb + W;                     // run B = [b_lo, ...)
  // The block's last output ends its pair (all of A taken) or is the next
  // block's first diagonal, in the same pair.
  const bool pair_end = o1 == n || o1 == pb + 2 * W;
  const long i0 = splits[blockIdx.x];
  const long i1 = pair_end ? na_run : splits[blockIdx.x + 1];
  const int cnt = (int)(o1 - o0);
  const int na = (int)(i1 - i0);
  const int nb = cnt - na;
  const long a_src = pb + i0;
  const long b_src = b_lo + (o0 - pb) - i0;
#pragma unroll
  for (int k = 0; k < 2 * MERGE_NV / MERGE_THREADS; ++k) {
    const int u = threadIdx.x + k * MERGE_THREADS;
    if (u >= 2 * cnt) break;
    const int r = u >> 1;
    const long g = r < na ? a_src + r : b_src + (r - na);
    const uint4 v = rows[2 * g + (u & 1)];
    if (u & 1) s.h1[slot(r)] = v;
    else s.h0[slot(r)] = v;
  }
#pragma unroll
  for (int k = 0; k < MERGE_NV / MERGE_THREADS; ++k) {
    const int r = threadIdx.x + k * MERGE_THREADS;
    if (r >= cnt) break;
    const long g = r < na ? a_src + r : b_src + (r - na);
    if (has_tie) s.tie[slot(r)] = tie[g];
    if (has_pay) s.pay[slot(r)] = pay[g];
  }
  __syncthreads();
  const int d = threadIdx.x * MERGE_VT;
  if (d < cnt) merge_part(s, na, nb, d);
  __syncthreads();
  store_merged(s, o_rows, o_tie, o_pay, o0, cnt);
}

// Sort n rows in 1 + 2 * rounds launches: the tile sort, then a partition
// and a merge per round (ops/sort.py sort_rounds: the fewest doublings of
// TILE_NV that reach n; any other count is refused).
// scratch: int32[11 n + n / MERGE_NV + 1] (ops/sort.py sort_scratch_ints):
// the second rows buffer, two tie buffers, the second payload buffer and
// the splits.  Pass p writes the buffer of parity (passes - 1 - p), so the
// last writes out_rows and out_payload.
extern "C" int so_sort(long n, int rounds, const void* rows, const void* tie,
                       const void* payload, void* out_rows, void* out_payload,
                       void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (rounds < 0 || rounds > 40 || ((long)TILE_NV << rounds) < n ||
      (rounds > 0 && ((long)TILE_NV << (rounds - 1)) >= n))
    return (int)cudaErrorInvalidValue;
  const int passes = 1 + rounds;
  const bool has_tie = tie != nullptr, has_pay = payload != nullptr;
  uint4* rb[2] = {(uint4*)out_rows, (uint4*)scratch};
  int* sc = (int*)scratch + 8 * n;
  int* tb[2] = {sc, sc + n};
  int* pbuf[2] = {(int*)out_payload, sc + 2 * n};
  int* splits = sc + 3 * n;
  const int mblocks = (int)((n + MERGE_NV - 1) / MERGE_NV);
  const size_t sm_tile = tile_sort_bytes(has_tie);
  const size_t sm_merge = merge_bytes(has_tie, has_pay);
  cudaFuncSetAttribute(k_tile_sort,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sm_tile);
  cudaFuncSetAttribute(k_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sm_merge);
  cudaStream_t st = (cudaStream_t)stream;
  int q = (passes - 1) & 1;
  k_tile_sort<<<(n + TILE_NV - 1) / TILE_NV, TILE_THREADS, sm_tile, st>>>(
      n, (const uint4*)rows, (const int*)tie, (const int*)payload, rb[q],
      has_tie ? tb[q] : nullptr, has_pay ? pbuf[q] : nullptr);
  for (int r = 0; r < rounds; ++r) {
    const int src = q;
    const long W = (long)TILE_NV << r;
    q = (passes - 2 - r) & 1;
    k_partition<<<(mblocks + 7) / 8, 256, 0, st>>>(
        n, W, rb[src], has_tie ? tb[src] : nullptr, mblocks, splits);
    k_merge<<<mblocks, MERGE_THREADS, sm_merge, st>>>(
        n, W, rb[src], has_tie ? tb[src] : nullptr,
        has_pay ? pbuf[src] : nullptr, splits, rb[q],
        has_tie ? tb[q] : nullptr, has_pay ? pbuf[q] : nullptr);
  }
  return (int)cudaGetLastError();
}
