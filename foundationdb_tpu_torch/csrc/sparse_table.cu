// sparse_table: the doubling range-max table M[j][i] = max(v[i .. i+2^j)),
// int32[LOG+1, CAP], NEG_INF past the end exactly as the reference's
// shifted concatenate.
//
// Replaces (foundationdb_tpu): ops/rangemax.py:20 build_sparse_table, which
// is all of conflict/fused.py:154 delta_table_step and the tail of the merge
// (fused.py:676).
//
// Bound on the card: bytes -- read v once, write (LOG+1) * CAP int32 (22
// rows of 8 MB at the base's 2^21: 8.4 MB read, 184.5 MB written).
//
// Design: two launches a call, whatever CAP.
//   st_tile  A block owns T = 2^TL consecutive outputs (2,048 up to CAP
//            2^19, so a small table still fills the card; 4,096 above;
//            ops/rangemax.py tile_log).  It loads
//            v[i0, i0 + 2T) into shared memory with 16-byte loads (NEG_INF
//            past CAP), computes levels 1..min(TL, LOG) in place, and
//            writes each level's T outputs with 16-byte coalesced stores:
//            one read of v gives the first TL + 1 rows.
//   st_high  For j > TL, level j at positions r, r + T, r + 2T, ... is the
//            doubling table of the strided sequence S_r[t] = M[TL][r + tT]
//            (CAP / T elements; 512 at 2^21).  A block takes R consecutive
//            residues r (16: one 64-byte segment per t), loads their
//            sequences from row TL (written by st_tile just before, so
//            mostly an L2 read), builds the remaining levels in shared
//            memory and writes them.
// Each row is written once and row TL read once more.  A CAP at or below
// T needs only st_tile.  Vector loads and stores need CAP % 4 == 0 and
// 16-byte aligned tensors; otherwise both kernels move single ints.
#include "common.cuh"

#define ST_QPT 8  // 16-byte quads per thread per level in st_tile

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(imax(a.x, b.x), imax(a.y, b.y), imax(a.z, b.z),
                   imax(a.w, b.w));
}

// Store quad q of a tile (global position i, i % 4 == 0) into row `row`.
__device__ __forceinline__ void put_quad(int* row, long i, long cap,
                                         int4 v, bool vec) {
  if (vec) {
    if (i < cap) *reinterpret_cast<int4*>(row + i) = v;
    return;
  }
  if (i < cap) row[i] = v.x;
  if (i + 1 < cap) row[i + 1] = v.y;
  if (i + 2 < cap) row[i + 2] = v.z;
  if (i + 3 < cap) row[i + 3] = v.w;
}

// Threads = T / 16, so each thread owns ST_QPT of the 2T / 4 quads.  The
// buffer holds 2T + 8 ints: the halo past 2T reads NEG_INF.
template <int TL>
__global__ void __launch_bounds__((1 << TL) / 16)
    k_tile(const int* __restrict__ values, int* __restrict__ table, int cap,
           int top, bool vec) {
  constexpr int T = 1 << TL;
  constexpr int NT = T / 16;
  extern __shared__ int4 buf4[];
  const int tid = threadIdx.x;
  const long i0 = (long)blockIdx.x * T;
  for (int q = tid; q < T / 2 + 2; q += NT) {
    long i = i0 + 4L * q;
    int4 v;
    if (q >= T / 2 || i >= cap) {
      v = make_int4(NEG_INF_I32, NEG_INF_I32, NEG_INF_I32, NEG_INF_I32);
    } else if (vec) {
      v = *reinterpret_cast<const int4*>(values + i);
    } else {
      v.x = values[i];
      v.y = i + 1 < cap ? values[i + 1] : NEG_INF_I32;
      v.z = i + 2 < cap ? values[i + 2] : NEG_INF_I32;
      v.w = i + 3 < cap ? values[i + 3] : NEG_INF_I32;
    }
    buf4[q] = v;
    if (q < T / 4) put_quad(table, i, cap, v, vec);
  }
  __syncthreads();
  for (int j = 1; j <= top; ++j) {
    const int s = 1 << (j - 1);
    // Level j is needed at p < T + 2^top - 2^j (level top at p < T).
    const int nq = (T + (1 << top) - (1 << j) + 3) >> 2;
    int4 res[ST_QPT];
#pragma unroll
    for (int k = 0; k < ST_QPT; ++k) {
      int q = tid + k * NT;
      if (q >= nq) continue;
      int4 x = buf4[q];
      if (s >= 4) {
        res[k] = max4(x, buf4[q + (s >> 2)]);
      } else {
        int4 y = buf4[q + 1];
        res[k] = s == 1 ? make_int4(imax(x.x, x.y), imax(x.y, x.z),
                                    imax(x.z, x.w), imax(x.w, y.x))
                        : make_int4(imax(x.x, x.z), imax(x.y, x.w),
                                    imax(x.z, y.x), imax(x.w, y.y));
      }
    }
    __syncthreads();
    int* row = table + (long)j * cap;
#pragma unroll
    for (int k = 0; k < ST_QPT; ++k) {
      int q = tid + k * NT;
      if (q >= nq) continue;
      buf4[q] = res[k];
      if (q < T / 4) put_quad(row, i0 + 4L * q, cap, res[k], vec);
    }
    __syncthreads();
  }
}

// Levels tl+1 .. levels-1.  Block b owns residues [b*R, b*R + R) of T;
// S[t][c] = M[tl][b*R + c + t*T] (NEG_INF past CAP), nt rows of R ints.
// Level m of S is updated in place in ascending chunks: an element reads
// only itself and an element s rows later, which no earlier chunk writes.
__global__ void __launch_bounds__(256)
    k_high(int* __restrict__ table, int cap, int tl, int levels, int nt,
           int R, bool vec) {
  extern __shared__ int4 seq4[];
  int* seq = reinterpret_cast<int*>(seq4);
  const int T = 1 << tl;
  const long r0 = (long)blockIdx.x * R;
  const int total = nt * R;
  // Units: quads when vec (R % 4 == 0), single ints otherwise.
  const int w = vec ? 4 : 1;
  const int upr = R / w;  // units per t-row
  const int units = total / w;
  const int* src = table + (long)tl * cap;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    int t = u / upr, c = (u % upr) * w;
    long i = r0 + c + (long)t * T;
    if (vec) {
      seq4[u] = i < cap ? *reinterpret_cast<const int4*>(src + i)
                        : make_int4(NEG_INF_I32, NEG_INF_I32, NEG_INF_I32,
                                    NEG_INF_I32);
    } else {
      seq[u] = i < cap ? src[i] : NEG_INF_I32;
    }
  }
  __syncthreads();
  constexpr int PER = 4;  // units per thread per chunk
  const int chunk = PER * blockDim.x;
  for (int j = tl + 1; j < levels; ++j) {
    const int s = 1 << (j - tl - 1);  // in t-rows
    int* row = table + (long)j * cap;
    for (int base = 0; base < units; base += chunk) {
      int4 res4[PER];
      int res[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        int u = base + threadIdx.x + k * blockDim.x;
        if (u >= units) continue;
        int t = u / upr;
        if (vec) {
          int4 far = t + s < nt ? seq4[u + s * upr]
                                : make_int4(NEG_INF_I32, NEG_INF_I32,
                                            NEG_INF_I32, NEG_INF_I32);
          res4[k] = max4(seq4[u], far);
        } else {
          res[k] = imax(seq[u], t + s < nt ? seq[u + s * upr] : NEG_INF_I32);
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        int u = base + threadIdx.x + k * blockDim.x;
        if (u >= units) continue;
        int t = u / upr, c = (u % upr) * w;
        long i = r0 + c + (long)t * T;
        if (vec) {
          seq4[u] = res4[k];
          if (i < cap) *reinterpret_cast<int4*>(row + i) = res4[k];
        } else {
          seq[u] = res[k];
          if (i < cap) row[i] = res[k];
        }
      }
      __syncthreads();
    }
  }
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

static int levels_for(int cap) {  // ops/rangemax.py table_levels
  int bits = 0;
  while (bits < 31 && (1L << bits) < (long)cap) ++bits;  // ceil(log2 cap)
  return (bits > 1 ? bits : 1) + 1;
}

#define HIGH_SMEM_MAX (227 * 1024)

// Residues per st_high block: 16 (a 64-byte segment per t-row) while the
// block's sequences fit in 96 KB, fewer for very long sequences.
static int high_residues(int nt) {
  int R = 16;
  while (R > 1 && (long)nt * R * 4 > 96 * 1024) R >>= 1;
  return R;
}

// Rows 0 .. min(tl, LOG) of the table; tl is 11, 12 or 14 (ops/rangemax.py
// tile_log).
extern "C" int st_tile(const void* values, void* table, int cap, int tl,
                       void* stream) {
  if (cap <= 0 || (tl != 11 && tl != 12 && tl != 14))
    return (int)cudaErrorInvalidValue;
  const int levels = levels_for(cap);
  const int top = levels - 1 < tl ? levels - 1 : tl;
  const bool vec = cap % 4 == 0 && aligned16(values) && aligned16(table);
  const long blocks = (cap + (1L << tl) - 1) >> tl;
  const size_t smem = ((2u << tl) + 8) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (tl == 11) {
    k_tile<11><<<blocks, 128, smem, s>>>((const int*)values, (int*)table,
                                         cap, top, vec);
  } else if (tl == 12) {
    k_tile<12><<<blocks, 256, smem, s>>>((const int*)values, (int*)table,
                                         cap, top, vec);
  } else {
    cudaFuncSetAttribute(k_tile<14>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    k_tile<14><<<blocks, 1024, smem, s>>>((const int*)values, (int*)table,
                                          cap, top, vec);
  }
  return (int)cudaGetLastError();
}

// Rows tl+1 .. LOG, from row tl; only for cap > 2^tl.
extern "C" int st_high(void* table, int cap, int tl, void* stream) {
  if (cap <= (1 << tl) || (tl != 11 && tl != 12 && tl != 14))
    return (int)cudaErrorInvalidValue;
  const int levels = levels_for(cap);
  const int nt = (int)((cap + (1L << tl) - 1) >> tl);
  const int R = high_residues(nt);
  const size_t smem = (size_t)nt * R * sizeof(int);
  if (smem > HIGH_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k_high, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const bool vec = R % 4 == 0 && cap % 4 == 0 && aligned16(table);
  k_high<<<(1 << tl) / R, 256, smem, (cudaStream_t)stream>>>(
      (int*)table, cap, tl, levels, nt, R, vec);
  return (int)cudaGetLastError();
}
