// insert: the sorted range insert under the point insert and window_insert.
//
// Replaces (foundationdb_tpu):
//   pi_mark    -- conflict/fused.py:175-177 _point_insert's survivor mask:
//                 the scatter-max of w_ins over unique-key slots, masked by
//                 a shard's owned keys;
//   ri_insert  -- the insert proper of conflict/fused.py:179-247
//                 _point_insert and of conflict/window.py:147-213
//                 window_insert: drop the old boundaries inside each range,
//                 add its begin at `now` and its end at the version
//                 continuing from before, keep the old state on overflow.
//
// Both insert a set of sorted, disjoint ranges [mb, me) into a sorted tier
// of unique boundaries k/v[cap] (rows past size are MAX rows at NEG_INF,
// the window's invariant).  The reference does it as XLA suits a TPU:
// dual-side histograms, cumsums and rank scatters over the whole capacity,
// and for window_insert a sort of the new rows.  On the card each range's
// old-row span and new rows follow from two binary searches, and every
// output position from one scan over the ranges:
//
//   range r drops the old rows [pb, pe), pb = left(mb), pe = left(me),
//   and emits its begin at `now`, then its end at cont_v (the version of
//   the last row <= me, by the wrapper's slot rule: clamped to row 0 for
//   the point insert, wrapped to row cap - 1 for window_insert, as each
//   reference gathers) unless a row sits at me already (present_end).
//   Its net is emitted - (pe - pb) and its offset the exclusive sum of the
//   nets before it: its rows land at pb + offset, and a kept old row i at
//   i + the offset of the first range with pe > i.
//
// Row i is dropped iff some range has pb <= i < pe; that equals the
// reference's cnt_b > cnt_e because the ranges are sorted and disjoint.
// Invalid ranges emit nothing and have pb = pe where the valid ranges
// before them end (or at their tile's first begin), so pb and pe stay
// monotone over all ranges: the point insert's unique keys are sorted
// whether masked or not, window_insert's invalid ranges are MAX rows
// after the valid ones.  An empty range [b, b) at a live boundary b is
// where the reference's two scatters collide (the new begin overwrites the
// old row b, and the row after it is left a MAX row at NEG_INF); the core
// reproduces it by dropping row b and emitting the begin and that hole.
//
// Three launches, none needing a filled buffer:
//   k_ri_probe   a thread per valid range: pb by a search of RI_SPLIT
//                splitter rows in shared memory, then of the live rows
//                between two splitters; pe by galloping from pb; cont_v,
//                present_end, its code and net; a block is a tile of
//                RI_TILE ranges (and its first range's pb, its floor),
//                scanned in shared memory: each range's offset within its
//                tile and the tile's sum;
//   k_ri_move    every block scans the tiles' sums in shared memory (so the
//                total, and with it the overflow, is known before anything
//                moves), then writes the new rows (a thread per range) and
//                the kept old rows (16-byte halves, consecutive threads on
//                consecutive halves; a chunk of RI_ROWS rows finds the
//                ranges ending in it by two warps' 32-ary searches over pe,
//                and each range hands its index to the rows from its end
//                to the next one's in shared memory) in order into a
//                scratch tier; on overflow it writes nothing;
//   k_ri_commit  unless the insert overflowed, the scratch [0, new) into
//                k/v and MAX rows at NEG_INF over [new, old); size, the
//                sticky flag and the 12-byte verdict tail.
// A decoupled look-back over the ranges would need descriptors zeroed by
// an earlier launch, and window_insert has none of its own before the
// probe; the tiles' sums read again by each block of the move need none.
// Timed on the H100 against 512 splitters and none, per-row binary
// searches over pe, 512-row move steps, move / commit grids of 1 to 8
// blocks an SM, and the four launches fused into one cooperative launch
// with grid barriers between them (no faster: a barrier across the card
// costs what a launch does), this shape was the fastest or within 3% at
// every shape.
//
// Bound on the card: bytes -- the ranges, the live rows read once, the
// result written once, [new, old) refilled.  This design reads the rows
// its searches reach besides and writes the result twice (the scratch,
// then the tier); at the paths' shapes its time is launches and dependent
// loads, not bytes (PERF.md).
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

#define RI_THREADS 256
#define RI_TILE RI_THREADS  // ranges a probe block owns
#define RI_ROWS RI_THREADS  // old rows a move block takes a step
#define RI_SPLIT 256  // splitter rows a probe block keeps in shared memory
#define RI_STAGE 2048  // range ends a move block stages at a time
#define RI_MOVE_BLOCKS 8    // move blocks an SM, at most
#define RI_COMMIT_BLOCKS 8  // commit blocks an SM, at most
#define RI_UNROLL 4

#define RI_BEGIN 1  // code bits: the begin is emitted,
#define RI_END 2    //   the end is emitted,
#define RI_HOLE 4   //   a MAX row at NEG_INF follows the begin

// ------------------------------------------------------------ survivors
// m_valid[slot] = max over the writes at slot of w_ins, and with an owned
// mask (a key-range shard's, fused.py:175-177) only where the slot's key
// is owned.  One cooperative launch: zero, grid barrier, scatter.
__global__ void k_pi_mark(long w_pad, const int* __restrict__ w_uid,
                          const int* __restrict__ w_ins, int u_pad,
                          const int* __restrict__ u_own,
                          int* __restrict__ m_valid) {
  cg::grid_group grid = cg::this_grid();
  GRID_STRIDE(u, u_pad) m_valid[u] = 0;
  grid.sync();
  GRID_STRIDE(w, w_pad) {
    const int slot = clampi(w_uid[w], 0, u_pad - 1);
    if (w_ins[w] && (u_own == nullptr || u_own[slot])) m_valid[slot] = 1;
  }
}

// ---------------------------------------------------------------- probe
__device__ __forceinline__ bool is_max_row(const Row& r) {
  unsigned a = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < 8; ++i) a &= r.l[i];
  return a == 0xFFFFFFFFu;
}

// First row of k[lo, hi) not below q (hi when none is), given that the
// rows before lo are below q.
__device__ __forceinline__ int lower_rows(const uint32_t* k, int lo, int hi,
                                          const Row& q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_cmp(load_row(k, mid), q) < 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same over k[lo, n) by galloping from lo: O(log(answer - lo)) probes,
// for an end whose begin's position is lo (a range spans few rows).
__device__ __forceinline__ int gallop_rows(const uint32_t* k, int lo, int n,
                                           const Row& q) {
  int hi = lo, step = 1;
  while (hi < n && row_cmp(load_row(k, hi), q) < 0) {
    lo = hi + 1;
    hi = lo + step;
    step <<= 1;
  }
  return lower_rows(k, lo, hi < n ? hi : n, q);
}

// Splitter j of a live prefix of n rows: row j * n / RI_SPLIT (row 0 first).
__device__ __forceinline__ long split_at(int j, int n) {
  return (long)j * n / RI_SPLIT;
}

// First row of k[0, n) not below q: the splitters in shared memory narrow
// it to the rows between two of them, a binary search finds it there.
__device__ __forceinline__ int split_lower(const uint32_t* k, int n,
                                           const uint4* sp0, const uint4* sp1,
                                           const Row& q) {
  if (n <= 0) return 0;
  const uint4 q0 = make_uint4(q.l[0], q.l[1], q.l[2], q.l[3]);
  const uint4 q1 = make_uint4(q.l[4], q.l[5], q.l[6], q.l[7]);
  int lo = 0, hi = RI_SPLIT;  // splitters below q
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    int c = cmp4(sp0[mid], q0);
    if (c == 0) c = cmp4(sp1[mid], q1);
    if (c < 0) lo = mid + 1; else hi = mid;
  }
  if (lo == 0) return 0;  // row 0 is not below q
  return lower_rows(k, (int)split_at(lo - 1, n) + 1,
                    lo < RI_SPLIT ? (int)split_at(lo, n) : n, q);
}

// Count of a[0, n) at or below x (a non-decreasing), by a whole warp: a
// 32-ary search, each round one probe a lane (as rank_scan.cu's
// k_mg_partition).
__device__ __forceinline__ int upper_ints_warp(const int* a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int mid = lo + lane * step;
    const bool p = mid < hi && a[mid] <= x;
    const int c = __popc(__ballot_sync(0xffffffffu, p));
    if (c == 0) {
      hi = lo;
    } else {
      const int top = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = hi < top ? hi : top;
    }
  }
  return lo;
}

// Exclusive block scan of one int a thread; returns the block's sum.
__device__ __forceinline__ int block_exclusive(int x, int* excl,
                                              int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < RI_THREADS / 32; ++w) {
    const int s = s_warp[w];
    if (w < warp) before += s;
    sum += s;
  }
  *excl = before + incl - x;
  __syncthreads();  // s_warp may be reused
  return sum;
}

// Exclusive block max-scan of one int a thread, from `init`.
__device__ __forceinline__ int block_exclusive_max(int x, int init,
                                                  int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = t > incl ? t : incl;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int m = init;
  for (int w = 0; w < warp; ++w) m = s_warp[w] > m ? s_warp[w] : m;
  const int up = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane > 0) m = up > m ? up : m;
  __syncthreads();  // s_warp may be reused
  return m;
}

struct RiScratch {
  int* pb;    // [W] first old row of the range's span
  int* pe;    // [W] one past its last (pb for a range that drops nothing)
  int* code;  // [W] RI_BEGIN | RI_END | RI_HOLE
  int* cont;  // [W] the end's version
  int* loc;   // [W] the range's exclusive net offset within its tile
  int* agg;   // [nt] each tile's net
  int* totals;  // [2] old size, new size (written by the move)
};

__global__ void __launch_bounds__(RI_THREADS)
    k_ri_probe(const uint32_t* __restrict__ k, const int* __restrict__ v,
               int cap, const int* __restrict__ size_p,
               const uint32_t* __restrict__ mb,
               const uint32_t* __restrict__ me, int w,
               const int* __restrict__ m_valid,
               const int* __restrict__ m_count, int wrap, RiScratch s) {
  __shared__ uint4 s_sp0[RI_SPLIT], s_sp1[RI_SPLIT];  // splitter rows
  __shared__ int s_warp[RI_THREADS / 32];
  __shared__ int s_first;
  const int size = clampi(size_p[0], 0, cap);
  const int r = blockIdx.x * RI_TILE + threadIdx.x;
  const uint4* k4 = reinterpret_cast<const uint4*>(k);
  const bool valid = r < w && (m_valid == nullptr || m_valid[r] != 0) &&
                     (m_count == nullptr || r < m_count[0]);
  const Row b = r < w ? load_row(mb, r) : max_row();
  const Row e = valid ? load_row(me, r) : max_row();
  for (int j = threadIdx.x; j < RI_SPLIT && size > 0; j += RI_THREADS) {
    const long at = split_at(j, size);
    s_sp0[j] = k4[2 * at];
    s_sp1[j] = k4[2 * at + 1];
  }
  __syncthreads();
  int pb = 0, pe = 0, code = 0, cont = NEG_INF_I32, net = 0;
  if (valid) {
    pb = split_lower(k, size, s_sp0, s_sp1, b);
    pe = gallop_rows(k, pb, size, e);
    const bool present = pe < size && row_eq(load_row(k, pe), e);
    // The last row <= e over the whole capacity (its MAX rows included);
    // live rows are unique, so that is pe - 1, or pe when present.
    int slot = pe + (present ? 1 : 0) - 1;
    if (is_max_row(e)) slot = cap - 1;
    if (wrap && slot < 0) slot += cap;
    cont = v[clampi(slot, 0, cap - 1)];
    if (present && row_eq(b, e)) {  // the reference's collision
      code = RI_BEGIN | RI_HOLE;
      pe = pb + 1;
    } else {
      code = RI_BEGIN | (present ? 0 : RI_END);
    }
    net = (code == RI_BEGIN ? 1 : 2) - (pe - pb);
  }
  // The tile's floor: its first range's begin position.  Every range of
  // the tile starts at or after it, every range before ends at or before.
  if (threadIdx.x == 0) {
    s_first = valid ? pb
              : is_max_row(b) ? size : split_lower(k, size, s_sp0, s_sp1, b);
  }
  __syncthreads();
  const int tile_lo = s_first;
  // An invalid range drops nothing and sits where the ranges before it
  // end (the tile's floor if none does), so pb and pe stay monotone with
  // no search of its own.
  const int at = block_exclusive_max(valid ? pe : tile_lo, tile_lo, s_warp);
  if (!valid) pb = pe = at;
  if (r < w) {
    s.pb[r] = pb;
    s.pe[r] = pe;
    s.code[r] = code;
    s.cont[r] = cont;
  }
  int excl;
  const int sum = block_exclusive(net, &excl, s_warp);
  if (r < w) s.loc[r] = excl;
  if (threadIdx.x == 0) s.agg[blockIdx.x] = sum;
}

// ----------------------------------------------------------------- move
// Blocks [0, new_blocks) write the new rows, a thread per range; the rest
// the kept old rows, RI_ROWS a step, grid-stride over the live prefix.
__global__ void __launch_bounds__(RI_THREADS)
    k_ri_move(const uint32_t* __restrict__ k, const int* __restrict__ v,
              int cap, const int* __restrict__ size_p,
              const uint32_t* __restrict__ mb,
              const uint32_t* __restrict__ me, int w, int nt,
              const int* __restrict__ now_p, int now_val, int new_blocks,
              RiScratch s, uint32_t* __restrict__ out_k,
              int* __restrict__ out_v) {
  extern __shared__ int s_pref[];  // [nt] exclusive prefixes of the tiles
  __shared__ int s_warp[RI_THREADS / 32];
  __shared__ int s_r[2];
  __shared__ int s_rank[RI_ROWS];  // each row's first range ending after it
  __shared__ int s_pe[RI_STAGE];   // a batch of the chunk's range ends
  const int size = clampi(size_p[0], 0, cap);
  const int tid = threadIdx.x;
  const bool mover = (int)blockIdx.x >= new_blocks;
  const long first = ((long)blockIdx.x - new_blocks) * RI_ROWS;
  if (mover && first >= size) return;
  // The tiles' exclusive prefixes: each thread a run of consecutive tiles.
  const int per = (nt + RI_THREADS - 1) / RI_THREADS;
  const int t0 = tid * per < nt ? tid * per : nt;
  const int t1 = t0 + per < nt ? t0 + per : nt;
  int run = 0;
  for (int t = t0; t < t1; ++t) run += s.agg[t];
  int before;
  const int total = block_exclusive(run, &before, s_warp);
  for (int t = t0; t < t1; ++t) {
    s_pref[t] = before;
    before += s.agg[t];
  }
  __syncthreads();
  const long new_size = (long)size + total;
  if (blockIdx.x == 0 && tid == 0) {
    s.totals[0] = size;
    s.totals[1] = (int)(new_size < 0x7fffffffL ? new_size : 0x7fffffffL);
  }
  if (new_size > cap) return;  // overflow: nothing moves
  uint4* o4 = reinterpret_cast<uint4*>(out_k);
  if (!mover) {
    const int r = blockIdx.x * RI_THREADS + tid;
    if (r >= w) return;
    const int code = s.code[r];
    if (!(code & RI_BEGIN)) return;
    const long d = (long)s.pb[r] + s_pref[r / RI_TILE] + s.loc[r];
    store_row(out_k, d, load_row(mb, r));
    out_v[d] = now_p != nullptr ? now_p[0] : now_val;
    if (code & RI_END) {
      store_row(out_k, d + 1, load_row(me, r));
      out_v[d + 1] = s.cont[r];
    } else if (code & RI_HOLE) {
      store_row(out_k, d + 1, max_row());
      out_v[d + 1] = NEG_INF_I32;
    }
    return;
  }
  const uint4* k4 = reinterpret_cast<const uint4*>(k);
  const long stride = ((long)gridDim.x - new_blocks) * RI_ROWS;
  for (long c0 = first; c0 < size; c0 += stride) {
    // The ranges ending at or before the chunk's first and last rows, by
    // warps 0 and 1: the ranges [lo, hi) end inside the chunk.
    const int n_rows = (int)(c0 + RI_ROWS < size ? RI_ROWS : size - c0);
    if (tid < 64) {
      const long x = tid < 32 ? c0 : c0 + n_rows - 1;
      const int c = upper_ints_warp(s.pe, w, (int)x);
      if ((tid & 31) == 0) s_r[tid >> 5] = c;
    }
    __syncthreads();
    const int lo = s_r[0], hi = s_r[1];
    // Each row's first range ending after it: range r - 1 (lo - 1: before
    // the chunk) hands r to the rows from its end to the next range's.
    // The ends are staged in shared memory, RI_STAGE at a time, every load
    // of a batch issued before the first is used.
    for (int b0 = lo; b0 <= hi; b0 += RI_STAGE) {
      const int n_b = hi - b0 + 1 < RI_STAGE ? hi - b0 + 1 : RI_STAGE;
#pragma unroll 4
      for (int t = tid; t < n_b; t += RI_THREADS) {
        const int r = b0 + t;  // the rows from pe[r - 1] get r
        s_pe[t] = r == lo ? (int)c0 : s.pe[r - 1];
      }
      __syncthreads();
      for (int t = tid; t < n_b; t += RI_THREADS) {
        const int r = b0 + t;
        const int to = t + 1 < n_b ? s_pe[t + 1]
                       : r < hi ? s.pe[r] : (int)c0 + n_rows;
        for (int j = s_pe[t] - (int)c0; j < to - (int)c0; ++j) s_rank[j] = r;
      }
      __syncthreads();
    }
    // RI_ROWS / RI_THREADS * 2 16-byte halves a thread, consecutive
    // threads on consecutive halves.
#pragma unroll
    for (int q = 0; q < 2 * RI_ROWS / RI_THREADS; ++q) {
      const int h = tid + q * RI_THREADS;
      if ((h >> 1) >= n_rows) continue;
      const long i = c0 + (h >> 1);
      const int rr = s_rank[h >> 1];
      if (rr == w || s.pb[rr] > i) {  // kept
        const long d =
            i + (rr == w ? total : s_pref[rr / RI_TILE] + s.loc[rr]);
        o4[2 * d + (h & 1)] = k4[2 * i + (h & 1)];
        if ((h & 1) == 0) out_v[d] = v[i];
      }
    }
    __syncthreads();  // s_r and s_rank are rewritten next step
  }
}

// --------------------------------------------------------------- commit
__global__ void k_ri_commit(uint32_t* __restrict__ k, int* __restrict__ v,
                            int cap, const uint32_t* __restrict__ out_k,
                            const int* __restrict__ out_v,
                            const int* __restrict__ totals, int* size,
                            int* flag, int flag_or, const int* bsize,
                            int* tail) {
  const int old_size = totals[0], new_size = totals[1];
  const bool ovf = new_size > cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int s2 = ovf ? old_size : new_size;
    const int f2 = (flag_or ? flag[0] : 0) | (ovf ? 1 : 0);
    size[0] = s2;
    flag[0] = f2;
    if (tail != nullptr) {
      tail[0] = f2;
      tail[1] = s2;
      tail[2] = bsize != nullptr ? bsize[0] : 0;  // read after size's write
    }
  }
  if (ovf) return;
  const long n = old_size > new_size ? old_size : new_size;
  const uint4 max4 = make_uint4(~0u, ~0u, ~0u, ~0u);
  const uint4* src4 = reinterpret_cast<const uint4*>(out_k);
  uint4* k4 = reinterpret_cast<uint4*>(k);
  // Rows as 16-byte halves, then versions; RI_UNROLL loads a thread in
  // flight before their stores.
  const long stride = (long)gridDim.x * blockDim.x;
  const long first = blockIdx.x * (long)blockDim.x + threadIdx.x;
  for (long j0 = first; j0 < 2 * n; j0 += RI_UNROLL * stride) {
    uint4 x[RI_UNROLL];
#pragma unroll
    for (int u = 0; u < RI_UNROLL; ++u) {
      const long j = j0 + u * stride;
      if (j < 2 * n) x[u] = (j >> 1) < new_size ? src4[j] : max4;
    }
#pragma unroll
    for (int u = 0; u < RI_UNROLL; ++u) {
      const long j = j0 + u * stride;
      if (j < 2 * n) k4[j] = x[u];
    }
  }
  for (long i0 = first; i0 < n; i0 += RI_UNROLL * stride) {
    int x[RI_UNROLL];
#pragma unroll
    for (int u = 0; u < RI_UNROLL; ++u) {
      const long i = i0 + u * stride;
      if (i < n) x[u] = i < new_size ? out_v[i] : NEG_INF_I32;
    }
#pragma unroll
    for (int u = 0; u < RI_UNROLL; ++u) {
      const long i = i0 + u * stride;
      if (i < n) v[i] = x[u];
    }
  }
}

// ------------------------------------------------------------ launchers
#define S(stream) (cudaStream_t)(stream)

static int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

extern "C" int pi_mark(long w_pad, const void* w_uid, const void* w_ins,
                       int u_pad, const void* u_own, void* m_valid,
                       void* stream) {
  int sms = 0, per_sm = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_pi_mark, RI_THREADS, 0);
  if (err != 0) return err;
  const long work = w_pad > u_pad ? w_pad : u_pad;
  const long want = (work + RI_THREADS - 1) / RI_THREADS;
  const long most = (long)sms * (per_sm > 0 ? per_sm : 1);
  int grid = (int)(want < most ? want : most);
  if (grid < 1) grid = 1;
  void* args[] = {&w_pad, (void*)&w_uid, (void*)&w_ins, &u_pad,
                  (void*)&u_own, &m_valid};
  err = (int)cudaLaunchCooperativeKernel((void*)k_pi_mark, dim3(grid),
                                         dim3(RI_THREADS), args, 0,
                                         S(stream));
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The whole insert, three launches: probe, move, commit.  m_valid (0/1
// per range) or m_count (ranges [0, *m_count) valid) or both may be null;
// wrap: the slot rule (0 clamp, 1 wrap); now_p, when not null, holds
// `now`, else now_val; flag_or: OR the overflow into flag (else flag is
// set to it); bsize and tail may be null.  scratch: int32[scratch_len] >=
// 5 w + nt + 2 (nt = max(1, ceil(w / RI_TILE))), work: int32[9 cap] (the
// scratch tier's rows, then its versions); both may be uninitialised.
extern "C" int ri_insert(void* k, void* v, int cap, void* size,
                         const void* mb, const void* me, int w,
                         const void* m_valid, const void* m_count, int wrap,
                         const void* now_p, int now_val, void* flag,
                         int flag_or, const void* bsize, void* tail,
                         void* scratch, long scratch_len, void* work,
                         void* stream) {
  const int nt = w > 0 ? (w + RI_TILE - 1) / RI_TILE : 1;
  if (w < 0 || scratch_len < 5L * w + nt + 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nt * sizeof(int);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  if (smem > 32 * 1024) {  // with the static arrays, past the default 48 KB
    err = (int)cudaFuncSetAttribute(
        k_ri_move, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  int* base = (int*)scratch;
  RiScratch s;
  s.pb = base;
  s.pe = base + w;
  s.code = base + 2L * w;
  s.cont = base + 3L * w;
  s.loc = base + 4L * w;
  s.agg = base + 5L * w;
  s.totals = s.agg + nt;
  uint32_t* out_k = (uint32_t*)work;
  int* out_v = (int*)work + 8L * cap;
  k_ri_probe<<<nt, RI_THREADS, 0, S(stream)>>>(
      (const uint32_t*)k, (const int*)v, cap, (const int*)size,
      (const uint32_t*)mb, (const uint32_t*)me, w, (const int*)m_valid,
      (const int*)m_count, wrap, s);
  const int new_blocks = nt;
  long movers = ((long)cap + RI_ROWS - 1) / RI_ROWS;
  if (movers > (long)sms * RI_MOVE_BLOCKS)
    movers = (long)sms * RI_MOVE_BLOCKS;
  k_ri_move<<<(unsigned)(new_blocks + movers), RI_THREADS, smem,
              S(stream)>>>((const uint32_t*)k, (const int*)v, cap,
                           (const int*)size, (const uint32_t*)mb,
                           (const uint32_t*)me, w, nt, (const int*)now_p,
                           now_val, new_blocks, s, out_k, out_v);
  long commit = (2L * cap + RI_THREADS - 1) / RI_THREADS;
  if (commit > (long)sms * RI_COMMIT_BLOCKS)
    commit = (long)sms * RI_COMMIT_BLOCKS;
  k_ri_commit<<<(unsigned)commit, RI_THREADS, 0, S(stream)>>>(
      (uint32_t*)k, (int*)v, cap, out_k, out_v, s.totals, (int*)size,
      (int*)flag, flag_or, (const int*)bsize, (int*)tail);
  return (int)cudaGetLastError();
}
