// intra_batch: the per-batch transaction logic of the compact point step.
//
// Replaces (foundationdb_tpu, conflict/fused.py make_resolve_step_compact):
//   ib_txn_prep    -- :324-330 too-old (SkipList.cpp:819) and the histogram
//                     halves of the r_txn / w_txn rank_counts;
//   ib_rw_prep     -- :332-371 live reads, the history verdict of each read
//                     from the unique-key maxima, scatter-max per txn, and
//                     the writers' txn, base eligibility and slot, in one
//                     launch;
//   ib_fixpoint    -- :373-385 the Jacobi intra-batch fixpoint
//                     (lax.while_loop), iterated ON THE DEVICE;
//   ib_codes       -- :388-405 survivors, the insert mask and verdict codes.
// and of the general interval step (make_resolve_step):
//   ig_txn         -- :479 too-old per txn from the metadata block;
//   ig_rw          -- :482-511 live reads, their history verdicts (from the
//                     two-tier maxima of history_probe) scatter-maxed per
//                     txn, and the writers' base eligibility;
//   ig_codes       -- :550-566 survivors, the insert mask and the codes.
//
// Bound on the card: bytes for the prep and code passes (each array read
// and written once).  The fixpoint's least work is one pass over writes,
// reads and txns per round, for as many rounds as the batch's chain depth;
// at config 2 that is ~3 MB a round, so its time is the rounds' grid-wide
// barriers and dependent loads, not bandwidth.
//
// Design: the fixpoint is one cooperative persistent launch over every SM
// (cudaLaunchCooperativeKernel; the grid is the blocks the occupancy query
// lets co-reside, at most FIX_BLOCKS_PER_SM an SM, and no more than the
// work needs), looping on the device with cooperative_groups grid.sync()
// between phases, so the host never synchronises per round.  A round is
// three phases and three barriers: atomicMin each active write's txn into
// the cover | scatter each live read's hit into the next conflicts |
// compare and copy into conf, raising the round's changed flag.  Cover and
// next-conflict scratch are double-buffered by round parity: the compare
// phase of round r refills round r+1's buffers (cover to INF, the next
// conflicts to the history baseline), which no phase of round r touches,
// so no fourth barrier is spent on the reset.  The changed flags are
// double-buffered the same way: round r clears its flag in its first
// phase; every thread last read it at the end of round r-2, behind round
// r-1's barriers.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define FIX_THREADS 256
// Blocks an SM: measured on the H100 at 1, 2, 3, 4, 6 and 8, two gave the
// fastest config-2 batch and 300-deep chain; more blocks make every grid
// barrier slower, fewer leave the phases' loads short of parallelism.
#define FIX_BLOCKS_PER_SM 2

__global__ void k_txn_prep(int t_cap, int r_pad, int w_pad,
                           const int* __restrict__ r_start,
                           const int* __restrict__ w_start,
                           const int* __restrict__ t_snap,
                           const uint8_t* __restrict__ t_flags,
                           const int* __restrict__ scal,
                           int* __restrict__ too_old, int* __restrict__ hist_r,
                           int* __restrict__ hist_w) {
  const int n_t = scal[3];
  const int oldest = scal[5];
  GRID_STRIDE(t, t_cap) {
    bool valid = t < n_t;
    too_old[t] = (valid && (t_flags[t] & 1) && t_snap[t] < oldest) ? 1 : 0;
    // Padding txns sit at r_pad / w_pad, which the scans never read.
    int pr = clampi(valid ? r_start[t] : r_pad, 0, r_pad);
    int pw = clampi(valid ? w_start[t] : w_pad, 0, w_pad);
    if (pr < r_pad) count_at(hist_r, pr);
    if (pw < w_pad) count_at(hist_w, pw);
  }
}

// The reads' and the writes' prep in one launch: blocks [0, read_blocks)
// take the reads, the rest the writes, RW_VEC consecutive elements a
// thread.  The inputs move as int4 loads and the outputs as int4 stores
// when every array is 16-byte aligned (VEC) and the four lie below the
// pad; four across the pad, or any four without VEC, go element by
// element.  A read's gathers (too_old and t_snap of its txn, vmax_u of its
// slot) are issued for all four elements before any is used, and only for
// reads below n_r (the rest are not live and gather nothing).  No order of
// r_cnt / w_cnt is assumed: each element's txn is its own count minus one.
// Timed on the H100 at 256 threads x 4 and 8 elements and 128 x 4: 8 was
// 20% slower, 128 x 4 level with 256 x 4.
#define RW_VEC 4
#define RW_ITEMS (THREADS * RW_VEC)  // elements a block

struct RwArgs {
  int r_pad, w_pad, t_cap, u_pad;
  const int* r_uid;
  const int* r_cnt;
  const int* w_uid;
  const int* w_cnt;
  const int* too_old;
  const int* t_snap;
  const int* scal;
  const int* vmax_u;
  int* r_txn;
  int* r_live;
  int* r_slot;
  int* hist;  // zeroed by the wrapper; live reads with a hit set their txn
  int* w_txn;
  int* w_ok;
  int* w_slot;
};

// RW_VEC consecutive elements from i (0 past n): int4 loads when VEC and
// all of them lie below n, else element by element.
template <bool VEC>
__device__ __forceinline__ void load_run(const int* __restrict__ a, long i,
                                         long n, int v[RW_VEC]) {
  if (VEC && i + RW_VEC <= n) {
#pragma unroll
    for (int q = 0; q < RW_VEC / 4; ++q) {
      const int4 x = *reinterpret_cast<const int4*>(a + i + 4 * q);
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k) v[k] = i + k < n ? a[i + k] : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_run(int* __restrict__ a, long i,
                                          long n, const int v[RW_VEC]) {
  if (VEC && i + RW_VEC <= n) {
#pragma unroll
    for (int q = 0; q < RW_VEC / 4; ++q)
      *reinterpret_cast<int4*>(a + i + 4 * q) =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k)
      if (i + k < n) a[i + k] = v[k];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    k_rw_prep(RwArgs a, int read_blocks) {
  __shared__ int s_n;
  const bool reads = (int)blockIdx.x < read_blocks;
  if (threadIdx.x == 0) s_n = a.scal[reads ? 1 : 2];  // n_r or n_w
  __syncthreads();
  const long n_live = s_n;
  const long blk = reads ? blockIdx.x : blockIdx.x - read_blocks;
  const long i = (blk * THREADS + threadIdx.x) * RW_VEC;
  const long pad = reads ? a.r_pad : a.w_pad;
  if (i >= pad) return;
  int uid[RW_VEC], cnt[RW_VEC];
  load_run<VEC>(reads ? a.r_uid : a.w_uid, i, pad, uid);
  load_run<VEC>(reads ? a.r_cnt : a.w_cnt, i, pad, cnt);
  int txn[RW_VEC], tc[RW_VEC], slot[RW_VEC];
  bool valid[RW_VEC];
#pragma unroll
  for (int k = 0; k < RW_VEC; ++k) {
    txn[k] = (int)((unsigned)cnt[k] - 1u);  // wraps, as int32 in torch
    tc[k] = clampi(txn[k], 0, a.t_cap - 1);
    slot[k] = clampi(uid[k], 0, a.u_pad - 1);
    valid[k] = i + k < pad && i + k < n_live;
  }
  if (!reads) {
    int ok[RW_VEC];
#pragma unroll
    for (int k = 0; k < RW_VEC; ++k)
      ok[k] = valid[k] && !a.too_old[tc[k]] ? 1 : 0;
    store_run<VEC>(a.w_txn, i, pad, txn);
    store_run<VEC>(a.w_ok, i, pad, ok);
    store_run<VEC>(a.w_slot, i, pad, slot);
    return;
  }
  int old[RW_VEC], snap[RW_VEC], vmax[RW_VEC], live[RW_VEC];
#pragma unroll
  for (int k = 0; k < RW_VEC; ++k) {  // every gather before any use
    old[k] = valid[k] ? a.too_old[tc[k]] : 1;
    snap[k] = valid[k] ? a.t_snap[tc[k]] : 0;
    vmax[k] = valid[k] ? a.vmax_u[slot[k]] : 0;
  }
#pragma unroll
  for (int k = 0; k < RW_VEC; ++k) {
    live[k] = old[k] ? 0 : 1;
    if (live[k] && vmax[k] > snap[k]) {
      // The reference's .at[r_txn].max(mode="drop"): txn -1 lands on
      // t_cap - 1, as its negative index normalises.
      const long d = scatter_index(txn[k], a.t_cap);
      if (d >= 0) a.hist[d] = 1;
    }
  }
  store_run<VEC>(a.r_txn, i, pad, txn);
  store_run<VEC>(a.r_live, i, pad, live);
  store_run<VEC>(a.r_slot, i, pad, slot);
}

struct IbFixArgs {
  int t_cap, r_pad, w_pad, u_pad;
  const int* hist;
  const int* r_txn;
  const int* r_live;
  const int* r_slot;
  const int* w_txn;
  const int* w_ok;
  const int* w_slot;
  int* cover;    // int32[2 * (u_pad + 1)], one half per round parity
  int* nconf;    // int32[2 * t_cap], the same
  int* changed;  // int32[2], one flag per round parity
  int* conf;     // out: int32[t_cap]
  int* rounds;   // out: int32[1]
};

__global__ void __launch_bounds__(FIX_THREADS)
    k_ib_fixpoint(IbFixArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long gtid = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  const long cov_n = a.u_pad + 1L;
  const long t_cap = a.t_cap;
  // Round r works on the buffers of parity r & 1; round 1's are filled
  // here.  Each round recomputes from the history-only baseline (a
  // conflict inferred from a writer that later turns out conflicted must
  // be retractable).
  for (long t = gtid; t < t_cap; t += gstride) {
    const int h = __ldg(a.hist + t);
    a.conf[t] = h;
    a.nconf[t_cap + t] = h;
  }
  for (long u = gtid; u < cov_n; u += gstride) a.cover[cov_n + u] = INF_I32;
  grid.sync();
  // Jacobi on the lower-triangular system settles one more txn of the
  // batch order per round at the least, so t_cap + 1 rounds always
  // suffice; the cap only keeps a fault from spinning the card forever.
  int rounds = 0;
  while (rounds <= a.t_cap) {
    ++rounds;
    const int cur = rounds & 1;
    int* cover = a.cover + cur * cov_n;
    int* nconf = a.nconf + cur * t_cap;
    if (gtid == 0) a.changed[cur] = 0;
    for (long w = gtid; w < a.w_pad; w += gstride) {
      const int wt = __ldg(a.w_txn + w);
      if (__ldg(a.w_ok + w) && !a.conf[clampi(wt, 0, a.t_cap - 1)])
        atomicMin(&cover[__ldg(a.w_slot + w)], wt);
    }
    grid.sync();
    for (long r = gtid; r < a.r_pad; r += gstride) {
      const int rt = __ldg(a.r_txn + r);
      if (__ldg(a.r_live + r) && cover[__ldg(a.r_slot + r)] < rt) {
        const long d = scatter_index(rt, t_cap);
        if (d >= 0) nconf[d] = 1;
      }
    }
    grid.sync();
    int* next_cover = a.cover + (1 - cur) * cov_n;
    int* next_nconf = a.nconf + (1 - cur) * t_cap;
    bool ch = false;
    for (long t = gtid; t < t_cap; t += gstride) {
      const int v = nconf[t];
      if (v != a.conf[t]) {
        a.conf[t] = v;
        ch = true;
      }
      next_nconf[t] = __ldg(a.hist + t);
    }
    for (long u = gtid; u < cov_n; u += gstride) next_cover[u] = INF_I32;
    if (__any_sync(0xffffffffu, ch) && (threadIdx.x & 31) == 0)
      a.changed[cur] = 1;
    grid.sync();
    if (*(volatile int*)&a.changed[cur] == 0) break;
  }
  if (gtid == 0 && a.rounds != nullptr) a.rounds[0] = rounds;
}

__global__ void k_codes(int t_cap, int w_pad, const int* __restrict__ scal,
                        const int* __restrict__ too_old,
                        const int* __restrict__ conf,
                        const int* __restrict__ w_txn,
                        int8_t* __restrict__ codes, int* __restrict__ w_ins) {
  const int n_t = scal[3];
  const int n_w = scal[2];
  long n = t_cap > w_pad ? t_cap : w_pad;
  GRID_STRIDE(i, n) {
    if (i < t_cap) {
      int c = i >= n_t ? -1 : (too_old[i] ? 1 : (conf[i] ? 0 : 2));
      codes[i] = (int8_t)c;
    }
    if (i < w_pad) {
      int tc = clampi(w_txn[i], 0, t_cap - 1);
      bool surv = tc < n_t && !too_old[tc] && !conf[tc];
      w_ins[i] = (i < n_w && surv) ? 1 : 0;
    }
  }
}

// ------------------------------------------------- general interval step
__global__ void k_gen_txn(int t_cap, const int* __restrict__ t_snap,
                          const int* __restrict__ t_has_reads,
                          const int* __restrict__ t_valid,
                          const int* __restrict__ oldest_rel,
                          int* __restrict__ too_old) {
  const int oldest = oldest_rel[0];
  GRID_STRIDE(t, t_cap) {
    too_old[t] = (t_valid[t] && t_has_reads[t] && t_snap[t] < oldest) ? 1 : 0;
  }
}

__global__ void k_gen_rw(int r_cap, int w_cap, int t_cap,
                         const int* __restrict__ r_txn,
                         const int* __restrict__ r_valid,
                         const int* __restrict__ w_txn,
                         const int* __restrict__ w_valid,
                         const int* __restrict__ too_old,
                         const int* __restrict__ t_snap,
                         const int* __restrict__ vmax,
                         int* __restrict__ r_live, int* __restrict__ hist,
                         int* __restrict__ w_ok) {
  long n = r_cap > w_cap ? r_cap : w_cap;
  GRID_STRIDE(i, n) {
    if (i < r_cap) {
      int rt = r_txn[i];
      int tc = clampi(rt, 0, t_cap - 1);
      bool live = r_valid[i] && !too_old[tc];
      r_live[i] = live ? 1 : 0;
      if (live && vmax[i] > t_snap[tc]) {
        long d = scatter_index(rt, t_cap);
        if (d >= 0) hist[d] = 1;
      }
    }
    if (i < w_cap) {
      int tc = clampi(w_txn[i], 0, t_cap - 1);
      w_ok[i] = (w_valid[i] && !too_old[tc]) ? 1 : 0;
    }
  }
}

__global__ void k_gen_codes(int t_cap, int w_cap,
                            const int* __restrict__ t_valid,
                            const int* __restrict__ too_old,
                            const int* __restrict__ conf,
                            const int* __restrict__ w_txn,
                            const int* __restrict__ w_valid,
                            int8_t* __restrict__ codes,
                            int* __restrict__ w_ins) {
  long n = t_cap > w_cap ? t_cap : w_cap;
  GRID_STRIDE(i, n) {
    if (i < t_cap) {
      int c = !t_valid[i] ? -1 : (too_old[i] ? 1 : (conf[i] ? 0 : 2));
      codes[i] = (int8_t)c;
    }
    if (i < w_cap) {
      int tc = clampi(w_txn[i], 0, t_cap - 1);
      bool surv = t_valid[tc] && !too_old[tc] && !conf[tc];
      w_ins[i] = (w_valid[i] && surv) ? 1 : 0;
    }
  }
}

#define S(stream) (cudaStream_t)(stream)
#define RET return (int)cudaGetLastError()

extern "C" int ib_txn_prep(int t_cap, int r_pad, int w_pad,
                           const void* r_start, const void* w_start,
                           const void* t_snap, const void* t_flags,
                           const void* scal, void* too_old, void* hist_r,
                           void* hist_w, void* stream) {
  k_txn_prep<<<blocks_for(t_cap, THREADS), THREADS, 0, S(stream)>>>(
      t_cap, r_pad, w_pad, (const int*)r_start, (const int*)w_start,
      (const int*)t_snap, (const uint8_t*)t_flags, (const int*)scal,
      (int*)too_old, (int*)hist_r, (int*)hist_w);
  RET;
}

// One launch: ceil(r_pad / RW_ITEMS) read blocks, then ceil(w_pad /
// RW_ITEMS) write blocks (at least one block in all).
extern "C" int ib_rw_prep(int r_pad, int w_pad, int t_cap, int u_pad,
                          const void* r_uid, const void* r_cnt,
                          const void* w_uid, const void* w_cnt,
                          const void* too_old, const void* t_snap,
                          const void* scal, const void* vmax_u, void* r_txn,
                          void* r_live, void* r_slot, void* hist, void* w_txn,
                          void* w_ok, void* w_slot, void* stream) {
  RwArgs a{r_pad, w_pad, t_cap, u_pad,
           (const int*)r_uid, (const int*)r_cnt, (const int*)w_uid,
           (const int*)w_cnt, (const int*)too_old, (const int*)t_snap,
           (const int*)scal, (const int*)vmax_u, (int*)r_txn, (int*)r_live,
           (int*)r_slot, (int*)hist, (int*)w_txn, (int*)w_ok, (int*)w_slot};
  const long read_blocks = ((long)r_pad + RW_ITEMS - 1) / RW_ITEMS;
  const long write_blocks = ((long)w_pad + RW_ITEMS - 1) / RW_ITEMS;
  const long blocks = read_blocks + write_blocks > 0
                          ? read_blocks + write_blocks : 1;
  const void* quads[] = {r_uid, r_cnt, w_uid, w_cnt, r_txn,
                         r_live, r_slot, w_txn, w_ok, w_slot};
  bool vec = true;
  for (const void* p : quads) vec = vec && (uintptr_t)p % 16 == 0;
  if (vec)
    k_rw_prep<true><<<(unsigned)blocks, THREADS, 0, S(stream)>>>(
        a, (int)read_blocks);
  else
    k_rw_prep<false><<<(unsigned)blocks, THREADS, 0, S(stream)>>>(
        a, (int)read_blocks);
  RET;
}

extern "C" int ib_fixpoint(int t_cap, int r_pad, int w_pad, int u_pad,
                           const void* hist, const void* r_txn,
                           const void* r_live, const void* r_slot,
                           const void* w_txn, const void* w_ok,
                           const void* w_slot, void* cover, void* nconf,
                           void* changed, void* conf, void* rounds_out,
                           void* stream) {
  IbFixArgs a;
  a.t_cap = t_cap;
  a.r_pad = r_pad;
  a.w_pad = w_pad;
  a.u_pad = u_pad;
  a.hist = (const int*)hist;
  a.r_txn = (const int*)r_txn;
  a.r_live = (const int*)r_live;
  a.r_slot = (const int*)r_slot;
  a.w_txn = (const int*)w_txn;
  a.w_ok = (const int*)w_ok;
  a.w_slot = (const int*)w_slot;
  a.cover = (int*)cover;
  a.nconf = (int*)nconf;
  a.changed = (int*)changed;
  a.conf = (int*)conf;
  a.rounds = (int*)rounds_out;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_ib_fixpoint, FIX_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm > FIX_BLOCKS_PER_SM) per_sm = FIX_BLOCKS_PER_SM;
  long work = u_pad + 1L;
  if (r_pad > work) work = r_pad;
  if (w_pad > work) work = w_pad;
  if (t_cap > work) work = t_cap;
  long want = (work + FIX_THREADS - 1) / FIX_THREADS;
  long most = (long)sms * (per_sm > 0 ? per_sm : 1);
  int grid = (int)(want < most ? want : most);
  if (grid < 1) grid = 1;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)k_ib_fixpoint, dim3(grid),
                                    dim3(FIX_THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int ib_codes(int t_cap, int w_pad, const void* scal,
                        const void* too_old, const void* conf,
                        const void* w_txn, void* codes, void* w_ins,
                        void* stream) {
  long n = t_cap > w_pad ? t_cap : w_pad;
  k_codes<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      t_cap, w_pad, (const int*)scal, (const int*)too_old, (const int*)conf,
      (const int*)w_txn, (int8_t*)codes, (int*)w_ins);
  RET;
}

extern "C" int ig_txn(int t_cap, const void* t_snap, const void* t_has_reads,
                      const void* t_valid, const void* oldest_rel,
                      void* too_old, void* stream) {
  k_gen_txn<<<blocks_for(t_cap, THREADS), THREADS, 0, S(stream)>>>(
      t_cap, (const int*)t_snap, (const int*)t_has_reads,
      (const int*)t_valid, (const int*)oldest_rel, (int*)too_old);
  RET;
}

extern "C" int ig_rw(int r_cap, int w_cap, int t_cap, const void* r_txn,
                     const void* r_valid, const void* w_txn,
                     const void* w_valid, const void* too_old,
                     const void* t_snap, const void* vmax, void* r_live,
                     void* hist, void* w_ok, void* stream) {
  long n = r_cap > w_cap ? r_cap : w_cap;
  k_gen_rw<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      r_cap, w_cap, t_cap, (const int*)r_txn, (const int*)r_valid,
      (const int*)w_txn, (const int*)w_valid, (const int*)too_old,
      (const int*)t_snap, (const int*)vmax, (int*)r_live, (int*)hist,
      (int*)w_ok);
  RET;
}

extern "C" int ig_codes(int t_cap, int w_cap, const void* t_valid,
                        const void* too_old, const void* conf,
                        const void* w_txn, const void* w_valid, void* codes,
                        void* w_ins, void* stream) {
  long n = t_cap > w_cap ? t_cap : w_cap;
  k_gen_codes<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      t_cap, w_cap, (const int*)t_valid, (const int*)too_old,
      (const int*)conf, (const int*)w_txn, (const int*)w_valid,
      (int8_t*)codes, (int*)w_ins);
  RET;
}
