// intra_batch: the per-batch transaction logic of the compact point step.
//
// Replaces (foundationdb_tpu, conflict/fused.py make_resolve_step_compact):
//   ib_txn_prep    -- :324-330 too-old (SkipList.cpp:819) and the histogram
//                     halves of the r_txn / w_txn rank_counts;
//   ib_read_prep   -- :332-361 live reads, the history verdict of each read
//                     from the unique-key maxima, scatter-max per txn;
//   ib_write_prep  -- :367-371 the writers' txn, base eligibility and slot;
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
// and written once).  The fixpoint is latency-bound: one persistent CTA
// repeats a pass over writes, reads and txns per round, for as many rounds
// as the batch's chain depth.
//
// Design: the fixpoint is one block of 1024 threads that loops with
// __syncthreads() and ends when __syncthreads_or() sees no txn change, so
// the host never synchronises per round.  Its global scratch (cover,
// next-conflict) is private to the launch; a barrier orders every phase.
#include "common.cuh"

#define FIX_THREADS 1024

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

__global__ void k_read_prep(int r_pad, int t_cap, int u_pad,
                            const int* __restrict__ r_uid,
                            const int* __restrict__ r_cnt,
                            const int* __restrict__ too_old,
                            const int* __restrict__ t_snap,
                            const int* __restrict__ scal,
                            const int* __restrict__ vmax_u,
                            int* __restrict__ r_txn, int* __restrict__ r_live,
                            int* __restrict__ r_slot,
                            int* __restrict__ hist_conf) {
  const int n_r = scal[1];
  GRID_STRIDE(r, r_pad) {
    int rt = r_cnt[r] - 1;
    int tc = clampi(rt, 0, t_cap - 1);
    bool live = r < n_r && !too_old[tc];
    int slot = clampi(r_uid[r], 0, u_pad - 1);
    r_txn[r] = rt;
    r_live[r] = live ? 1 : 0;
    r_slot[r] = slot;
    if (live && vmax_u[slot] > t_snap[tc]) {
      long d = scatter_index(rt, t_cap);
      if (d >= 0) hist_conf[d] = 1;
    }
  }
}

__global__ void k_write_prep(int w_pad, int t_cap, int u_pad,
                             const int* __restrict__ w_uid,
                             const int* __restrict__ w_cnt,
                             const int* __restrict__ too_old,
                             const int* __restrict__ scal,
                             int* __restrict__ w_txn, int* __restrict__ w_ok,
                             int* __restrict__ w_slot) {
  const int n_w = scal[2];
  GRID_STRIDE(w, w_pad) {
    int wt = w_cnt[w] - 1;
    int tc = clampi(wt, 0, t_cap - 1);
    w_txn[w] = wt;
    w_ok[w] = (w < n_w && !too_old[tc]) ? 1 : 0;
    w_slot[w] = clampi(w_uid[w], 0, u_pad - 1);
  }
}

__global__ void __launch_bounds__(FIX_THREADS)
    k_fixpoint(int t_cap, int r_pad, int w_pad, int u_pad,
               const int* __restrict__ hist, const int* __restrict__ r_txn,
               const int* __restrict__ r_live, const int* __restrict__ r_slot,
               const int* __restrict__ w_txn, const int* __restrict__ w_ok,
               const int* __restrict__ w_slot, int* cover, int* nconf,
               int* conf, int* rounds_out) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int t = tid; t < t_cap; t += nt) conf[t] = hist[t];
  __syncthreads();
  // Jacobi on the lower-triangular system settles one more txn of the
  // batch order per round at the least, so t_cap + 1 rounds always
  // suffice; the cap only keeps a fault from spinning the card forever.
  int rounds = 0;
  while (rounds <= t_cap) {
    ++rounds;
    // Each round recomputes from the history-only baseline (a conflict
    // inferred from a writer that later turns out conflicted must be
    // retractable).
    for (int u = tid; u <= u_pad; u += nt) cover[u] = INF_I32;
    for (int t = tid; t < t_cap; t += nt) nconf[t] = hist[t];
    __syncthreads();
    for (int w = tid; w < w_pad; w += nt) {
      int wt = w_txn[w];
      if (w_ok[w] && !conf[clampi(wt, 0, t_cap - 1)])
        atomicMin(&cover[w_slot[w]], wt);
    }
    __syncthreads();
    for (int r = tid; r < r_pad; r += nt) {
      int rt = r_txn[r];
      if (r_live[r] && cover[r_slot[r]] < rt) {
        long d = scatter_index(rt, t_cap);
        if (d >= 0) nconf[d] = 1;
      }
    }
    __syncthreads();
    int changed = 0;
    for (int t = tid; t < t_cap; t += nt) {
      int v = nconf[t];
      if (v != conf[t]) {
        changed = 1;
        conf[t] = v;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  if (tid == 0 && rounds_out != nullptr) rounds_out[0] = rounds;
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

extern "C" int ib_read_prep(int r_pad, int t_cap, int u_pad, const void* r_uid,
                            const void* r_cnt, const void* too_old,
                            const void* t_snap, const void* scal,
                            const void* vmax_u, void* r_txn, void* r_live,
                            void* r_slot, void* hist_conf, void* stream) {
  k_read_prep<<<blocks_for(r_pad, THREADS), THREADS, 0, S(stream)>>>(
      r_pad, t_cap, u_pad, (const int*)r_uid, (const int*)r_cnt,
      (const int*)too_old, (const int*)t_snap, (const int*)scal,
      (const int*)vmax_u, (int*)r_txn, (int*)r_live, (int*)r_slot,
      (int*)hist_conf);
  RET;
}

extern "C" int ib_write_prep(int w_pad, int t_cap, int u_pad,
                             const void* w_uid, const void* w_cnt,
                             const void* too_old, const void* scal,
                             void* w_txn, void* w_ok, void* w_slot,
                             void* stream) {
  k_write_prep<<<blocks_for(w_pad, THREADS), THREADS, 0, S(stream)>>>(
      w_pad, t_cap, u_pad, (const int*)w_uid, (const int*)w_cnt,
      (const int*)too_old, (const int*)scal, (int*)w_txn, (int*)w_ok,
      (int*)w_slot);
  RET;
}

extern "C" int ib_fixpoint(int t_cap, int r_pad, int w_pad, int u_pad,
                           const void* hist, const void* r_txn,
                           const void* r_live, const void* r_slot,
                           const void* w_txn, const void* w_ok,
                           const void* w_slot, void* cover, void* nconf,
                           void* conf, void* rounds_out, void* stream) {
  k_fixpoint<<<1, FIX_THREADS, 0, S(stream)>>>(
      t_cap, r_pad, w_pad, u_pad, (const int*)hist, (const int*)r_txn,
      (const int*)r_live, (const int*)r_slot, (const int*)w_txn,
      (const int*)w_ok, (const int*)w_slot, (int*)cover, (int*)nconf,
      (int*)conf, (int*)rounds_out);
  RET;
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
