// segtree: the general step's Jacobi intra-batch fixpoint over interval
// structures, as one persistent kernel that loops on the device.
//
// Replaces (foundationdb_tpu): conflict/fused.py:531-547, the
// lax.while_loop whose body is ops/segtree.py:28 interval_min_cover
// (per-level min-updates of <= 2 nodes per interval, then the top-down
// pushdown), :61 build_min_table (the doubling range-max table over the
// negated cover) and :71 range_min, followed by the scatter-max of the
// intra-batch hits over the history-only baseline and the changed test.
//
// Bound on the card: bytes per round -- the tree (2U int32) cleared and
// updated, the min table ((LOG+1) * U int32) written level by level and
// read, the reads' and writes' columns read once; the round count is the
// batch's chain depth (typically 2-3).
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel, grid no
// larger than the blocks that fit on the card at once) whose blocks loop
// over the rounds together, separated by grid-wide barriers
// (cooperative_groups grid.sync()).  A round is: clear the tree and reset
// the next conflicts to the history baseline | min-update the tree from
// every active write (atomicMin, a thread per interval walking its levels)
// | each leaf takes the min over its ancestors, the pushdown's result,
// written negated as table level 0 | one barrier per table level | each
// live read's range min over its gap span, scatter-maxed into the next
// conflicts | compare and copy, raising a changed flag.  The host never
// reads a flag per round; the loop is capped at t_cap + 1 rounds (Jacobi on
// the lower-triangular system settles at least one more txn per round)
// and the round count is written out.  Scratch (tree, table, the next
// conflicts, two changed flags) is allocated once per step by the wrapper
// and reused by every round.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define FIXG_THREADS 256

struct FixArgs {
  int t_cap, r_cap, w_cap, log_u;
  const int* hist;
  const int* r_txn;
  const int* r_live;
  const int* r_pb;
  const int* r_pe;
  const int* w_txn;
  const int* w_ok;
  const int* w_pb;
  const int* w_pe;
  int* tree;     // int32[2U]
  int* table;    // int32[(LOG+1) * U]
  int* nconf;    // int32[t_cap]
  int* changed;  // int32[2], one flag per round parity
  int* conf;     // out: int32[t_cap]
  int* rounds;   // out: int32[1]
  int* rounds_acc;  // optional: += rounds
};

__global__ void __launch_bounds__(FIXG_THREADS) k_fixpoint(FixArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long gtid = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  const int u = 1 << a.log_u;
  const int levels = a.log_u + 1;
  for (long t = gtid; t < a.t_cap; t += gstride) a.conf[t] = a.hist[t];
  grid.sync();
  int rounds = 0;
  while (rounds <= a.t_cap) {
    ++rounds;
    const int cur = rounds & 1;
    // Clear the tree; the next conflicts restart from the history-only
    // baseline (a conflict inferred from a writer that later turns out
    // conflicted must be retractable).
    for (long i = gtid; i < 2L * u; i += gstride) a.tree[i] = INF_I32;
    for (long t = gtid; t < a.t_cap; t += gstride) a.nconf[t] = a.hist[t];
    // This round's flag was last read two rounds ago, behind barriers
    // every thread has passed since; the previous round's flag may still
    // be being read.
    if (gtid == 0) a.changed[cur] = 0;
    grid.sync();
    // interval_min_cover, update half: writes of txns not conflicted.
    for (long w = gtid; w < a.w_cap; w += gstride) {
      int wt = a.w_txn[w];
      int l = a.w_pb[w], r = a.w_pe[w];
      if (!a.w_ok[w] || a.conf[clampi(wt, 0, a.t_cap - 1)] || !(l < r))
        continue;
      int li = clampi(l, 0, u) + u;
      int ri = clampi(r, 0, u) + u;
      for (int lvl = 0; lvl < levels && li < ri; ++lvl) {
        if (li & 1) atomicMin(&a.tree[li], wt);
        if (ri & 1) atomicMin(&a.tree[ri - 1], wt);
        li = (li + (li & 1)) >> 1;
        ri = (ri - (ri & 1)) >> 1;
      }
    }
    grid.sync();
    // Pushdown: a leaf's cover is the min over it and its ancestors;
    // table level 0 holds it negated (build_min_table).
    for (long g = gtid; g < u; g += gstride) {
      int m = INF_I32;
      for (long node = g + u; node >= 1; node >>= 1) {
        int v = a.tree[node];
        m = v < m ? v : m;
      }
      a.table[g] = -m;
    }
    grid.sync();
    for (int j = 1; j < levels; ++j) {
      const int* prev = a.table + (long)(j - 1) * u;
      int* row = a.table + (long)j * u;
      const long shift = 1L << (j - 1);
      for (long i = gtid; i < u; i += gstride) {
        int x = prev[i];
        int y = i + shift < u ? prev[i + shift] : NEG_INF_I32;
        row[i] = x > y ? x : y;
      }
      grid.sync();
    }
    // range_min over each live read's gap span; a hit is an earlier
    // surviving writer.
    for (long r = gtid; r < a.r_cap; r += gstride) {
      if (!a.r_live[r]) continue;
      int rt = a.r_txn[r];
      int m = -range_max(a.table, u, a.r_pb[r], a.r_pe[r]);
      if (m < rt) {
        long d = scatter_index(rt, a.t_cap);
        if (d >= 0) a.nconf[d] = 1;
      }
    }
    grid.sync();
    bool ch = false;
    for (long t = gtid; t < a.t_cap; t += gstride) {
      int v = a.nconf[t];
      if (v != a.conf[t]) {
        a.conf[t] = v;
        ch = true;
      }
    }
    if (ch) a.changed[cur] = 1;
    grid.sync();
    if (*(volatile int*)&a.changed[cur] == 0) break;
  }
  if (gtid == 0) {
    a.rounds[0] = rounds;
    if (a.rounds_acc != nullptr) a.rounds_acc[0] += rounds;
  }
}

extern "C" int sg_fixpoint(int t_cap, int r_cap, int w_cap, int log_u,
                           const void* hist, const void* r_txn,
                           const void* r_live, const void* r_pb,
                           const void* r_pe, const void* w_txn,
                           const void* w_ok, const void* w_pb,
                           const void* w_pe, void* tree, void* table,
                           void* nconf, void* changed, void* conf,
                           void* rounds, void* rounds_acc, void* stream) {
  FixArgs a;
  a.t_cap = t_cap;
  a.r_cap = r_cap;
  a.w_cap = w_cap;
  a.log_u = log_u;
  a.hist = (const int*)hist;
  a.r_txn = (const int*)r_txn;
  a.r_live = (const int*)r_live;
  a.r_pb = (const int*)r_pb;
  a.r_pe = (const int*)r_pe;
  a.w_txn = (const int*)w_txn;
  a.w_ok = (const int*)w_ok;
  a.w_pb = (const int*)w_pb;
  a.w_pe = (const int*)w_pe;
  a.tree = (int*)tree;
  a.table = (int*)table;
  a.nconf = (int*)nconf;
  a.changed = (int*)changed;
  a.conf = (int*)conf;
  a.rounds = (int*)rounds;
  a.rounds_acc = (int*)rounds_acc;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_fixpoint,
                                                      FIXG_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  long work = 2L << log_u;
  if (r_cap > work) work = r_cap;
  if (w_cap > work) work = w_cap;
  if (t_cap > work) work = t_cap;
  long want = (work + FIXG_THREADS - 1) / FIXG_THREADS;
  long most = (long)sms * (per_sm > 0 ? per_sm : 1);
  int grid = (int)(want < most ? want : most);
  if (grid < 1) grid = 1;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)k_fixpoint, dim3(grid),
                                    dim3(FIXG_THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
