// rank_scan: histogram ranks, inclusive scans and masked row compaction,
// and the sort-free delta insert and the merge built from them.
//
// Replaces (foundationdb_tpu):
//   rs_hist            -- the histogram half of ops/digest.py:221 rank_count
//                         (its cumsum is rs_scan);
//   rs_scan            -- every jnp.cumsum of conflict/fused.py
//                         (:196, :219, :634, :638, :662) and rank_count's;
//   rs_compact         -- the order-preserving rank scatters of fused.py
//                         (:198-204, :665-672, the latter with the rebase);
//   pi_*               -- conflict/fused.py:157-247 _point_insert;
//   mg_*               -- conflict/fused.py:607-686 make_merge_step.merge.
//
// Bound on the card: bytes.  A scan reads n and writes n int32; a
// compaction reads the mask, the ranks and the kept rows once and writes
// them once; insert and merge are sums of such passes plus binary searches
// whose probes read one 32-byte row each.
//
// Design: a single-pass scan with decoupled look-back (one launch for any
// n, each element read once and written once; below); histograms by
// warp-aggregated atomicAdd (positions at or past the end, which the scan
// never reads, are skipped); every scatter of the reference becomes a
// guarded row store with JAX's drop semantics (common.cuh).  Insert and
// merge write into scratch or freshly filled buffers, never into the
// arrays they are still reading: the merge places into the s_cap scratch
// before it refills the base, and the insert commits its result into the
// delta only when it did not overflow (the reference's keep-old-state).
#include "common.cuh"

// ---------------------------------------------------------------- rank
__global__ void k_hist(const int* __restrict__ pos, long n, int out_len,
                       int* __restrict__ hist) {
  // Positions >= out_len are never counted (the scan reads hist[:out_len]).
  GRID_STRIDE(i, n) {
    int p = clampi(pos[i], 0, out_len);
    if (p < out_len) count_at(hist, p);
  }
}

// ---------------------------------------------------------------- scan
// Single-pass inclusive scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVR-2016-002).
// A tile is 8 warps x 1,024 elements; each warp reads its 1,024 as eight
// coalesced rounds of one 128-bit load per lane, all issued before the
// first shuffle, and scans them in registers.  Tiles are numbered by an
// atomicAdd ticket, so a tile only ever waits on tiles that already hold
// an SM.  Each tile publishes its aggregate, then its inclusive prefix, in
// a 64-bit descriptor (status in the high word, value in the low word, one
// 64-bit store, so a reader never sees a status beside a stale value); its
// warp 0 sums its predecessors' values 32 descriptors at a time until it
// meets a prefix.  The descriptor carries its own value and nothing else
// is published through it, so its stores and loads are relaxed (strong,
// gpu scope): a release store would fence every publish for no reader.
// Sums wrap in 32-bit two's complement, as torch.cumsum(dtype=int32)
// does.  Timed on the H100 against tiles of 4,096 and 16,384 elements,
// look-back windows of 128 and 256 descriptors (the latter block-wide),
// loads issued before the ticket returns and release stores, this shape
// was the fastest from 2^17 to 2^24 elements.
#define SCAN_THREADS 256
#define SCAN_STEPS 8  // 128-bit loads per lane
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_VEC 4  // int32 per 128-bit load
#define SCAN_WARP_ITEMS (32 * SCAN_VEC * SCAN_STEPS)
#define SCAN_TILE (SCAN_WARPS * SCAN_WARP_ITEMS)  // 8192: ops/scan.py's

#define SCAN_AGGREGATE 1ull  // descriptor status; 0 = nothing published
#define SCAN_PREFIX 2ull

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v,
                                                        int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp 0 of tile `tile` (> 0): sums its predecessors' published values
// back to the nearest inclusive prefix and publishes the tile's own;
// returns the tile's exclusive prefix to every thread.
__device__ __forceinline__ unsigned scan_look_back(unsigned long long* desc,
                                                   long tile,
                                                   unsigned aggregate,
                                                   unsigned* s_prefix) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    unsigned prefix = 0u;
    for (long last = tile - 1;; last -= 32) {
      const long j = last - lane;  // lane 0: the nearest predecessor
      unsigned long long d = SCAN_PREFIX << 32;  // before tile 0: prefix 0
      if (j >= 0) {
        do {
          d = load_relaxed(desc + j);
        } while ((d >> 32) == 0);
      }
      const unsigned has_prefix = __ballot_sync(0xffffffffu,
                                                (d >> 32) == SCAN_PREFIX);
      const int stop = has_prefix ? __ffs(has_prefix) - 1 : 31;
      prefix += warp_sum(lane <= stop ? (unsigned)d : 0u);
      if (has_prefix) break;
    }
    if (lane == 0) {
      store_relaxed(desc + tile, (SCAN_PREFIX << 32) | (prefix + aggregate));
      *s_prefix = prefix;
    }
  }
  __syncthreads();
  return *s_prefix;
}

// VEC: `in` and `out` are 16-byte aligned, so whole quads move as int4.
// scratch: uint64[1 + tiles], zeroed: the ticket, then the descriptors.
template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS)
    k_scan(const int* __restrict__ in, int* __restrict__ out, long n,
           unsigned long long* __restrict__ scratch) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_warp[SCAN_WARPS];
  __shared__ unsigned s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* desc = scratch + 1;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const long tile = s_tile;
  const long base = tile * SCAN_TILE + (long)warp * SCAN_WARP_ITEMS;
  const bool full = VEC && (tile + 1) * SCAN_TILE <= n;
  unsigned x[SCAN_STEPS][SCAN_VEC];
  if (full) {  // every load issued before the first shuffle
#pragma unroll
    for (int s = 0; s < SCAN_STEPS; ++s) {
      const int4 q = *reinterpret_cast<const int4*>(
          in + base + (long)(s * 32 + lane) * SCAN_VEC);
      x[s][0] = q.x; x[s][1] = q.y; x[s][2] = q.z; x[s][3] = q.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < SCAN_STEPS; ++s) {
      const long i0 = base + (long)(s * 32 + lane) * SCAN_VEC;
#pragma unroll
      for (int k = 0; k < SCAN_VEC; ++k)
        x[s][k] = i0 + k < n ? (unsigned)in[i0 + k] : 0u;
    }
  }
  unsigned carry = 0u;  // the warp's sum of its earlier steps
#pragma unroll
  for (int s = 0; s < SCAN_STEPS; ++s) {
#pragma unroll
    for (int k = 1; k < SCAN_VEC; ++k) x[s][k] += x[s][k - 1];
    const unsigned incl = warp_inclusive_scan(x[s][SCAN_VEC - 1], lane);
    const unsigned excl = incl - x[s][SCAN_VEC - 1] + carry;
#pragma unroll
    for (int k = 0; k < SCAN_VEC; ++k) x[s][k] += excl;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  unsigned add = 0u, aggregate = 0u;  // this warp's offset, the tile's sum
#pragma unroll
  for (int w = 0; w < SCAN_WARPS; ++w) {
    const unsigned v = s_warp[w];
    if (w < warp) add += v;
    aggregate += v;
  }
  if (tile == 0) {
    if (threadIdx.x == 0) store_relaxed(desc, (SCAN_PREFIX << 32) | aggregate);
  } else {
    if (threadIdx.x == 0)
      store_relaxed(desc + tile, (SCAN_AGGREGATE << 32) | aggregate);
    add += scan_look_back(desc, tile, aggregate, &s_prefix);
  }
  if (full) {
#pragma unroll
    for (int s = 0; s < SCAN_STEPS; ++s)
      *reinterpret_cast<int4*>(out + base +
                               (long)(s * 32 + lane) * SCAN_VEC) =
          make_int4((int)(x[s][0] + add), (int)(x[s][1] + add),
                    (int)(x[s][2] + add), (int)(x[s][3] + add));
  } else {
#pragma unroll
    for (int s = 0; s < SCAN_STEPS; ++s) {
      const long i0 = base + (long)(s * 32 + lane) * SCAN_VEC;
#pragma unroll
      for (int k = 0; k < SCAN_VEC; ++k)
        if (i0 + k < n) out[i0 + k] = (int)(x[s][k] + add);
    }
  }
}

// ---------------------------------------------------------- compaction
// dst[incl[i]-1] = src[i] where keep[i]; values optionally rebased the way
// fused.py:669 does it: (v - rebase) wrapping in int32, then clamped
// below at NEG_INF+1.
__global__ void k_compact(long n, const int* __restrict__ keep,
                          const int* __restrict__ incl,
                          const uint32_t* __restrict__ src_rows,
                          const int* __restrict__ src_v,
                          uint32_t* __restrict__ dst_rows,
                          int* __restrict__ dst_v, long n_dst, int rebase,
                          int do_rebase) {
  GRID_STRIDE(i, n) {
    if (!keep[i]) continue;
    long d = scatter_index((long)incl[i] - 1, n_dst);
    if (d < 0) continue;
    store_row(dst_rows, d, load_row(src_rows, i));
    if (src_v == nullptr) continue;  // rows only
    int v = src_v[i];
    if (do_rebase) {
      v = (int)((uint32_t)v - (uint32_t)rebase);
      v = v > NEG_INF_I32 + 1 ? v : NEG_INF_I32 + 1;
    }
    dst_v[d] = v;
  }
}

// ------------------------------------------------------- point insert
// m_valid[slot] = max over the writes at slot of w_ins, and with an owned
// mask (a key-range shard's, fused.py:175-177) only where the slot's key
// is owned.
__global__ void k_pi_mark(long w_pad, const int* __restrict__ w_uid,
                          const int* __restrict__ w_ins, int u_pad,
                          const int* __restrict__ u_own,
                          int* __restrict__ m_valid) {
  GRID_STRIDE(w, w_pad) {
    int slot = clampi(w_uid[w], 0, u_pad - 1);
    if (w_ins[w] && (u_own == nullptr || u_own[slot])) m_valid[slot] = 1;
  }
}

__global__ void k_pi_probe(const uint32_t* __restrict__ dk, int dcap, int nd,
                           const int* __restrict__ dv,
                           const int* __restrict__ dsize,
                           const uint32_t* __restrict__ u_b,
                           const uint32_t* __restrict__ u_e,
                           const int* __restrict__ m_valid, long u_pad,
                           int* __restrict__ cont_v,
                           int* __restrict__ present_end,
                           int* __restrict__ hist_b,
                           int* __restrict__ hist_e) {
  const int ds = dsize[0];
  GRID_STRIDE(u, u_pad) {
    bool m = m_valid[u] != 0;
    Row mb = m ? load_row(u_b, u) : max_row();
    Row me = m ? load_row(u_e, u) : max_row();
    int slot = search_rows(dk, dcap, nd, me, false) - 1;
    cont_v[u] = dv[clampi(slot, 0, dcap - 1)];
    int p = search_rows(dk, dcap, nd, me, true);
    Row g = load_row(dk, p < dcap - 1 ? p : dcap - 1);
    present_end[u] = (row_eq(g, me) && p < ds) ? 1 : 0;
    int pb = clampi(search_rows(dk, dcap, nd, mb, true), 0, dcap);
    int pe = clampi(p, 0, dcap);
    if (pb < dcap) count_at(hist_b, pb);
    if (pe < dcap) count_at(hist_e, pe);
  }
}

__global__ void k_pi_keep(int dcap, const int* __restrict__ dsize,
                          const int* __restrict__ cnt_b,
                          const int* __restrict__ cnt_e,
                          int* __restrict__ keep) {
  const int ds = dsize[0];
  GRID_STRIDE(i, dcap) { keep[i] = (i < ds && !(cnt_b[i] > cnt_e[i])) ? 1 : 0; }
}

__global__ void k_pi_il_valid(long u_pad, const int* __restrict__ m_valid,
                              const int* __restrict__ present_end,
                              int* __restrict__ il_valid) {
  GRID_STRIDE(u, u_pad) {
    int m = m_valid[u] != 0;
    il_valid[2 * u] = m;
    il_valid[2 * u + 1] = (m && !present_end[u]) ? 1 : 0;
  }
}

__global__ void k_pi_il_compact(long n2, const int* __restrict__ il_valid,
                                const int* __restrict__ nincl,
                                const uint32_t* __restrict__ u_b,
                                const uint32_t* __restrict__ u_e,
                                const int* __restrict__ cont_v,
                                const int* __restrict__ now_rel,
                                uint32_t* __restrict__ cnew_rows,
                                int* __restrict__ cnew_v) {
  const int now = now_rel[0];
  GRID_STRIDE(k, n2) {
    if (!il_valid[k]) continue;
    long d = scatter_index((long)nincl[k] - 1, n2);
    if (d < 0) continue;
    long u = k >> 1;
    bool is_end = (k & 1) != 0;
    store_row(cnew_rows, d, load_row(is_end ? u_e : u_b, u));
    cnew_v[d] = is_end ? cont_v[u] : now;
  }
}

__device__ __forceinline__ bool pi_overflow(const int* kincl, int dcap,
                                            const int* nincl, long n2,
                                            int* kept, int* newc) {
  *kept = kincl[dcap - 1];
  *newc = nincl[n2 - 1];
  return *kept + *newc > dcap;
}

__global__ void k_pi_scatter_old(int dcap, const int* __restrict__ kincl,
                                 const int* __restrict__ nincl, long n2,
                                 const int* __restrict__ cnt_o,
                                 const uint32_t* __restrict__ old_rows,
                                 const int* __restrict__ old_v,
                                 uint32_t* __restrict__ out_rows,
                                 int* __restrict__ out_v) {
  int kept, newc;
  bool ovf = pi_overflow(kincl, dcap, nincl, n2, &kept, &newc);
  if (ovf) return;
  GRID_STRIDE(i, dcap) {
    if (i >= kept) continue;
    long d = scatter_index(i + (long)cnt_o[i], dcap);
    if (d < 0) continue;
    store_row(out_rows, d, load_row(old_rows, i));
    out_v[d] = old_v[i];
  }
}

__global__ void k_pi_scatter_new(int dcap, const int* __restrict__ kincl,
                                 const int* __restrict__ nincl, long n2,
                                 const int* __restrict__ pos_l,
                                 const uint32_t* __restrict__ cnew_rows,
                                 const int* __restrict__ cnew_v,
                                 uint32_t* __restrict__ out_rows,
                                 int* __restrict__ out_v) {
  int kept, newc;
  bool ovf = pi_overflow(kincl, dcap, nincl, n2, &kept, &newc);
  if (ovf) return;
  GRID_STRIDE(k, n2) {
    if (k >= newc) continue;
    long d = scatter_index((long)pos_l[k] + k, dcap);
    if (d < 0) continue;
    store_row(out_rows, d, load_row(cnew_rows, k));
    out_v[d] = cnew_v[k];
  }
}

// Commits the insert into the delta in place, unless it overflowed, and
// writes flag / delta size / base size into the 12-byte verdict tail.
__global__ void k_pi_commit(int dcap, const int* __restrict__ kincl,
                            const int* __restrict__ nincl, long n2,
                            const uint32_t* __restrict__ out_rows,
                            const int* __restrict__ out_v,
                            uint32_t* __restrict__ dk, int* __restrict__ dv,
                            int* dsize, int* flag,
                            const int* __restrict__ bsize, int* tail) {
  int kept, newc;
  bool ovf = pi_overflow(kincl, dcap, nincl, n2, &kept, &newc);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int ds2 = ovf ? dsize[0] : kept + newc;
    int f2 = flag[0] | (ovf ? 1 : 0);
    dsize[0] = ds2;
    flag[0] = f2;
    if (tail != nullptr) {
      tail[0] = f2;
      tail[1] = ds2;
      tail[2] = bsize[0];
    }
  }
  if (ovf) return;
  GRID_STRIDE(i, dcap) {
    store_row(dk, i, load_row(out_rows, i));
    dv[i] = out_v[i];
  }
}

// --------------------------------------------------------------- merge
__global__ void k_mg_probe_delta(int dcap, const uint32_t* __restrict__ dk,
                                 const uint32_t* __restrict__ bk, int cap,
                                 int nb, const int* __restrict__ bv,
                                 const int* __restrict__ dv,
                                 const int* __restrict__ size,
                                 int* __restrict__ hist_l,
                                 int* __restrict__ hist_r,
                                 int* __restrict__ v_d,
                                 int* __restrict__ bbr) {
  const int sz = size[0];
  GRID_STRIDE(j, dcap) {
    Row q = load_row(dk, j);
    int pl = search_rows(bk, cap, nb, q, true);
    int pr = search_rows(bk, cap, nb, q, false);
    if (pl < cap) count_at(hist_l, pl);
    if (pr < cap) count_at(hist_r, pr);
    int b = bv[clampi(pr - 1, 0, cap - 1)];
    int d = dv[j];
    v_d[j] = d > b ? d : b;
    bbr[j] = pl < sz ? pl : sz;
  }
}

__global__ void k_mg_base(int cap, const uint32_t* __restrict__ bk,
                          const int* __restrict__ bv,
                          const uint32_t* __restrict__ dk,
                          const int* __restrict__ dv, int dcap,
                          const int* __restrict__ size,
                          const int* __restrict__ dsize,
                          const int* __restrict__ cnt_l,
                          const int* __restrict__ p, int* __restrict__ keep_b,
                          int* __restrict__ dup_b, int* __restrict__ v_b) {
  const int sz = size[0];
  const int ds = dsize[0];
  GRID_STRIDE(i, cap) {
    int b = bv[i];
    int d = dv[clampi(cnt_l[i] - 1, 0, dcap - 1)];
    v_b[i] = b > d ? b : d;
    int pi = p[i];
    bool dup = pi < ds &&
               row_eq(load_row(dk, pi < dcap - 1 ? pi : dcap - 1),
                      load_row(bk, i));
    dup_b[i] = dup ? 1 : 0;
    keep_b[i] = (i < sz && !dup) ? 1 : 0;
  }
}

__global__ void k_mg_place_base(int cap, const int* __restrict__ keep_b,
                                const int* __restrict__ kb_incl,
                                const int* __restrict__ p,
                                const int* __restrict__ dsize,
                                const uint32_t* __restrict__ bk,
                                const int* __restrict__ v_b, long s_cap,
                                uint32_t* __restrict__ s_rows,
                                int* __restrict__ sv) {
  const int ds = dsize[0];
  GRID_STRIDE(i, cap) {
    if (!keep_b[i]) continue;
    int before = p[i] < ds ? p[i] : ds;
    long d = scatter_index((long)kb_incl[i] - 1 + before, s_cap);
    if (d < 0) continue;
    store_row(s_rows, d, load_row(bk, i));
    sv[d] = v_b[i];
  }
}

__global__ void k_mg_place_delta(int dcap, const int* __restrict__ dsize,
                                 const int* __restrict__ bbr,
                                 const int* __restrict__ drop_prefix, int cap,
                                 const uint32_t* __restrict__ dk,
                                 const int* __restrict__ v_d, long s_cap,
                                 uint32_t* __restrict__ s_rows,
                                 int* __restrict__ sv) {
  const int ds = dsize[0];
  GRID_STRIDE(j, dcap) {
    if (j >= ds) continue;
    int b = bbr[j];
    int drops = b > 0 ? drop_prefix[clampi(b - 1, 0, cap - 1)] : 0;
    long d = scatter_index(j + (long)b - drops, s_cap);
    if (d < 0) continue;
    store_row(s_rows, d, load_row(dk, j));
    sv[d] = v_d[j];
  }
}

__global__ void k_mg_gc_mask(long s_cap, const int* __restrict__ kb_incl,
                             int cap, const int* __restrict__ dsize, int dcap,
                             const int* __restrict__ sv, int new_oldest,
                             int* __restrict__ keep_s) {
  const long m_size = (long)kb_incl[cap - 1] + clampi(dsize[0], 0, dcap);
  GRID_STRIDE(s, s_cap) {
    bool live = s < m_size;
    bool above = sv[s] >= new_oldest;
    bool prev = s == 0 ? true : sv[s - 1] >= new_oldest;
    keep_s[s] = (live && (s == 0 || above || prev)) ? 1 : 0;
  }
}

// The reset delta's covering boundary is the zero digest, or a key-range
// shard's lower split `first` (fused.py:679-683, dk0_first).
__global__ void k_mg_reset(int cap, uint32_t* __restrict__ bk,
                           int* __restrict__ bv, int dcap,
                           uint32_t* __restrict__ dk, int* __restrict__ dv,
                           const uint32_t* __restrict__ first) {
  long n = cap > dcap ? cap : dcap;
  GRID_STRIDE(i, n) {
    if (i < cap) {
      store_row(bk, i, max_row());
      bv[i] = NEG_INF_I32;
    }
    if (i < dcap) {
      Row r = max_row();
      if (i == 0) {
        if (first != nullptr) {
          r = load_row(first, 0);
        } else {
#pragma unroll
          for (int l = 0; l < 8; ++l) r.l[l] = 0u;
        }
      }
      store_row(dk, i, r);
      dv[i] = NEG_INF_I32;
    }
  }
}

__global__ void k_mg_finish(const int* __restrict__ ks_incl, long s_cap,
                            int cap, int* size, int* dsize, int* flag) {
  int final_size = ks_incl[s_cap - 1];
  flag[0] = flag[0] | (final_size > cap ? 1 : 0);
  size[0] = final_size < cap ? final_size : cap;
  dsize[0] = 1;
}

// ------------------------------------------------------------ launchers
#define S(stream) (cudaStream_t)(stream)
#define RET return (int)cudaGetLastError()

extern "C" int rs_hist(const void* pos, long n, int out_len, void* hist,
                       void* stream) {
  k_hist<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      (const int*)pos, n, out_len, (int*)hist);
  RET;
}

// One launch for any n: ceil(n / SCAN_TILE) tiles (at least one, so an
// empty scan is one launch too).
extern "C" int rs_scan(const void* in, void* out, long n, void* scratch,
                       void* stream) {
  const long tiles = n > 0 ? (n + SCAN_TILE - 1) / SCAN_TILE : 1;
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (vec)
    k_scan<true><<<(unsigned)tiles, SCAN_THREADS, 0, S(stream)>>>(
        (const int*)in, (int*)out, n, (unsigned long long*)scratch);
  else
    k_scan<false><<<(unsigned)tiles, SCAN_THREADS, 0, S(stream)>>>(
        (const int*)in, (int*)out, n, (unsigned long long*)scratch);
  RET;
}

extern "C" int rs_compact(long n, const void* keep, const void* incl,
                          const void* src_rows, const void* src_v,
                          void* dst_rows, void* dst_v, long n_dst, int rebase,
                          int do_rebase, void* stream) {
  k_compact<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      n, (const int*)keep, (const int*)incl, (const uint32_t*)src_rows,
      (const int*)src_v, (uint32_t*)dst_rows, (int*)dst_v, n_dst, rebase,
      do_rebase);
  RET;
}

extern "C" int pi_mark(long w_pad, const void* w_uid, const void* w_ins,
                       int u_pad, const void* u_own, void* m_valid,
                       void* stream) {
  k_pi_mark<<<blocks_for(w_pad, THREADS), THREADS, 0, S(stream)>>>(
      w_pad, (const int*)w_uid, (const int*)w_ins, u_pad, (const int*)u_own,
      (int*)m_valid);
  RET;
}

extern "C" int pi_probe(const void* dk, int dcap, const void* dv,
                        const void* dsize, const void* u_b, const void* u_e,
                        const void* m_valid, long u_pad, void* cont_v,
                        void* present_end, void* hist_b, void* hist_e,
                        void* stream) {
  k_pi_probe<<<blocks_for(u_pad, THREADS), THREADS, 0, S(stream)>>>(
      (const uint32_t*)dk, dcap, log2_pow2(dcap), (const int*)dv,
      (const int*)dsize, (const uint32_t*)u_b, (const uint32_t*)u_e,
      (const int*)m_valid, u_pad, (int*)cont_v, (int*)present_end,
      (int*)hist_b, (int*)hist_e);
  RET;
}

extern "C" int pi_keep(int dcap, const void* dsize, const void* cnt_b,
                       const void* cnt_e, void* keep, void* stream) {
  k_pi_keep<<<blocks_for(dcap, THREADS), THREADS, 0, S(stream)>>>(
      dcap, (const int*)dsize, (const int*)cnt_b, (const int*)cnt_e,
      (int*)keep);
  RET;
}

extern "C" int pi_il_valid(long u_pad, const void* m_valid,
                           const void* present_end, void* il_valid,
                           void* stream) {
  k_pi_il_valid<<<blocks_for(u_pad, THREADS), THREADS, 0, S(stream)>>>(
      u_pad, (const int*)m_valid, (const int*)present_end, (int*)il_valid);
  RET;
}

extern "C" int pi_il_compact(long n2, const void* il_valid, const void* nincl,
                             const void* u_b, const void* u_e,
                             const void* cont_v, const void* now_rel,
                             void* cnew_rows, void* cnew_v, void* stream) {
  k_pi_il_compact<<<blocks_for(n2, THREADS), THREADS, 0, S(stream)>>>(
      n2, (const int*)il_valid, (const int*)nincl, (const uint32_t*)u_b,
      (const uint32_t*)u_e, (const int*)cont_v, (const int*)now_rel,
      (uint32_t*)cnew_rows, (int*)cnew_v);
  RET;
}

extern "C" int pi_scatter_old(int dcap, const void* kincl, const void* nincl,
                              long n2, const void* cnt_o,
                              const void* old_rows, const void* old_v,
                              void* out_rows, void* out_v, void* stream) {
  k_pi_scatter_old<<<blocks_for(dcap, THREADS), THREADS, 0, S(stream)>>>(
      dcap, (const int*)kincl, (const int*)nincl, n2, (const int*)cnt_o,
      (const uint32_t*)old_rows, (const int*)old_v, (uint32_t*)out_rows,
      (int*)out_v);
  RET;
}

extern "C" int pi_scatter_new(int dcap, const void* kincl, const void* nincl,
                              long n2, const void* pos_l,
                              const void* cnew_rows, const void* cnew_v,
                              void* out_rows, void* out_v, void* stream) {
  k_pi_scatter_new<<<blocks_for(n2, THREADS), THREADS, 0, S(stream)>>>(
      dcap, (const int*)kincl, (const int*)nincl, n2, (const int*)pos_l,
      (const uint32_t*)cnew_rows, (const int*)cnew_v, (uint32_t*)out_rows,
      (int*)out_v);
  RET;
}

extern "C" int pi_commit(int dcap, const void* kincl, const void* nincl,
                         long n2, const void* out_rows, const void* out_v,
                         void* dk, void* dv, void* dsize, void* flag,
                         const void* bsize, void* tail, void* stream) {
  k_pi_commit<<<blocks_for(dcap, THREADS), THREADS, 0, S(stream)>>>(
      dcap, (const int*)kincl, (const int*)nincl, n2,
      (const uint32_t*)out_rows, (const int*)out_v, (uint32_t*)dk, (int*)dv,
      (int*)dsize, (int*)flag, (const int*)bsize, (int*)tail);
  RET;
}

extern "C" int mg_probe_delta(int dcap, const void* dk, const void* bk,
                              int cap, const void* bv, const void* dv,
                              const void* size, void* hist_l, void* hist_r,
                              void* v_d, void* bbr, void* stream) {
  k_mg_probe_delta<<<blocks_for(dcap, THREADS), THREADS, 0, S(stream)>>>(
      dcap, (const uint32_t*)dk, (const uint32_t*)bk, cap, log2_pow2(cap),
      (const int*)bv, (const int*)dv, (const int*)size, (int*)hist_l,
      (int*)hist_r, (int*)v_d, (int*)bbr);
  RET;
}

extern "C" int mg_base(int cap, const void* bk, const void* bv,
                       const void* dk, const void* dv, int dcap,
                       const void* size, const void* dsize, const void* cnt_l,
                       const void* p, void* keep_b, void* dup_b, void* v_b,
                       void* stream) {
  k_mg_base<<<blocks_for(cap, THREADS), THREADS, 0, S(stream)>>>(
      cap, (const uint32_t*)bk, (const int*)bv, (const uint32_t*)dk,
      (const int*)dv, dcap, (const int*)size, (const int*)dsize,
      (const int*)cnt_l, (const int*)p, (int*)keep_b, (int*)dup_b,
      (int*)v_b);
  RET;
}

extern "C" int mg_place_base(int cap, const void* keep_b, const void* kb_incl,
                             const void* p, const void* dsize, const void* bk,
                             const void* v_b, long s_cap, void* s_rows,
                             void* sv, void* stream) {
  k_mg_place_base<<<blocks_for(cap, THREADS), THREADS, 0, S(stream)>>>(
      cap, (const int*)keep_b, (const int*)kb_incl, (const int*)p,
      (const int*)dsize, (const uint32_t*)bk, (const int*)v_b, s_cap,
      (uint32_t*)s_rows, (int*)sv);
  RET;
}

extern "C" int mg_place_delta(int dcap, const void* dsize, const void* bbr,
                              const void* drop_prefix, int cap,
                              const void* dk, const void* v_d, long s_cap,
                              void* s_rows, void* sv, void* stream) {
  k_mg_place_delta<<<blocks_for(dcap, THREADS), THREADS, 0, S(stream)>>>(
      dcap, (const int*)dsize, (const int*)bbr, (const int*)drop_prefix, cap,
      (const uint32_t*)dk, (const int*)v_d, s_cap, (uint32_t*)s_rows,
      (int*)sv);
  RET;
}

extern "C" int mg_gc_mask(long s_cap, const void* kb_incl, int cap,
                          const void* dsize, int dcap, const void* sv,
                          int new_oldest, void* keep_s, void* stream) {
  k_mg_gc_mask<<<blocks_for(s_cap, THREADS), THREADS, 0, S(stream)>>>(
      s_cap, (const int*)kb_incl, cap, (const int*)dsize, dcap,
      (const int*)sv, new_oldest, (int*)keep_s);
  RET;
}

extern "C" int mg_reset(int cap, void* bk, void* bv, int dcap, void* dk,
                        void* dv, const void* first, void* stream) {
  long n = cap > dcap ? cap : dcap;
  k_mg_reset<<<blocks_for(n, THREADS), THREADS, 0, S(stream)>>>(
      cap, (uint32_t*)bk, (int*)bv, dcap, (uint32_t*)dk, (int*)dv,
      (const uint32_t*)first);
  RET;
}

extern "C" int mg_finish(const void* ks_incl, long s_cap, int cap, void* size,
                         void* dsize, void* flag, void* stream) {
  k_mg_finish<<<1, 1, 0, S(stream)>>>((const int*)ks_incl, s_cap, cap,
                                      (int*)size, (int*)dsize, (int*)flag);
  RET;
}
