// rank_scan: inclusive scans, masked row compaction and the merge.
//
// Replaces (foundationdb_tpu):
//   rs_scan            -- the jnp.cumsum of conflict/window.py :233
//                         (window_gc; the compact step's rank_count scans,
//                         ops/digest.py :240, are in intra_batch.cu's
//                         ib_unpack);
//   rs_compact         -- window_gc's order-preserving rank scatters
//                         (window.py :233-240, with the rebase);
//                         no path launches either: window_gc is window.cu's
//                         wg_gc, one in-place launch;
//   mg_merge           -- conflict/fused.py:607-686 make_merge_step.merge
//                         (a merge path; three launches, below).
//
// Bound on the card: bytes.  A scan reads n and writes n int32; a
// compaction reads the mask, the ranks and the kept rows once and writes
// them once; the merge reads the live rows of both tiers once and writes
// the base and the delta (below).
//
// Design: a single-pass scan with decoupled look-back (one launch for any
// n, each element read once and written once; below); every scatter of
// the reference becomes a guarded row store with JAX's drop semantics
// (common.cuh).  The merge writes the merged base into a scratch base,
// never into the arrays it is still reading, before its last launch
// copies it into bk.
#include "common.cuh"

// ---------------------------------------------------------------- scan
// Single-pass inclusive scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVR-2016-002).
// A tile is 8 warps x 1,024 elements; each warp reads its 1,024 as eight
// coalesced rounds of one 128-bit load per lane, all issued before the
// first shuffle, and scans them in registers.  Tiles are numbered by an
// atomicAdd ticket, so a tile only ever waits on tiles that already hold
// an SM.  Each tile publishes its aggregate, then its inclusive prefix, in
// a 64-bit descriptor (common.cuh look_back: status in the high word,
// value in the low word, relaxed stores and loads); its warp 0 sums its
// predecessors' values 32 descriptors at a time until it meets a prefix.
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
    add += look_back<unsigned, 32>(desc, tile, aggregate, &s_prefix);
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

// --------------------------------------------------------------- merge
// The merge (conflict/fused.py:593-686 there): overlay the delta onto the
// base, removeBefore GC, the rebase, the delta reset; three launches.
//
// Both tiers are sorted and unique, and their rows past size / dsize are
// MAX rows (the window's invariant; every real digest is below MAX).  The
// merged sequence is their sorted union, a base row dropped where an equal
// live delta row exists.  It is computed by a merge path (Green, Odeh &
// Birk, "Merge Path -- A Visually Intuitive Approach to Parallel
// Merging"), ties base first, so a dropped base row is the merged element
// just before its equal delta row:
//   k_mg_partition  one warp a split, a 32-ary search (as sort.cu's
//                   k_partition) of where each tile's first output lies in
//                   the live base [0, size) and the live delta [0, dsize);
//                   it also zeroes the look-back descriptors and the
//                   ticket of the next launch, which therefore need no fill
//                   of their own;
//   k_mg_merge      a block a tile of MG_TILE merged elements: it stages its
//                   slices of both tiers in shared memory (rows as 16-byte
//                   halves at XOR-swizzled slots), with a halo of the two
//                   rows of each tier before its split and the delta row
//                   after its end, and merges them (MG_VT elements a
//                   thread).  The overlay: an element's version is the max
//                   of its own and the covering boundary of the other tier,
//                   the last row of that tier merged before it (the row
//                   just before the tier's slice seeds it; none: row 0, as
//                   the reference's clamped gathers give).  A base row is
//                   dropped when the next delta row equals it.  GC
//                   (SkipList.cpp:576 wasAbove) keeps an element when its
//                   version or its predecessor's (the merged element before
//                   it that is not dropped, in the halo for the tile's
//                   first) reaches the floor, and always the first.  The
//                   tile's kept count goes through a decoupled look-back
//                   (rs_scan's 64-bit status+value descriptors, tiles
//                   numbered by a ticket); kept rows are rebased as
//                   k_compact does and written in order to a scratch base,
//                   coalesced through an output-to-element map;
//   k_mg_finish     the scratch into bk/bv, MAX rows and NEG_INF past the
//                   new size, the delta reset (the zero digest, or the
//                   shard's `first` row, then MAX rows), size clamped to
//                   cap, dsize 1 and the sticky overflow flag.
// Bound on the card: bytes -- the live rows of both tiers read once, the
// kept rows written twice (scratch, then bk), the rest of bk and the delta
// written once.
#define MG_THREADS 256
#define MG_VT 4
#define MG_SLOTS (MG_THREADS * MG_VT)  // local rows of a tile
#define MG_TILE (MG_SLOTS - 8)  // merged elements a tile, halo left over

__device__ __forceinline__ int mg_slot(int p) { return p ^ ((p >> 3) & 7); }

// Three-way compare of two staged rows (local slots x, y).
__device__ __forceinline__ int mg_cmp(const uint4* h0, const uint4* h1,
                                      int x, int y) {
  const int c = cmp4(h0[mg_slot(x)], h0[mg_slot(y)]);
  return c != 0 ? c : cmp4(h1[mg_slot(x)], h1[mg_slot(y)]);
}

// Split `s`: the merged elements before diagonal d = min(s * MG_TILE, M)
// that come from the base; ties base first.
__global__ void k_mg_partition(const uint32_t* __restrict__ bk, int cap,
                               const int* __restrict__ size,
                               const uint32_t* __restrict__ dk, int dcap,
                               const int* __restrict__ dsize, int nsplit,
                               int* __restrict__ splits,
                               unsigned long long* __restrict__ desc) {
  const int s = (int)((blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= nsplit) return;  // whole warps leave together
  const int na = clampi(size[0], 0, cap);
  const int nb = clampi(dsize[0], 0, dcap);
  const long dl = (long)s * MG_TILE;
  const int d = (int)(dl < (long)na + nb ? dl : (long)na + nb);
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int mid = lo + lane * step;
    const bool p = mid < hi && row_cmp(load_row(bk, mid),
                                       load_row(dk, d - 1 - mid)) <= 0;
    const int c = __popc(__ballot_sync(0xffffffffu, p));
    if (c == 0) {
      hi = lo;
    } else {
      const int top = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = hi < top ? hi : top;
    }
  }
  if (lane == 0) {
    splits[2 * s] = lo;
    splits[2 * s + 1] = d - lo;
    desc[s] = 0ull;  // the ticket, then tile s - 1's descriptor
  }
}

__global__ void __launch_bounds__(MG_THREADS)
    k_mg_merge(const uint32_t* __restrict__ bk, const int* __restrict__ bv,
               int cap, const int* __restrict__ size,
               const uint32_t* __restrict__ dk, const int* __restrict__ dv,
               int dcap, const int* __restrict__ dsize,
               const int* __restrict__ splits,
               unsigned long long* __restrict__ desc, int new_oldest,
               int rebase, uint32_t* __restrict__ out_rows,
               int* __restrict__ out_v, int* __restrict__ total) {
  __shared__ uint4 s_h0[MG_SLOTS];  // lanes 0-3: base rows, then delta rows
  __shared__ uint4 s_h1[MG_SLOTS];  // lanes 4-7
  // Versions: the base's seed, its rows', the delta's seed, its rows'.
  __shared__ int s_v[MG_SLOTS + 2];
  __shared__ int s_pv[MG_SLOTS];             // merged element's version
  __shared__ short s_src[MG_SLOTS];          // its staged row
  __shared__ unsigned char s_drop[MG_SLOTS];  // a base row with a delta twin
  __shared__ short s_map[MG_SLOTS];          // kept output -> element
  __shared__ unsigned s_tile;
  __shared__ unsigned s_warp[MG_THREADS / 32];
  __shared__ unsigned s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb_all = clampi(dsize[0], 0, dcap);
  const long m = (long)clampi(size[0], 0, cap) + nb_all;
  const long ntiles = m > 0 ? (m + MG_TILE - 1) / MG_TILE : 1;
  if (tid == 0) s_tile = atomicAdd(reinterpret_cast<unsigned*>(desc), 1u);
  __syncthreads();
  const long tile = s_tile;
  if (tile >= ntiles) return;
  const int as = splits[2 * tile], bs = splits[2 * tile + 1];
  const int ae = splits[2 * tile + 2], be = splits[2 * tile + 3];
  const int alo = as > 2 ? as - 2 : 0;
  const int blo = bs > 2 ? bs - 2 : 0;
  const int bhi = be < nb_all ? be + 1 : be;
  const int na = ae - alo, nb = bhi - blo;  // staged rows of each tier
  const int pre = (as - alo) + (bs - blo);  // halo elements before the tile
  const int cnt = (ae - as) + (be - bs);    // the tile's elements
  const uint4* b4 = reinterpret_cast<const uint4*>(bk);
  const uint4* d4 = reinterpret_cast<const uint4*>(dk);
  {  // a thread's MG_VT rows: every load issued before the first store
    uint4 h0[MG_VT], h1[MG_VT];
    int v[MG_VT];
#pragma unroll
    for (int j = 0; j < MG_VT; ++j) {
      const int x = tid + j * MG_THREADS;
      if (x >= na + nb) continue;
      const uint4* src =
          x < na ? b4 + 2L * (alo + x) : d4 + 2L * (blo + x - na);
      h0[j] = src[0];
      h1[j] = src[1];
      v[j] = x < na ? bv[alo + x] : dv[blo + x - na];
    }
#pragma unroll
    for (int j = 0; j < MG_VT; ++j) {
      const int x = tid + j * MG_THREADS;
      if (x >= na + nb) continue;
      s_h0[mg_slot(x)] = h0[j];
      s_h1[mg_slot(x)] = h1[j];
      s_v[x < na ? 1 + x : 2 + x] = v[j];
    }
  }
  if (tid == 0) {
    s_v[0] = bv[alo > 0 ? alo - 1 : 0];
    s_v[na + 1] = dv[blo > 0 ? blo - 1 : 0];
  }
  __syncthreads();
  // Merge: each thread its MG_VT consecutive elements of the staged merge.
  const int n_loc = na + nb;
  const int p0 = tid * MG_VT;
  if (p0 < n_loc) {
    int lo = p0 > nb ? p0 - nb : 0;
    int hi = p0 < na ? p0 : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mg_cmp(s_h0, s_h1, mid, na + p0 - 1 - mid) <= 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    int ia = lo, ib = p0 - lo;
#pragma unroll
    for (int k = 0; k < MG_VT; ++k) {
      const int p = p0 + k;
      if (p >= n_loc) break;
      const int c = ia < na && ib < nb ? mg_cmp(s_h0, s_h1, ia, na + ib)
                                       : (ia < na ? -1 : 1);
      int own, other;
      if (c <= 0) {  // the base row; the delta's covering row came before
        own = s_v[1 + ia];
        other = s_v[na + 1 + ib];
        s_src[p] = (short)ia;
        s_drop[p] = c == 0;
        ++ia;
      } else {  // the delta row; the base's covering row came before
        own = s_v[na + 2 + ib];
        other = s_v[ia];
        s_src[p] = (short)(na + ib);
        s_drop[p] = 0;
        ++ib;
      }
      s_pv[p] = own > other ? own : other;
    }
  }
  __syncthreads();
  // GC over the tile's elements [pre, pre + cnt): a dropped base row's
  // twin follows it, so an element's predecessor is the one before it, or
  // the one before that when that one was dropped; none: the first.
  unsigned keep = 0u;
#pragma unroll
  for (int k = 0; k < MG_VT; ++k) {
    const int p = p0 + k;
    if (p < pre || p >= pre + cnt || s_drop[p]) continue;
    int q = p - 1;
    if (q >= 0 && s_drop[q]) --q;
    if (q < 0 || s_pv[p] >= new_oldest || s_pv[q] >= new_oldest)
      keep |= 1u << k;
  }
  // The tile's kept count and each thread's offset (warp scans, then the
  // warps' sums), then the tile's place through the look-back.
  const unsigned own_n = __popc(keep);
  const unsigned incl = warp_inclusive_scan(own_n, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned offset = incl - own_n, aggregate = 0u;
#pragma unroll
  for (int w = 0; w < MG_THREADS / 32; ++w) {
    if (w < warp) offset += s_warp[w];
    aggregate += s_warp[w];
  }
  unsigned long long* tdesc = desc + 1;
  unsigned prefix = 0u;
  if (tile == 0) {
    if (tid == 0) store_relaxed(tdesc, (SCAN_PREFIX << 32) | aggregate);
  } else {
    if (tid == 0)
      store_relaxed(tdesc + tile, (SCAN_AGGREGATE << 32) | aggregate);
    prefix = look_back<unsigned, 32>(tdesc, tile, aggregate, &s_prefix);
  }
#pragma unroll
  for (int k = 0; k < MG_VT; ++k)
    if (keep & (1u << k)) s_map[offset++] = (short)(p0 + k);
  __syncthreads();
  for (int o = tid; o < (int)aggregate; o += MG_THREADS) {
    const long dst = (long)prefix + o;
    if (dst >= cap) break;  // past cap: dropped (the state is poisoned)
    const int p = s_map[o];
    const int x = s_src[p];
    uint4* row = reinterpret_cast<uint4*>(out_rows) + 2 * dst;
    row[0] = s_h0[mg_slot(x)];
    row[1] = s_h1[mg_slot(x)];
    int v = (int)((uint32_t)s_pv[p] - (uint32_t)rebase);
    out_v[dst] = v > NEG_INF_I32 + 1 ? v : NEG_INF_I32 + 1;
  }
  if (tile == ntiles - 1 && tid == 0) total[0] = (int)(prefix + aggregate);
}

// Every store coalesced: rows move as 16-byte halves, consecutive threads
// on consecutive halves; VEC: the version arrays are 16-byte aligned and
// their lengths multiples of 4, so versions move four at a time.
template <bool VEC>
__global__ void k_mg_finish(int cap, uint32_t* __restrict__ bk,
                            int* __restrict__ bv, int dcap,
                            uint32_t* __restrict__ dk, int* __restrict__ dv,
                            const uint32_t* __restrict__ first,
                            const uint32_t* __restrict__ out_rows,
                            const int* __restrict__ out_v,
                            const int* __restrict__ total, int* size,
                            int* dsize, int* flag) {
  const int tot = total[0];
  const int new_size = tot < cap ? tot : cap;
  const uint4 max4 = make_uint4(~0u, ~0u, ~0u, ~0u);
  const uint4* src4 = reinterpret_cast<const uint4*>(out_rows);
  uint4* bk4 = reinterpret_cast<uint4*>(bk);
  uint4* dk4 = reinterpret_cast<uint4*>(dk);
  GRID_STRIDE(j, 2L * cap) bk4[j] = (j >> 1) < new_size ? src4[j] : max4;
  GRID_STRIDE(j, 2L * dcap) {  // the reset delta: `first` or zero, MAX
    uint4 h = max4;
    if (j < 2) {
      h = first != nullptr ? reinterpret_cast<const uint4*>(first)[j]
                           : make_uint4(0u, 0u, 0u, 0u);
    }
    dk4[j] = h;
  }
  if (VEC) {
    const int4 neg = make_int4(NEG_INF_I32, NEG_INF_I32, NEG_INF_I32,
                               NEG_INF_I32);
    GRID_STRIDE(q, cap / 4) {
      const long i = 4 * q;
      int4 v = neg;
      if (i + 3 < new_size) {
        v = reinterpret_cast<const int4*>(out_v)[q];
      } else if (i < new_size) {
        v.x = out_v[i];
        if (i + 1 < new_size) v.y = out_v[i + 1];
        if (i + 2 < new_size) v.z = out_v[i + 2];
      }
      reinterpret_cast<int4*>(bv)[q] = v;
    }
    GRID_STRIDE(q, dcap / 4) reinterpret_cast<int4*>(dv)[q] = neg;
  } else {
    GRID_STRIDE(i, cap) bv[i] = i < new_size ? out_v[i] : NEG_INF_I32;
    GRID_STRIDE(i, dcap) dv[i] = NEG_INF_I32;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flag[0] = flag[0] | (tot > cap ? 1 : 0);
    size[0] = new_size;
    dsize[0] = 1;
  }
}

// ------------------------------------------------------------ launchers
#define S(stream) (cudaStream_t)(stream)
#define RET return (int)cudaGetLastError()

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

// The whole merge, three launches: partition, merge, finish.  scratch:
// int64[2 * nsplit + 1] (the descriptors, the splits, the total), work:
// int32[cap * 9] (the scratch base's rows, then its versions); both may be
// uninitialised.  new_oldest and rebase are relative versions.
extern "C" int mg_merge(void* bk, void* bv, int cap, void* size, void* dk,
                        void* dv, int dcap, void* dsize, void* flag,
                        const void* first, int new_oldest, int rebase,
                        void* scratch, long scratch_len, void* work,
                        void* stream) {
  const long ntiles = ((long)cap + dcap + MG_TILE - 1) / MG_TILE;
  const long nsplit = ntiles + 1;
  if (scratch_len < 2 * nsplit + 1 || ntiles > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  unsigned long long* desc = (unsigned long long*)scratch;
  int* splits = (int*)(desc + nsplit);
  int* total = splits + 2 * nsplit;
  uint32_t* out_rows = (uint32_t*)work;
  int* out_v = (int*)work + 8L * cap;
  k_mg_partition<<<blocks_for(nsplit * 32, THREADS), THREADS, 0,
                   S(stream)>>>((const uint32_t*)bk, cap, (const int*)size,
                                (const uint32_t*)dk, dcap,
                                (const int*)dsize, (int)nsplit, splits, desc);
  k_mg_merge<<<(unsigned)ntiles, MG_THREADS, 0, S(stream)>>>(
      (const uint32_t*)bk, (const int*)bv, cap, (const int*)size,
      (const uint32_t*)dk, (const int*)dv, dcap, (const int*)dsize, splits,
      desc, new_oldest, rebase, out_rows, out_v, total);
  const long halves = 2L * (cap > dcap ? cap : dcap);
  const bool vec = (uintptr_t)bv % 16 == 0 && (uintptr_t)dv % 16 == 0 &&
                   (uintptr_t)out_v % 16 == 0 && cap % 4 == 0 &&
                   dcap % 4 == 0;
  if (vec)
    k_mg_finish<true><<<blocks_for(halves, THREADS), THREADS, 0,
                        S(stream)>>>(
        cap, (uint32_t*)bk, (int*)bv, dcap, (uint32_t*)dk, (int*)dv,
        (const uint32_t*)first, out_rows, out_v, total, (int*)size,
        (int*)dsize, (int*)flag);
  else
    k_mg_finish<false><<<blocks_for(halves, THREADS), THREADS, 0,
                         S(stream)>>>(
        cap, (uint32_t*)bk, (int*)bv, dcap, (uint32_t*)dk, (int*)dv,
        (const uint32_t*)first, out_rows, out_v, total, (int*)size,
        (int*)dsize, (int*)flag);
  RET;
}
