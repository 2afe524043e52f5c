// Tile binning for NVIDIA Hopper (sm_90a): the TileBins of
// monogs_torch/ops/binning.py built from the live (tile, Gaussian) entries.
//
// Replaces no TPU kernel. The JAX package bins with XLA's sort and scans
// (monogs_tpu/ops/binning.py::tile_bin), and the port's plain twin
// (_tile_bin_plain in monogs_torch/ops/binning.py, the CPU path) does the
// same in PyTorch: it works on every slot that N x max_dup could hold, a
// stable sort, gathers and scans over N * max_dup int64 slots however few
// entries are live (at N 32,768 and max_dup 300: 9.8 M slots, ~30 ms a
// call on the H100, most of it a 1-D cummax that ATen runs in one block).
// The ctypes binding is ops/kernels.py (tile_bin).
//
// What bounds it on the H100: the bytes of its outputs. index_matrix
// (T x K) and the three P_cap-long slab arrays are written whatever the
// scene (~21 MB at the benchmark's mapping shapes, ~7 us at 3.35 TB/s);
// the live entries themselves are a few hundred thousand.
//
// Design: every pass is sized by the live entries, not by N x max_dup.
//   1. count: a thread a Gaussian walks its tile rectangle's candidates
//      d < min(n_cover, D_gen) in d order (ascending tile id) through the
//      exact peak-alpha corner cull and keeps the first max_dup survivors:
//      the columns the twin's row sort and [:, :max_dup] keep. Per-block
//      sums of the kept counts and of overflow_parts[0:2].
//   2. scan: one block scans the block sums; each Gaussian's kept entries
//      get a range of a compact entry list in (Gaussian, tile) order.
//   3. emit: the cull again, writing each kept entry's tile and Gaussian,
//      and a per-tile histogram (shared-memory counts, one global atomic a
//      block and tile).
//   4. layout: one block over the T < 2048 tiles: bucket starts, the
//      capped and SLAB-padded counts, block starts and the truncation at
//      P_cap, overflow_parts[2:4] (the twin's scans over T).
//   5. scatter: each entry into its tile's bucket as the 64-bit key
//      (depth's top 20 bits << 32 | entry). Entries are numbered in
//      Gaussian order, and a Gaussian has one entry a tile, so within a
//      tile the key orders as the twin's stable sort does (depth bits,
//      then Gaussian) whatever order the atomics scattered in: the output
//      is deterministic.
//   6. sort: a block a tile sorts its bucket (bitonic, every comparator
//      ascending, so the virtual padding to a power of two is +inf and
//      never moves) in shared memory when it holds SMEM_KEYS keys or
//      fewer, else in place in global memory (the path is chosen by the
//      bucket's count, which the block reads); it writes the tile's row
//      of index_matrix and each entry's slab position (P_cap when dropped).
//   7-9. the Gaussian-sorted view: per Gaussian its surviving entries,
//      scanned, each Gaussian writing its positions in tile order.
//  10. slab: a block a SLAB block: its owner tile (a search over the
//      blocks' running sum), seg_first, gauss_of_pos, and the gsort tail
//      (P_cap - 1, 1 at the first tail slot).
// No pass reads a count on the host: grids come from N, T, K, max_dup and
// P_cap, and the live-entry count is read on the device (a grid-stride
// loop). Scratch comes from the caller, per call, so two streams can bin
// at once. Launches go to the caller's stream; nothing is allocated or
// synchronised.
//
// Rounding: the cull computes op by op as the twin's PyTorch ops do on the
// card (the build passes -fmad=false; IEEE division in -cb X / cc; expf;
// torch.clamp's and torch.maximum's NaN rules). PyTorch divides a CUDA
// tensor by a Python number as a product with its float32 reciprocal, so
// the rectangle's (u -+ radius) / tile_size is that product here (exact
// either way for tile 16 and 32). Entries are identical to the twin's for
// positive or NaN-free depths and non-negative radii (the projection's);
// a candidate outside the tile grid, which only a negative radius makes,
// is dropped rather than written out of bounds.

#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

namespace {

constexpr int SLAB = 512;
constexpr int DEPTH_BITS = 20;
constexpr int MAX_TILES = 1 << (31 - DEPTH_BITS);  // binning.py's key check: T < 2048
constexpr int GAUSS_THREADS = 256;   // per-Gaussian passes
constexpr int SCAN_THREADS = 1024;   // one-block scans
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_ITEMS = 8;     // entries a thread per chunk
constexpr int SCATTER_CHUNK = SCATTER_THREADS * SCATTER_ITEMS;
constexpr int SCATTER_BLOCKS = 4 * 132;
constexpr int SORT_THREADS = 512;
constexpr int SMEM_KEYS = 12288;     // 96 KB of keys: two sort blocks an SM
constexpr unsigned FULL = 0xffffffffu;
constexpr float CONIC_MIN = (float)1e-12;
typedef unsigned long long u64;

struct Params {
  const float *u, *v, *radius, *depth, *opacity, *ca, *cb, *cc;  // opacity null: no cull
  const unsigned char* valid;
  int N, tiles_x, tiles_y, T, max_dup, D_gen;
  float fts, inv_ts, cull_alpha;
};

// torch.clamp with number bounds (NaN kept).
__device__ __forceinline__ float clamp_s(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.clamp with tensor bounds.
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.maximum (NaN propagates).
__device__ __forceinline__ float max_t(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// One Gaussian's candidate rectangle: origin, row width (at least 1) and
// the number of candidates walked, min(n_cover, D_gen).
struct Rect {
  int x0, y0, w, n_cover, lim;
};

__device__ __forceinline__ Rect rect_of(const Params& p, int i) {
  const float u = p.u[i], v = p.v[i], r = p.radius[i];
  const float tx = (float)p.tiles_x, ty = (float)p.tiles_y;
  const int x0 = (int)clamp_s(floorf((u - r) * p.inv_ts), 0.0f, tx);
  const int x1 = (int)clamp_s(ceilf((u + r + 1.0f) * p.inv_ts), 0.0f, tx);
  const int y0 = (int)clamp_s(floorf((v - r) * p.inv_ts), 0.0f, ty);
  const int y1 = (int)clamp_s(ceilf((v + r + 1.0f) * p.inv_ts), 0.0f, ty);
  const bool ok = p.valid[i] != 0;
  const int w = ok ? x1 - x0 : 0, h = ok ? y1 - y0 : 0;
  Rect R;
  R.x0 = x0;
  R.y0 = y0;
  R.w = max(w, 1);
  R.n_cover = w * h;
  R.lim = min(R.n_cover, p.D_gen);
  return R;
}

struct Conic {
  float ca, cb, cc, u, v, opa;
};

__device__ __forceinline__ Conic conic_of(const Params& p, int i) {
  Conic c;
  c.ca = clamp_s(p.ca[i], CONIC_MIN, INFINITY);
  c.cb = p.cb[i];
  c.cc = clamp_s(p.cc[i], CONIC_MIN, INFINITY);
  c.u = p.u[i];
  c.v = p.v[i];
  c.opa = p.opacity[i];
  return c;
}

__device__ __forceinline__ float power(const Conic& c, float X, float Y) {
  return -0.5f * (c.ca * X * X + c.cc * Y * Y) - c.cb * X * Y;
}

// The twin's peak-alpha cull of one candidate tile: the power is concave,
// so its max over the tile is 0 with the mean inside, else the max over the
// four edges.
__device__ __forceinline__ bool survives(const Conic& c, int tx, int ty, float fts,
                                         float cull_alpha) {
  const float lx = (float)tx * fts - c.u, hx = lx + fts;
  const float ly = (float)ty * fts - c.v, hy = ly + fts;
  const float e0 = power(c, lx, clamp_t(-c.cb * lx / c.cc, ly, hy));
  const float e1 = power(c, hx, clamp_t(-c.cb * hx / c.cc, ly, hy));
  const float e2 = power(c, clamp_t(-c.cb * ly / c.ca, lx, hx), ly);
  const float e3 = power(c, clamp_t(-c.cb * hy / c.ca, lx, hx), hy);
  const bool inside = (lx <= 0.0f) && (0.0f <= hx) && (ly <= 0.0f) && (0.0f <= hy);
  const float pmax = inside ? 0.0f : max_t(max_t(e0, e1), max_t(e2, e3));
  return c.opa * expf(pmax) >= cull_alpha;
}

// Walks a Gaussian's candidates in d order and calls keep(tile) for each
// survivor until `stop` survivors were kept; -> the survivors seen.
template <typename F>
__device__ __forceinline__ int walk(const Params& p, int i, const Rect& R, int stop, F keep) {
  const bool cull = p.opacity != nullptr;
  Conic c;
  if (cull) c = conic_of(p, i);
  int surv = 0, cx = 0, cy = 0;
  for (int d = 0; d < R.lim && surv < stop; ++d) {
    const int tx = R.x0 + cx, ty = R.y0 + cy;
    if (++cx == R.w) {
      cx = 0;
      ++cy;
    }
    const int tile = ty * p.tiles_x + tx;
    if (tx >= p.tiles_x || ty >= p.tiles_y || tx < 0 || ty < 0) continue;
    if (cull && !survives(c, tx, ty, p.fts, p.cull_alpha)) continue;
    keep(surv, tile);
    ++surv;
  }
  return surv;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Sum over the block, in every thread.
template <int THREADS, typename V>
__device__ __forceinline__ V block_sum(V x) {
  __shared__ V part[THREADS / 32];
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  V s = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += part[w];
  __syncthreads();
  return s;
}

// Exclusive prefix sum over the block; `total` <- the block's sum.
template <int THREADS>
__device__ __forceinline__ int block_scan(int x, int& total) {
  constexpr int NW = THREADS / 32;
  __shared__ int wsum[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NW ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NW) wsum[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? wsum[warp - 1] : 0;
  total = wsum[NW - 1];
  __syncthreads();
  return before + incl - x;
}

// 1. Kept entries per Gaussian; per-block sums of them and of
// overflow_parts[0] (coverage past D_gen) and [1] (survivors past max_dup).
__global__ void __launch_bounds__(GAUSS_THREADS)
count_kernel(Params p, int* __restrict__ kept, int* __restrict__ part,
             long long* __restrict__ part_o0, long long* __restrict__ part_o1) {
  const int i = blockIdx.x * GAUSS_THREADS + threadIdx.x;
  int k = 0;
  long long o0 = 0, o1 = 0;
  if (i < p.N) {
    const Rect R = rect_of(p, i);
    const int surv = walk(p, i, R, INT32_MAX, [](int, int) {});
    k = min(surv, p.max_dup);
    o0 = max(R.n_cover - p.D_gen, 0);
    o1 = max(surv - p.max_dup, 0);
    kept[i] = k;
  }
  const int ks = block_sum<GAUSS_THREADS>(k);
  const long long s0 = block_sum<GAUSS_THREADS>(o0), s1 = block_sum<GAUSS_THREADS>(o1);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = ks;
    part_o0[blockIdx.x] = s0;
    part_o1[blockIdx.x] = s1;
  }
}

// 2, 8. part[0:nb] <- its exclusive prefix sum, *total <- its sum (one
// block); zero[0:n_zero] <- 0 on the way.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int* __restrict__ part, int nb, int* __restrict__ total, int* __restrict__ zero,
            int n_zero) {
  for (int i = threadIdx.x; i < n_zero; i += SCAN_THREADS) zero[i] = 0;
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += SCAN_THREADS) {
    const int b = b0 + threadIdx.x;
    const int x = b < nb ? part[b] : 0;
    int tot;
    const int ex = block_scan<SCAN_THREADS>(x, tot);
    if (b < nb) part[b] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) *total = carry;
}

// 3. Each Gaussian's kept entries at its range of the entry list, and the
// per-tile histogram.
__global__ void __launch_bounds__(GAUSS_THREADS)
emit_kernel(Params p, const int* __restrict__ kept, const int* __restrict__ part,
            int* __restrict__ off, int* __restrict__ ent_tile, int* __restrict__ ent_gauss,
            int* __restrict__ hist) {
  __shared__ int sh[MAX_TILES];
  for (int t = threadIdx.x; t < p.T; t += GAUSS_THREADS) sh[t] = 0;
  const int i = blockIdx.x * GAUSS_THREADS + threadIdx.x;
  const int k = i < p.N ? kept[i] : 0;
  int tot;
  const int ex = block_scan<GAUSS_THREADS>(k, tot);
  if (i < p.N) {
    const int o = part[blockIdx.x] + ex;
    off[i] = o;
    if (k > 0) {
      walk(p, i, rect_of(p, i), k, [&](int r, int tile) {
        ent_tile[o + r] = tile;
        ent_gauss[o + r] = i;
        atomicAdd(&sh[tile], 1);
      });
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < p.T; t += GAUSS_THREADS)
    if (sh[t]) atomicAdd(&hist[t], sh[t]);
}

// 4. The tiles' layout (one block, two tiles a thread): bucket starts,
// counts capped at K and SLAB-padded, block starts truncated at EB blocks,
// the blocks' running sum, and overflow_parts.
__global__ void __launch_bounds__(SCAN_THREADS)
layout_kernel(const int* __restrict__ hist, int T, int K, int EB,
              const long long* __restrict__ part_o0, const long long* __restrict__ part_o1,
              int nb, int* __restrict__ bstart, int* __restrict__ counts,
              int* __restrict__ pstart_blk, int* __restrict__ cumblk, int* __restrict__ total_blk,
              int* __restrict__ overflow_parts, int* __restrict__ overflow) {
  const int t0 = 2 * threadIdx.x, t1 = t0 + 1;
  const int seg0 = t0 < T ? hist[t0] : 0, seg1 = t1 < T ? hist[t1] : 0;
  int tot;
  const int bs = block_scan<SCAN_THREADS>(seg0 + seg1, tot);
  if (t0 < T) bstart[t0] = bs;
  if (t1 < T) bstart[t1] = bs + seg0;
  if (threadIdx.x == 0) bstart[T] = tot;
  const int c0 = min(seg0, K), c1 = min(seg1, K);
  const int n00 = (c0 + SLAB - 1) / SLAB, n01 = (c1 + SLAB - 1) / SLAB;
  const int ps0 = block_scan<SCAN_THREADS>(n00 + n01, tot);
  const int nb0 = min(n00, max(EB - ps0, 0)), nb1 = min(n01, max(EB - (ps0 + n00), 0));
  const int e0 = min(c0, nb0 * SLAB), e1 = min(c1, nb1 * SLAB);
  int blocks;
  const int ps = block_scan<SCAN_THREADS>(nb0 + nb1, blocks);
  if (t0 < T) {
    counts[t0] = e0;
    pstart_blk[t0] = ps;
    cumblk[t0] = ps + nb0;
  }
  if (t1 < T) {
    counts[t1] = e1;
    pstart_blk[t1] = ps + nb0;
    cumblk[t1] = ps + nb0 + nb1;
  }
  const long long o2 = block_sum<SCAN_THREADS>(
      (long long)(max(seg0 - K, 0) + max(seg1 - K, 0)));
  const long long o3 = block_sum<SCAN_THREADS>((long long)(c0 - e0 + c1 - e1));
  long long a0 = 0, a1 = 0;
  for (int b = threadIdx.x; b < nb; b += SCAN_THREADS) {
    a0 += part_o0[b];
    a1 += part_o1[b];
  }
  const long long o0 = block_sum<SCAN_THREADS>(a0), o1 = block_sum<SCAN_THREADS>(a1);
  if (threadIdx.x == 0) {
    // The twin sums in int64 and casts each part, then the parts' sum, to
    // int32.
    const int p0 = (int)o0, p1 = (int)o1, p2 = (int)o2, p3 = (int)o3;
    overflow_parts[0] = p0;
    overflow_parts[1] = p1;
    overflow_parts[2] = p2;
    overflow_parts[3] = p3;
    *overflow = (int)((long long)p0 + p1 + p2 + p3);
    *total_blk = blocks;
  }
}

__device__ __forceinline__ u64 depth_bits(float d) {
  d = isnan(d) ? d : fmaxf(d, 0.0f);
  return (u64)(unsigned)(__float_as_int(d) >> (31 - DEPTH_BITS));
}

// 5. Every live entry into its tile's bucket as (depth bits << 32 | entry):
// ranks within a chunk from shared-memory atomics, one global atomic a
// chunk and tile for the chunk's range of the bucket.
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_kernel(const int* __restrict__ ent_tile, const int* __restrict__ ent_gauss,
               const float* __restrict__ depth, const int* __restrict__ n_live,
               const int* __restrict__ bstart, int* __restrict__ fill, u64* __restrict__ bucket,
               int T) {
  __shared__ int cnt[MAX_TILES], base[MAX_TILES];
  const int E = *n_live;
  for (int c0 = blockIdx.x * SCATTER_CHUNK; c0 < E; c0 += gridDim.x * SCATTER_CHUNK) {
    for (int t = threadIdx.x; t < T; t += SCATTER_THREADS) cnt[t] = 0;
    __syncthreads();
    int tile[SCATTER_ITEMS], rank[SCATTER_ITEMS];
#pragma unroll
    for (int j = 0; j < SCATTER_ITEMS; ++j) {
      const int e = c0 + j * SCATTER_THREADS + threadIdx.x;
      if (e < E) {
        tile[j] = ent_tile[e];
        rank[j] = atomicAdd(&cnt[tile[j]], 1);
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += SCATTER_THREADS)
      if (cnt[t]) base[t] = bstart[t] + atomicAdd(&fill[t], cnt[t]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SCATTER_ITEMS; ++j) {
      const int e = c0 + j * SCATTER_THREADS + threadIdx.x;
      if (e < E) bucket[base[tile[j]] + rank[j]] = (depth_bits(depth[ent_gauss[e]]) << 32) | (u64)e;
    }
    __syncthreads();
  }
}

// Ascending bitonic sort of a[0:c] by the block, a[c:] taken as +inf: each
// merge's first step compares mirrored pairs, the rest are half-cleaners,
// so every comparator puts the smaller key at the lower index and a
// comparator reaching past c never swaps.
__device__ __forceinline__ void order_pair(u64* a, int lo, int hi) {
  const u64 x = a[lo], y = a[hi];
  if (y < x) {
    a[lo] = y;
    a[hi] = x;
  }
}

__device__ void bitonic_sort(u64* a, int c) {
  int lg = 0;
  while ((1 << lg) < c) ++lg;
  const int pairs = (1 << lg) >> 1;
  for (int lk = 1; lk <= lg; ++lk) {
    // Merge runs of 2^lk: pair q compares o = q mod 2^(lk-1) of its run's
    // first half with the mirrored element of the second.
    const int lh = lk - 1;
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int run = (q >> lh) << lk, o = q & ((1 << lh) - 1);
      const int hi = run + (1 << lk) - 1 - o;
      if (hi < c) order_pair(a, run + o, hi);
    }
    __syncthreads();
    for (int lj = lk - 2; lj >= 0; --lj) {
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        const int lo = ((q >> lj) << (lj + 1)) + (q & ((1 << lj) - 1)), hi = lo + (1 << lj);
        if (hi < c) order_pair(a, lo, hi);
      }
      __syncthreads();
    }
  }
}

// 6. A block a tile: its bucket sorted; its index_matrix row; each
// entry's slab position (P_cap past counts[t]).
__global__ void __launch_bounds__(SORT_THREADS)
sort_kernel(u64* __restrict__ bucket, const int* __restrict__ hist,
            const int* __restrict__ bstart, const int* __restrict__ counts,
            const int* __restrict__ pstart_blk, const int* __restrict__ ent_gauss,
            int* __restrict__ ent_pos, int* __restrict__ index_matrix, int K, int N, int P_cap) {
  extern __shared__ u64 skeys[];
  const int t = blockIdx.x, c = hist[t];
  u64* keys = bucket + bstart[t];
  if (c <= SMEM_KEYS) {
    for (int k = threadIdx.x; k < c; k += SORT_THREADS) skeys[k] = keys[k];
    __syncthreads();
    keys = skeys;
  }
  bitonic_sort(keys, c);
  const int live = counts[t], base = pstart_blk[t] * SLAB;
  int* row = index_matrix + (long long)t * K;
  for (int k = threadIdx.x; k < c; k += SORT_THREADS) {
    const int e = (int)(keys[k] & 0xffffffffu);
    if (k < K) row[k] = k < live ? ent_gauss[e] : N;
    ent_pos[e] = k < live ? base + k : P_cap;
  }
  for (int k = c + threadIdx.x; k < K; k += SORT_THREADS) row[k] = N;
}

// 7. Surviving entries per Gaussian, and their per-block sums.
__global__ void __launch_bounds__(GAUSS_THREADS)
gcount_kernel(const int* __restrict__ kept, const int* __restrict__ off,
              const int* __restrict__ ent_pos, int N, int P_cap, int* __restrict__ ksurv,
              int* __restrict__ part) {
  const int i = blockIdx.x * GAUSS_THREADS + threadIdx.x;
  int s = 0;
  if (i < N) {
    const int o = off[i], k = kept[i];
    for (int r = 0; r < k; ++r) s += ent_pos[o + r] < P_cap;
    ksurv[i] = s;
  }
  s = block_sum<GAUSS_THREADS>(s);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// 9. The Gaussian-sorted view: each Gaussian's slab positions in tile
// order at its range, 1 in gseg_start at the first, g_last.
__global__ void __launch_bounds__(GAUSS_THREADS)
gemit_kernel(const int* __restrict__ kept, const int* __restrict__ off,
             const int* __restrict__ ent_pos, const int* __restrict__ ksurv,
             const int* __restrict__ part, int N, int P_cap, int* __restrict__ g_last,
             int* __restrict__ gsort_pos, int* __restrict__ gseg_start) {
  const int i = blockIdx.x * GAUSS_THREADS + threadIdx.x;
  const int s = i < N ? ksurv[i] : 0;
  int tot;
  const int ex = block_scan<GAUSS_THREADS>(s, tot);
  if (i >= N) return;
  const int q0 = part[blockIdx.x] + ex;
  g_last[i] = s > 0 ? q0 + s - 1 : P_cap;
  if (s == 0) return;
  const int o = off[i], k = kept[i];
  for (int r = 0, q = q0; r < k; ++r) {
    const int pos = ent_pos[o + r];
    if (pos < P_cap) {
      gsort_pos[q] = pos;
      gseg_start[q] = q == q0;
      ++q;
    }
  }
}

// 10. A block a SLAB block b: owner_blk, seg_first, gauss_of_pos, and the
// gsort view's tail past its L live slots.
__global__ void __launch_bounds__(SLAB)
slab_kernel(const int* __restrict__ cumblk, const int* __restrict__ pstart_blk,
            const int* __restrict__ counts, const int* __restrict__ index_matrix,
            const int* __restrict__ total_blk, const int* __restrict__ n_surv, int T, int K,
            int N, int P_cap, int* __restrict__ owner_blk, int* __restrict__ seg_first,
            int* __restrict__ gauss_of_pos, int* __restrict__ gsort_pos,
            int* __restrict__ gseg_start) {
  __shared__ int owner;
  const int b = blockIdx.x, p = b * SLAB + threadIdx.x;
  if (threadIdx.x == 0) {
    // The owner is the number of tiles whose blocks end at or before b.
    int lo = 0, hi = T;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cumblk[mid] <= b) lo = mid + 1;
      else hi = mid;
    }
    owner = lo;
    owner_blk[b] = lo;
    seg_first[b] = b == 0 || (lo < T ? b == pstart_blk[lo] : b == *total_blk);
  }
  __syncthreads();
  const int o = owner;
  int g = N;
  if (o < T) {
    const int k = p - pstart_blk[o] * SLAB;
    if (k < counts[o]) g = index_matrix[(long long)o * K + k];
  }
  gauss_of_pos[p] = g;
  const int L = *n_surv;
  if (p >= L) {
    gsort_pos[p] = P_cap - 1;
    gseg_start[p] = p == L;
  }
}

// The scratch arrays, carved from one buffer (base null: sizes only).
struct Scratch {
  int *kept, *off, *ksurv, *part, *part2, *hist, *fill, *bstart, *cumblk, *scalars;
  long long *part_o0, *part_o1;
  int *ent_tile, *ent_gauss;  // ent_tile's memory holds ent_pos after the scatter
  u64* bucket;
};

size_t carve(char* base, int N, int nb, int T, long long E_max, Scratch* s) {
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* ptr = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return ptr;
  };
  s->kept = (int*)take(4 * (size_t)N);
  s->off = (int*)take(4 * (size_t)N);
  s->ksurv = (int*)take(4 * (size_t)N);
  s->part = (int*)take(4 * (size_t)nb);
  s->part2 = (int*)take(4 * (size_t)nb);
  s->part_o0 = (long long*)take(8 * (size_t)nb);
  s->part_o1 = (long long*)take(8 * (size_t)nb);
  s->hist = (int*)take(4 * 2 * (size_t)T);  // hist, then fill: zeroed together
  s->fill = s->hist ? s->hist + T : nullptr;
  s->bstart = (int*)take(4 * ((size_t)T + 1));
  s->cumblk = (int*)take(4 * (size_t)T);
  s->scalars = (int*)take(4 * 3);  // live entries, surviving entries, slab blocks
  s->ent_tile = (int*)take(4 * (size_t)E_max);
  s->ent_gauss = (int*)take(4 * (size_t)E_max);
  s->bucket = (u64*)take(8 * (size_t)E_max);
  return at;
}

int n_blocks(int N) { return N > 0 ? (N + GAUSS_THREADS - 1) / GAUSS_THREADS : 1; }

// cudaFuncSetAttribute once a device (the sort's 96 KB of dynamic shared
// memory is above the default 48 KB).
int sort_smem_ready() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (done[dev & 63].load()) return 0;
  e = cudaFuncSetAttribute(sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_KEYS * (int)sizeof(u64));
  if (e != cudaSuccess) return (int)e;
  done[dev & 63].store(true);
  return 0;
}

}  // namespace

// Plain C entry points (ctypes). tile_bin returns the first launch's
// cudaGetLastError() that is not 0, else 0; 1 (cudaErrorInvalidValue) for
// shapes it does not take (T >= 2048, K or P_cap not positive, P_cap not a
// multiple of SLAB).
extern "C" long long tile_bin_scratch_bytes(int N, int T, long long E_max) {
  Scratch s;
  return (long long)carve(nullptr, N, n_blocks(N), T, E_max, &s);
}

extern "C" int tile_bin(const float* u, const float* v, const float* radius, const float* depth,
                        const unsigned char* valid, const float* opacity, const float* ca,
                        const float* cb, const float* cc, int N, int tiles_x, int tiles_y,
                        int tile_size, int K, int max_dup, int D_gen, int P_cap,
                        float cull_alpha, long long E_max, void* scratch, int* index_matrix,
                        int* counts, int* pstart_blk, int* owner_blk, int* seg_first,
                        int* gauss_of_pos, int* gsort_pos, int* gseg_start, int* g_last,
                        int* overflow, int* overflow_parts, void* stream) {
  const int T = tiles_x * tiles_y;
  if (T <= 0 || T >= MAX_TILES || K <= 0 || P_cap <= 0 || P_cap % SLAB || tile_size <= 0)
    return (int)cudaErrorInvalidValue;
  int rc = sort_smem_ready();
  if (rc) return rc;
  const int nb = n_blocks(N), EB = P_cap / SLAB;
  Scratch s;
  carve(static_cast<char*>(scratch), N, nb, T, E_max, &s);
  Params p;
  p.u = u;
  p.v = v;
  p.radius = radius;
  p.depth = depth;
  p.opacity = opacity;
  p.ca = ca;
  p.cb = cb;
  p.cc = cc;
  p.valid = valid;
  p.N = N;
  p.tiles_x = tiles_x;
  p.tiles_y = tiles_y;
  p.T = T;
  p.max_dup = max_dup;
  p.D_gen = D_gen;
  p.fts = (float)tile_size;
  // PyTorch's CUDA division by a CPU scalar: the product with 1 / b, the
  // reciprocal taken in float32 on the host.
  p.inv_ts = 1.0f / (float)tile_size;
  p.cull_alpha = cull_alpha;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* n_live = s.scalars;
  int* n_surv = s.scalars + 1;
  int* total_blk = s.scalars + 2;
#define LAUNCHED()                              \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)
  count_kernel<<<nb, GAUSS_THREADS, 0, st>>>(p, s.kept, s.part, s.part_o0, s.part_o1);
  LAUNCHED();
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(s.part, nb, n_live, s.hist, 2 * T);
  LAUNCHED();
  emit_kernel<<<nb, GAUSS_THREADS, 0, st>>>(p, s.kept, s.part, s.off, s.ent_tile, s.ent_gauss,
                                            s.hist);
  LAUNCHED();
  layout_kernel<<<1, SCAN_THREADS, 0, st>>>(s.hist, T, K, EB, s.part_o0, s.part_o1, nb,
                                            s.bstart, counts, pstart_blk, s.cumblk, total_blk,
                                            overflow_parts, overflow);
  LAUNCHED();
  const long long chunks = (E_max + SCATTER_CHUNK - 1) / SCATTER_CHUNK;
  const int sgrid = (int)(chunks < 1 ? 1 : (chunks < SCATTER_BLOCKS ? chunks : SCATTER_BLOCKS));
  scatter_kernel<<<sgrid, SCATTER_THREADS, 0, st>>>(s.ent_tile, s.ent_gauss, depth, n_live,
                                                    s.bstart, s.fill, s.bucket, T);
  LAUNCHED();
  int* ent_pos = s.ent_tile;
  sort_kernel<<<T, SORT_THREADS, SMEM_KEYS * sizeof(u64), st>>>(
      s.bucket, s.hist, s.bstart, counts, pstart_blk, s.ent_gauss, ent_pos, index_matrix, K, N,
      P_cap);
  LAUNCHED();
  gcount_kernel<<<nb, GAUSS_THREADS, 0, st>>>(s.kept, s.off, ent_pos, N, P_cap, s.ksurv,
                                              s.part2);
  LAUNCHED();
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(s.part2, nb, n_surv, nullptr, 0);
  LAUNCHED();
  gemit_kernel<<<nb, GAUSS_THREADS, 0, st>>>(s.kept, s.off, ent_pos, s.ksurv, s.part2, N, P_cap,
                                             g_last, gsort_pos, gseg_start);
  LAUNCHED();
  slab_kernel<<<EB, SLAB, 0, st>>>(s.cumblk, pstart_blk, counts, index_matrix, total_blk, n_surv,
                                   T, K, N, P_cap, owner_blk, seg_first, gauss_of_pos, gsort_pos,
                                   gseg_start);
  LAUNCHED();
#undef LAUNCHED
  return 0;
}
