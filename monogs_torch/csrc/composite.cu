// Slab alpha compositing, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels in monogs_tpu/ops/tile_raster.py:
//   slab_fwd  <- _slab_fwd_kernel (launched by _fwd_slab)
//   slab_bwd  <- _slab_bwd_kernel (launched by _bwd_slab, via _composite_bwd)
// tile_order is a scheduling step of both (no TPU counterpart: the Pallas
// grid ran in order). The plain PyTorch twins are _fwd_slab_plain,
// _bwd_slab_plain and _tile_order_plain in monogs_torch/ops/tile_raster.py;
// the ctypes binding is ops/kernels.py.
//
// What bounds them on the H100: issued instructions, not bytes. A tile's
// ~40 bytes of features per slot are shared by all its pixels. Every live
// (pixel, slot) pair pays for its alpha (one expf and ~16 float32
// operations); only a warp-slot with some nonzero alpha (about a quarter
// of them on the SLAM workloads) pays for the rest: ~8 operations a pair
// in the forward, ~27, an IEEE divide and the warp reduction in the
// backward. On an H100 SXM at 700 W the alpha alone is ~85% of the
// forward's time and ~40% of the backward's at the mapping workload
// (PERF.md). The work is data-dependent: a tile walks ceil(count / 128)
// chunks and stops once every pixel saturates, and tile counts differ.
//
// Design. One thread block owns one (global) tile and walks its whole
// segment, carrying each pixel's transmittance in registers (the Pallas
// grid carried log T across steps in VMEM scratch).
//   - PX = 4 pixels per thread, consecutive in one tile row (256 threads at
//     tile 32, 64 at tile 16): dy and c dy^2 are shared, the slot's
//     features are read from shared memory once per thread (a slot-major
//     staging of each 128-slot chunk, three float4 broadcasts a slot), and
//     a slot whose alpha is zero on all 128 pixels of a warp (one vote) is
//     skipped there: its T, sums and gradients would not change.
//   - Linear transmittance: T <- T (1 - alpha), front to back, in the same
//     operations in both kernels, so the backward replays the forward's T
//     bit for bit. The image's weights use it, so expf(power) (and the
//     backward's IEEE divide S / (1 - alpha)) is the only transcendental
//     work a pair needs for the image; the log-space twins need two expf
//     and a log1pf.
//   - The chunk skip keeps the TPU rule as one block-wide vote per chunk
//     (__syncthreads_or over all pixels, padding pixels included) on the
//     twin's own quantity: log T, the running float32 sum of log1pf(-alpha)
//     in slot order, > LOG_SKIP. Both kernels carry it beside T (one log1pf
//     a pair on the warp-slots with some alpha). A vote on the linear T >
//     expf(LOG_SKIP) decides apart from the twin's wherever a tile's
//     largest T lies within rounding of 1e-4 at a chunk boundary (log T's
//     resolution there is ~8 ulps of T): one side then walks a chunk the
//     other does not, and the image differs by up to that T times a colour
//     (~5e-5 against the 1e-5 rgb tolerance); the boundary-tile test in
//     tests/test_torch_kernels.py builds such tiles.
//   - The touched variant (visibility renders only) computes the image
//     exactly as the hot variant, and adds the twin's expf(log T + excl)
//     only for the T > 1e-4 test of `touched`: its image is bit-identical
//     to the hot variant's and `touched` to the twin's. Per slot, touched
//     counts hits with one warp reduction and a fixed-order sum over warps.
//   - Backward reduction without atomics, deterministic: a thread adds its
//     4 pixels' moments in registers in a fixed order, forms the slot's 10
//     gradients, and a reduce-scatter butterfly (12 shuffles: each xor
//     step sends half the values a lane holds) leaves each gradient's warp
//     sum in one lane; per-warp partials go to double-buffered shared
//     memory (one barrier per 32-slot sub-chunk), and all threads then sum
//     them over warps in a fixed order and write each slab column once.
//   - Heaviest tiles first: tile_order sorts the tiles by descending chunk
//     count (a stable counting sort in one block, on the device, no host
//     sync), and block b takes tile order[b]. The caller builds one order
//     for a forward and its backward (tile_raster.composite_slab).
// Launch bounds (256, 2): at most 128 registers, two or more blocks an SM.
// The build passes -fmad=false and no fast math, so alpha and the
// touched-variant log T are computed operation by operation as the twins
// compute them (expf / log1pf are the libdevice calls torch.exp /
// torch.log1p make): alpha is bit-exact and `touched` matches its twin bit
// for bit. Explicit __fmaf_rn appears only downstream of alpha. Launches go
// to the caller's stream; nothing is allocated or synchronised.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;
constexpr int SLAB = 512;
constexpr int NFEAT = 10;
constexpr int FEAT_ROWS = 16;
constexpr int PX = 4;             // pixels per thread, consecutive in a row
constexpr int MAX_THREADS = 256;  // a 1024-pixel tile over PX
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int SUB = 32;           // backward sub-chunk slots
constexpr int SF4 = 3;            // float4s a staged slot: [u v a b] [c opa r g] [b d - -]
constexpr int NB = 64;            // tile-order buckets of chunk counts
constexpr int ORDER_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
// The Python constants rounded to float32 once, as the plain twins see them.
constexpr float ALPHA_EPS = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr float TOUCH_T_MIN = (float)1e-4;
constexpr float LOG_SKIP = (float)-9.2103;

struct Tile {
  int t;           // global tile id
  float ox, oy;    // tile origin in the image
  float x[PX], y;  // this thread's pixel centres, tile-local
  bool valid[PX];  // the pixel lies inside the image
  int p0;          // index of the thread's first pixel in the tile
  int nch;
  const float* f;  // channel 0 of the tile's segment
  long long col;   // offset of the segment's first column in the slab
};

__device__ __forceinline__ Tile tile_of(const float* feats, const int* order,
                                        const int* pstart_blk, const int* counts, int E_cap,
                                        int num_tiles, int tiles_x, int tile_size, int img_w,
                                        int img_h) {
  Tile s;
  s.t = order[blockIdx.x];
  const int tl = s.t % num_tiles;
  s.ox = (float)((tl % tiles_x) * tile_size);
  s.oy = (float)((tl / tiles_x) * tile_size);
  const int groups = tile_size / PX;
  const int row = threadIdx.x / groups, x0 = (threadIdx.x % groups) * PX;
  s.p0 = row * tile_size + x0;
  s.y = (float)row + 0.5f;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    s.x[i] = (float)(x0 + i) + 0.5f;
    s.valid[i] = (s.ox + s.x[i] - 0.5f < (float)img_w) && (s.oy + s.y - 0.5f < (float)img_h);
  }
  s.nch = (counts[s.t] + CHUNK - 1) / CHUNK;
  const long long g = (long long)pstart_blk[s.t] * SLAB;
  const long long img = g / E_cap;
  s.col = g - img * E_cap;
  s.f = feats + img * FEAT_ROWS * (long long)E_cap;
  return s;
}

// One chunk's 10 feature rows, channel-major in the slab, into slot-major
// shared memory (three float4 a slot).
__device__ __forceinline__ void load_chunk(float4* sf, const float* f, long long E_cap,
                                           long long col) {
  float* s = reinterpret_cast<float*>(sf);
  for (int i = threadIdx.x; i < NFEAT * CHUNK; i += blockDim.x) {
    const int c = i / CHUNK, k = i % CHUNK;
    s[k * 4 * SF4 + c] = f[c * E_cap + col + k];
  }
}

struct Slot {
  float u, v, a, b, c, opa, cr, cg, cb, cd;
};

__device__ __forceinline__ Slot slot_at(const float4* sf, int k, const Tile& s) {
  const float4 q0 = sf[k * SF4], q1 = sf[k * SF4 + 1], q2 = sf[k * SF4 + 2];
  Slot r;
  r.u = q0.x - s.ox;
  r.v = q0.y - s.oy;
  r.a = q0.z;
  r.b = q0.w;
  r.c = q1.x;
  r.opa = q1.y;
  r.cr = q1.z;
  r.cg = q1.w;
  r.cb = q2.x;
  r.cd = q2.y;
  return r;
}

// Per-(pixel, slot) alpha, in the plain twin's operation order.
struct Alpha {
  float dx, expp, alpha_raw, alpha;
  bool ok;
};

__device__ __forceinline__ Alpha alpha_of(const Slot& q, float x, float dy) {
  Alpha r;
  r.dx = x - q.u;
  const float power = -0.5f * (q.a * r.dx * r.dx + q.c * dy * dy) - q.b * r.dx * dy;
  r.expp = expf(fminf(power, 0.0f));
  r.alpha_raw = q.opa * r.expp;
  r.ok = (power <= 0.0f) && (r.alpha_raw >= ALPHA_EPS);
  r.alpha = r.ok ? fminf(r.alpha_raw, ALPHA_MAX) : 0.0f;
  return r;
}

template <bool TOUCHED>
__global__ void __launch_bounds__(MAX_THREADS, 2)
slab_fwd_kernel(const float* __restrict__ feats, const int* __restrict__ pstart_blk,
                const int* __restrict__ counts, const int* __restrict__ order,
                float* __restrict__ out, int* __restrict__ touched, int E_cap, int num_tiles,
                int tiles_x, int tile_size, int img_w, int img_h, int K) {
  __shared__ float4 sf[CHUNK * SF4];
  __shared__ int scnt[TOUCHED ? MAX_WARPS : 1][CHUNK];
  const Tile s = tile_of(feats, order, pstart_blk, counts, E_cap, num_tiles, tiles_x,
                         tile_size, img_w, img_h);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float T[PX], logT[PX], acc[PX][5];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    T[i] = 1.0f;
    logT[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[i][c] = 0.0f;
  }
  int j = 0;
  for (; j < s.nch; ++j) {
    bool lv = false;
#pragma unroll
    for (int i = 0; i < PX; ++i) lv = lv || logT[i] > LOG_SKIP;
    if (!__syncthreads_or(lv)) break;
    load_chunk(sf, s.f, E_cap, s.col + (long long)j * CHUNK);
    __syncthreads();
    float excl[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) excl[i] = 0.0f;
    for (int k = 0; k < CHUNK; ++k) {
      const Slot q = slot_at(sf, k, s);
      const float dy = s.y - q.v;
      Alpha r[PX];
      bool any = false;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        r[i] = alpha_of(q, s.x[i], dy);
        any = any || r[i].ok;
      }
      int hits = 0;
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const float w = r[i].alpha * T[i];
          acc[i][0] = __fmaf_rn(w, q.cr, acc[i][0]);
          acc[i][1] = __fmaf_rn(w, q.cg, acc[i][1]);
          acc[i][2] = __fmaf_rn(w, q.cb, acc[i][2]);
          acc[i][3] = __fmaf_rn(w, q.cd, acc[i][3]);
          acc[i][4] = acc[i][4] + w;
          T[i] = T[i] * (1.0f - r[i].alpha);
          if (TOUCHED) {
            const float Tk = expf(logT[i] + excl[i]);
            hits += (r[i].ok && Tk > TOUCH_T_MIN && s.valid[i]) ? 1 : 0;
          }
          excl[i] = excl[i] + log1pf(-r[i].alpha);
        }
      }
      if (TOUCHED) {
        const int n = __reduce_add_sync(FULL, hits);
        if (lane == 0) scnt[warp][k] = n;
      }
    }
#pragma unroll
    for (int i = 0; i < PX; ++i) logT[i] = logT[i] + excl[i];
    if (TOUCHED) {
      __syncthreads();
      for (int k = threadIdx.x; k < CHUNK; k += blockDim.x) {
        int n = 0;
        for (int w = 0; w < nwarps; ++w) n += scnt[w][k];
        touched[(long long)s.t * K + j * CHUNK + k] = n;
      }
    }
  }
  if (TOUCHED) {
    for (int k = j * CHUNK + threadIdx.x; k < K; k += blockDim.x)
      touched[(long long)s.t * K + k] = 0;
  }
  float4* o = reinterpret_cast<float4*>(out + ((long long)s.t * blockDim.x * PX + s.p0) * 8);
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    o[2 * i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[2 * i + 1] = make_float4(acc[i][4], 0.0f, 0.0f, 0.0f);
  }
}

// One reduce-scatter step across lanes `m` apart: a lane keeps the first
// half of its N values (the second if its `m` bit is set), sends the other
// half to its partner, and adds what the partner sent.
template <int N>
__device__ __forceinline__ void rs_step(const float (&v)[N], float (&o)[(N + 1) / 2], int m,
                                        bool hi) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo_v = v[j];
    const float hi_v = (j + H < N) ? v[j + H] : 0.0f;
    const float recv = __shfl_xor_sync(FULL, hi ? lo_v : hi_v, m);
    o[j] = (hi ? hi_v : lo_v) + recv;
  }
}

// Warp sums of 10 values in 5 + 3 + 2 + 1 + 1 shuffles: lane l ends up with
// the sum of value rs_index(l) (valid where rs_writer(l)).
__device__ __forceinline__ float reduce_scatter10(const float (&d)[NFEAT], int lane) {
  float r5[5], r3[3], r2[2], r1[1];
  rs_step<10>(d, r5, 16, lane & 16);
  rs_step<5>(r5, r3, 8, lane & 8);
  rs_step<3>(r3, r2, 4, lane & 4);
  rs_step<2>(r2, r1, 2, lane & 2);
  return r1[0] + __shfl_xor_sync(FULL, r1[0], 1);
}

__device__ __forceinline__ int rs_index3(int lane) {
  return ((lane & 4) ? 2 : 0) + ((lane & 2) ? 1 : 0);
}
__device__ __forceinline__ int rs_index5(int lane) {
  return ((lane & 8) ? 3 : 0) + rs_index3(lane);
}
__device__ __forceinline__ int rs_index(int lane) {
  return ((lane & 16) ? 5 : 0) + rs_index5(lane);
}
__device__ __forceinline__ bool rs_writer(int lane) {
  return rs_index3(lane) < 3 && rs_index5(lane) < 5 && !(lane & 1);
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
slab_bwd_kernel(const float* __restrict__ feats, const int* __restrict__ pstart_blk,
                const int* __restrict__ counts, const int* __restrict__ order,
                const float* __restrict__ baux, float* __restrict__ dfeats, int E_cap,
                int num_tiles, int tiles_x, int tile_size, int img_w, int img_h) {
  __shared__ float4 sf[CHUNK * SF4];
  __shared__ float part[2][MAX_WARPS][NFEAT][SUB + 1];
  const Tile s = tile_of(feats, order, pstart_blk, counts, E_cap, num_tiles, tiles_x,
                         tile_size, img_w, img_h);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int P = blockDim.x * PX;
  const float* bx = baux + (long long)s.t * 8 * P + s.p0;
  float g[5][PX], A[PX], T[PX], logT[PX], pref[PX];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(bx + c * P);
    g[c][0] = v.x, g[c][1] = v.y, g[c][2] = v.z, g[c][3] = v.w;
  }
  {
    const float4 v = *reinterpret_cast<const float4*>(bx + 5 * P);
    A[0] = v.x, A[1] = v.y, A[2] = v.z, A[3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < PX; ++i) T[i] = 1.0f, logT[i] = 0.0f, pref[i] = 0.0f;
  float* df = dfeats + (s.f - feats);
  const int vidx = rs_index(lane);
  const bool writer = rs_writer(lane);
  for (int j = 0; j < s.nch; ++j) {
    bool lv = false;
#pragma unroll
    for (int i = 0; i < PX; ++i) lv = lv || logT[i] > LOG_SKIP;
    if (!__syncthreads_or(lv)) break;
    const long long col0 = s.col + (long long)j * CHUNK;
    load_chunk(sf, s.f, E_cap, col0);
    __syncthreads();
    float excl[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) excl[i] = 0.0f;
    for (int sub = 0; sub < CHUNK / SUB; ++sub) {
      float(*pw)[SUB + 1] = part[sub & 1][warp];
      for (int kk = 0; kk < SUB; ++kk) {
        const Slot q = slot_at(sf, sub * SUB + kk, s);
        const float dy = s.y - q.v;
        Alpha r[PX];
        bool any = false;
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          r[i] = alpha_of(q, s.x[i], dy);
          any = any || r[i].ok;
        }
        float dsum = 0.0f;
        if (__any_sync(FULL, any)) {
          // Moments over the thread's pixels: sum dp, dp dx, dp dx^2,
          // dar expp and w g_c, with dp = dL/dpower.
          float m_dp = 0.0f, m_dx = 0.0f, m_dxx = 0.0f, m_e = 0.0f;
          float m_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < PX; ++i) {
            const float w = r[i].alpha * T[i];
            const float gi = __fmaf_rn(g[3][i], q.cd, __fmaf_rn(g[2][i], q.cb,
                             __fmaf_rn(g[1][i], q.cg, __fmaf_rn(g[0][i], q.cr, g[4][i]))));
            pref[i] = __fmaf_rn(w, gi, pref[i]);
            const float om = 1.0f - r[i].alpha;
            const float dalpha = __fmaf_rn(T[i], gi, -((A[i] - pref[i]) / om));
            const float dar = (r[i].ok && r[i].alpha_raw < ALPHA_MAX) ? dalpha : 0.0f;
            const float dp = dar * r[i].alpha_raw;
            const float dpdx = dp * r[i].dx;
            m_dp = m_dp + dp;
            m_dx = m_dx + dpdx;
            m_dxx = __fmaf_rn(dpdx, r[i].dx, m_dxx);
            m_e = __fmaf_rn(dar, r[i].expp, m_e);
#pragma unroll
            for (int c = 0; c < 4; ++c) m_w[c] = __fmaf_rn(w, g[c][i], m_w[c]);
            T[i] = T[i] * om;
            excl[i] = excl[i] + log1pf(-r[i].alpha);
          }
          const float m_dy = dy * m_dp;
          const float d[NFEAT] = {
              __fmaf_rn(q.a, m_dx, q.b * m_dy),  // u
              __fmaf_rn(q.b, m_dx, q.c * m_dy),  // v
              -0.5f * m_dxx,                     // conic a
              -(dy * m_dx),                      // conic b
              -0.5f * (dy * m_dy),               // conic c
              m_e,                               // opacity
              m_w[0], m_w[1], m_w[2], m_w[3]};   // r, g, b, depth
          dsum = reduce_scatter10(d, lane);
        }
        if (writer) pw[vidx][kk] = dsum;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < NFEAT * SUB; i += blockDim.x) {
        const int v = i / SUB, kk = i % SUB;
        float sum = 0.0f;
        for (int w = 0; w < nwarps; ++w) sum += part[sub & 1][w][v][kk];
        df[v * (long long)E_cap + col0 + sub * SUB + kk] = sum;
      }
    }
#pragma unroll
    for (int i = 0; i < PX; ++i) logT[i] = logT[i] + excl[i];
  }
}

// order <- the tile ids sorted by descending chunk count (capped at NB - 1),
// ties in id order: a stable counting sort in one block, 1024 tiles a round.
__device__ __forceinline__ int order_key(int count) {
  return min((count + CHUNK - 1) / CHUNK, NB - 1);
}

__global__ void __launch_bounds__(ORDER_THREADS)
tile_order_kernel(const int* __restrict__ counts, int* __restrict__ order, int n) {
  constexpr int NW = ORDER_THREADS / 32;
  __shared__ int base[NB];
  __shared__ int wcnt[NW][NB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* flat = &wcnt[0][0];
  for (int i = tid; i < NW * NB; i += ORDER_THREADS) flat[i] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += ORDER_THREADS) atomicAdd(&wcnt[0][order_key(counts[i])], 1);
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int b = NB - 1; b >= 0; --b) {
      base[b] = run;
      run += wcnt[0][b];
    }
  }
  for (int r0 = 0; r0 < n; r0 += ORDER_THREADS) {
    __syncthreads();
    for (int i = tid; i < NW * NB; i += ORDER_THREADS) flat[i] = 0;
    __syncthreads();
    const int i = r0 + tid;
    const bool valid = i < n;
    const int b = valid ? order_key(counts[i]) : NB;
    const unsigned same = __match_any_sync(FULL, b);
    const int rank = __popc(same & ((1u << lane) - 1u));
    if (valid && rank == 0) wcnt[warp][b] = __popc(same);
    __syncthreads();
    if (tid < NB) {
      int run = base[tid];
      for (int w = 0; w < NW; ++w) {
        const int c = wcnt[w][tid];
        wcnt[w][tid] = run;
        run += c;
      }
      base[tid] = run;
    }
    __syncthreads();
    if (valid) order[wcnt[warp][b] + rank] = i;
  }
}

bool bad_tile(int tile_size) {
  const int P = tile_size * tile_size;
  return tile_size <= 0 || tile_size % PX != 0 || P > PX * MAX_THREADS || (P / PX) % 32 != 0;
}

template <typename F>
int kernel_info(F* fn, int threads, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (e != cudaSuccess) return (int)e;
  info[0] = blocks;
  info[1] = a.numRegs;
  info[2] = (int)a.localSizeBytes;
  info[3] = (int)a.sharedSizeBytes;
  info[4] = PX;
  return 0;
}

}  // namespace

// Plain C entry points (ctypes). Each returns cudaGetLastError() after the
// launch; 1 (cudaErrorInvalidValue) for a tile size the kernels do not take
// (tile_size^2 / PX threads must be a multiple of 32 and at most 256).
extern "C" int slab_tile_order(const int* counts, int* order, int n_tiles, void* stream) {
  if (n_tiles == 0) return 0;
  tile_order_kernel<<<1, ORDER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(counts, order,
                                                                              n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int slab_fwd(const float* feats, const int* pstart_blk, const int* counts,
                        const int* order, float* out, int* touched, int n_tiles, int E_cap,
                        int num_tiles, int tiles_x, int tile_size, int img_w, int img_h, int K,
                        int emit_touched, void* stream) {
  if (bad_tile(tile_size)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const int threads = tile_size * tile_size / PX;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (emit_touched) {
    slab_fwd_kernel<true><<<n_tiles, threads, 0, st>>>(feats, pstart_blk, counts, order, out,
                                                       touched, E_cap, num_tiles, tiles_x,
                                                       tile_size, img_w, img_h, K);
  } else {
    slab_fwd_kernel<false><<<n_tiles, threads, 0, st>>>(feats, pstart_blk, counts, order, out,
                                                        touched, E_cap, num_tiles, tiles_x,
                                                        tile_size, img_w, img_h, K);
  }
  return (int)cudaGetLastError();
}

extern "C" int slab_bwd(const float* feats, const int* pstart_blk, const int* counts,
                        const int* order, const float* baux, float* dfeats, int n_tiles,
                        int E_cap, int num_tiles, int tiles_x, int tile_size, int img_w,
                        int img_h, void* stream) {
  if (bad_tile(tile_size)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const int threads = tile_size * tile_size / PX;
  slab_bwd_kernel<<<n_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, pstart_blk, counts, order, baux, dfeats, E_cap, num_tiles, tiles_x, tile_size,
      img_w, img_h);
  return (int)cudaGetLastError();
}

// Launch shape of one slab kernel (0 forward, 1 forward with touched, 2
// backward) at `threads` a block: info <- [blocks an SM, registers, local
// (spill) bytes, static shared bytes, PX].
extern "C" int slab_kernel_info(int which, int threads, int* info) {
  switch (which) {
    case 0: return kernel_info(slab_fwd_kernel<false>, threads, info);
    case 1: return kernel_info(slab_fwd_kernel<true>, threads, info);
    case 2: return kernel_info(slab_bwd_kernel, threads, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
