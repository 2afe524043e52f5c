// Throughput probe of one float32 op class, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `op_microbench` in scripts/bench_roofline.py (its
// Pallas body `kern`, launched by pl.pallas_call). The plain PyTorch twin
// is `op_chain_plain` in monogs_torch/tools/roofline.py; the ctypes binding
// is `op_microbench` in monogs_torch/ops/kernels.py.
//
// What it computes: x is (blocks, E) float32 with E = P * C elements a
// block. Every element runs `lanes` independent chains of `n_rep` steps of
// one op, started at x * (1 + 0.01 k), in the TPU probe's per-step math:
//   fma:   a * 0.9995 + 1e-4 (k+1)
//   exp:   expf(-|a|) + 1e-3 (k+1)
//   log1p: -log1pf(-min(|a|, 0.9)) + 1e-3 (k+1)
//   div:   1 / (|a| + 1 + 1e-3 (k+1))
// The lanes are summed in order, and out (E,) holds each element's maximum
// over the blocks. The chains stay positive for x >= 0, so the maximum is
// taken on the float bits with an integer atomicMax, which does not depend
// on the order of the atomics: the result is deterministic, and it depends
// on every block's work, so the compiler cannot drop any chain.
//
// Build: the same nvcc flags as composite.cu, -fmad=false included, and no
// fast math. So the "fma" probe times a separate multiply and add, and
// expf / log1pf are the same full-precision libdevice sequences that the
// slab kernels run: the measured rates are the rates those kernels' own
// instructions get.
//
// What bounds it: operations. Each step is 2 float32 operations (fma,
// div's reciprocal counted as one) or one transcendental plus 2; the input
// is read once (128 MB at the probe's 256 x 1024 x 128) and is tiny next
// to n_rep * lanes steps per element.
//
// Design: one thread per element per block group. Grid (ceil(E / 256),
// groups): the thread of group g walks blocks g, g + groups, ..., keeps a
// running maximum in a register and ends with one atomicMax. The `lanes`
// chains are independent, so each thread has that much instruction-level
// parallelism; 256-thread blocks over E / 256 x groups give every SM many
// warps. Launches go to the caller's stream; nothing is allocated or
// synchronised.

#include <cuda_runtime.h>

namespace {

enum Op { FMA = 0, EXP = 1, LOG1P = 2, DIV = 3 };
constexpr int MAX_LANES = 8;
constexpr int THREADS = 256;

template <int OP>
__device__ __forceinline__ float step(float a, float c) {
  if (OP == FMA) return a * 0.9995f + c;
  if (OP == EXP) return expf(-fabsf(a)) + c;
  if (OP == LOG1P) return -log1pf(-fminf(fabsf(a), 0.9f)) + c;
  return 1.0f / ((fabsf(a) + 1.0f) + c);
}

template <int OP, int LANES>
__global__ void __launch_bounds__(THREADS)
microbench_kernel(const float* __restrict__ x, unsigned* __restrict__ out_bits,
                  long long E, int blocks, int n_rep) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  // The per-lane constants as the plain twin sees them: a Python double
  // rounded once to float32.
  float scale[LANES], add[LANES];
#pragma unroll
  for (int k = 0; k < LANES; ++k) {
    scale[k] = (float)(1.0 + 0.01 * k);
    add[k] = (float)((OP == FMA ? 1e-4 : 1e-3) * (k + 1));
  }
  float best = 0.0f;
  for (int b = blockIdx.y; b < blocks; b += gridDim.y) {
    const float xv = x[(long long)b * E + e];
    float acc[LANES];
#pragma unroll
    for (int k = 0; k < LANES; ++k) acc[k] = xv * scale[k];
    for (int i = 0; i < n_rep; ++i) {
#pragma unroll
      for (int k = 0; k < LANES; ++k) acc[k] = step<OP>(acc[k], add[k]);
    }
    float s = acc[0];
#pragma unroll
    for (int k = 1; k < LANES; ++k) s = s + acc[k];
    best = fmaxf(best, s);
  }
  atomicMax(out_bits + e, __float_as_uint(best));
}

template <int OP>
int launch(const float* x, unsigned* out, long long E, int blocks, int n_rep,
           int lanes, int groups, cudaStream_t st) {
  const dim3 grid((unsigned)((E + THREADS - 1) / THREADS), (unsigned)groups);
  switch (lanes) {
    case 1: microbench_kernel<OP, 1><<<grid, THREADS, 0, st>>>(x, out, E, blocks, n_rep); break;
    case 2: microbench_kernel<OP, 2><<<grid, THREADS, 0, st>>>(x, out, E, blocks, n_rep); break;
    case 4: microbench_kernel<OP, 4><<<grid, THREADS, 0, st>>>(x, out, E, blocks, n_rep); break;
    case 8: microbench_kernel<OP, 8><<<grid, THREADS, 0, st>>>(x, out, E, blocks, n_rep); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (ctypes). `out` must hold E zero words. Returns
// cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for an
// op, lane count or shape the kernel does not take.
extern "C" int op_microbench(const float* x, unsigned* out, long long E, int blocks,
                             int n_rep, int lanes, int op, int groups, void* stream) {
  if (E <= 0 || blocks <= 0 || n_rep < 0 || groups <= 0 || lanes > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case FMA: return launch<FMA>(x, out, E, blocks, n_rep, lanes, groups, st);
    case EXP: return launch<EXP>(x, out, E, blocks, n_rep, lanes, groups, st);
    case LOG1P: return launch<LOG1P>(x, out, E, blocks, n_rep, lanes, groups, st);
    case DIV: return launch<DIV>(x, out, E, blocks, n_rep, lanes, groups, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
