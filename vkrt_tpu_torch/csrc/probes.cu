// Kernels C and F: the trace probes that need no scene.
//
// C, floor: replaces benchmarks/micro_trace.py::bench_floor (the empty
// Pallas kernel launched at :51 that reads a (rows, 6*128) ray block and
// writes a (rows, 4*128) block of zeros: the per-program floor of the
// trace kernel). Here one thread per ray reads kernel A's ray record (o and
// d through the same strided views, t_lim) and writes kernel A's miss
// record (t = |t_lim|, tri = -1, u = v = 0): kernel A's I/O with no
// traversal. It is bound by bytes: 28 B read and 16 B written per ray, so
// 921,600 rays move 40.6 MB, 12.1 us at 3.35 TB/s; below that size the
// launch itself binds. The o and d loads are volatile so the compiler
// keeps them although nothing reads their values. The block size is a
// launch parameter (128..1024 threads), the counterpart of the TPU
// probe's rows per program.
//
// F, fma_peak: replaces benchmarks/scratch/vpupeak.py::kernel (launched at
// :65): the FP32 FMA rate the trace kernel's arithmetic is held to. Each
// thread runs 8 independent chains a = fmaf(a, 1.0000001f, 1e-7f), 8 steps
// per chain per iteration, and writes the sum of the chains, so each
// element costs 64 FMAs per iteration. It is bound by operations: at 67
// TFLOP/s FP32 (H100 SXM, FMA = 2 FLOPs) 65,536 elements x 65,536 FMAs take
// 128 us. Eight chains cover the FMA latency; the iteration count is a
// runtime argument and the sum is stored, so nvcc can neither unroll the
// loop away nor fold it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void floor_kernel(const float* __restrict__ o, int64_t o_sl,
                             int64_t o_sc, const float* __restrict__ d,
                             int64_t d_sl, int64_t d_sc,
                             const float* __restrict__ t_lim, int n,
                             float* __restrict__ t_out,
                             int* __restrict__ tri_out,
                             float* __restrict__ u_out,
                             float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const volatile float* vo = o + (int64_t)i * o_sl;
  const volatile float* vd = d + (int64_t)i * d_sl;
  const float ox = vo[0], oy = vo[o_sc], oz = vo[2 * o_sc];
  const float dx = vd[0], dy = vd[d_sc], dz = vd[2 * d_sc];
  (void)ox, (void)oy, (void)oz, (void)dx, (void)dy, (void)dz;
  t_out[i] = fabsf(t_lim[i]);
  tri_out[i] = -1;
  u_out[i] = 0.f;
  v_out[i] = 0.f;
}

constexpr int kFmaThreads = 128;

__global__ void __launch_bounds__(kFmaThreads)
fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                int iters) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float c = 1.0000001f, b = 1e-7f;
  const float xv = x[i];
  // the start multipliers are (0.9 + 0.01 k) in double, rounded to f32, as
  // Python's float folds into the JAX kernel's f32 product
  float a0 = xv * (float)(0.9 + 0.01 * 0), a1 = xv * (float)(0.9 + 0.01 * 1);
  float a2 = xv * (float)(0.9 + 0.01 * 2), a3 = xv * (float)(0.9 + 0.01 * 3);
  float a4 = xv * (float)(0.9 + 0.01 * 4), a5 = xv * (float)(0.9 + 0.01 * 5);
  float a6 = xv * (float)(0.9 + 0.01 * 6), a7 = xv * (float)(0.9 + 0.01 * 7);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      a0 = fmaf(a0, c, b);
      a1 = fmaf(a1, c, b);
      a2 = fmaf(a2, c, b);
      a3 = fmaf(a3, c, b);
      a4 = fmaf(a4, c, b);
      a5 = fmaf(a5, c, b);
      a6 = fmaf(a6, c, b);
      a7 = fmaf(a7, c, b);
    }
  }
  out[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(
               __fadd_rn(a0, a1), a2), a3), a4), a5), a6), a7);
}

}  // namespace

extern "C" int vkrt_floor(const void* o, int64_t o_sl, int64_t o_sc,
                          const void* d, int64_t d_sl, int64_t d_sc,
                          const void* t_lim, int n, int threads, void* t_out,
                          void* tri_out, void* u_out, void* v_out,
                          void* stream) {
  if (n > 0) {
    const int blocks = (n + threads - 1) / threads;
    floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)o, o_sl, o_sc, (const float*)d, d_sl, d_sc,
        (const float*)t_lim, n, (float*)t_out, (int*)tri_out, (float*)u_out,
        (float*)v_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int vkrt_fma_peak(const void* x, void* out, int n, int iters,
                             void* stream) {
  if (n > 0) {
    const int blocks = (n + kFmaThreads - 1) / kFmaThreads;
    fma_peak_kernel<<<blocks, kFmaThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, n, iters);
  }
  return (int)cudaGetLastError();
}
