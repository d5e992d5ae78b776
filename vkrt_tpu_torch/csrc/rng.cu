// The RNG prologue: the pixel seeds (TEA) and the correlated draw tables.
//
// Replaces no Pallas kernel: the JAX package computes both in XLA
// (vkrt_tpu/ops/rng.py::tea, block_uniform_table, corr_draws). Their plain
// PyTorch versions (vkrt_tpu_torch/ops/rng.py) run TEA in int64 tensors
// masked to 32 bits, about 22 elementwise launches a round, because torch
// has no uint32 shifts on the CPU; on the card that is hundreds of
// launches a frame, each opened by an upload of a host integer. Here each
// is one launch in native uint32 arithmetic (a logical >> 5, the wrap
// modulo 2^32 for free), the host integers passed as launch scalars.
//
// rng_tea_kernel: one thread a lane, TEA of (the low 32 bits of val0[i],
// val1) over `rounds` rounds, written as int32 bits: the seeds
// (16 rounds over every pixel id) and the alpha tracer's punch draws (8).
// What bounds it: operations. A round is 10 integer instructions a lane at
// the least (per half: one shift-add for (v << 4) + k, one add of the sum,
// one shift-add for (v >> 5) + k, one three-way xor, one accumulate), at
// 128 a clock an SM: the combined issue limit of the INT32 pipe (64 lanes)
// and the IMAD work the compiler can move onto the FMA pipe, an optimistic
// bound; the 8-byte id read and the 4-byte seed written weigh less (16
// rounds over 8.3 M pixels: 0.040 ms of instructions against 0.030 ms of
// bytes).
//
// rng_table_kernel: one correlated draw table for one bounce. Row i is
// tea(i, corr_seed ^ depth * 0x85EBCA6B, 8) followed by 6 LCG draws
// u = (s & 0xFFFFFF) * 2^-24. Without `lanes` one thread writes one row of
// the (G, 8) f32 table kernel B reads (columns 6-7 zero). With `lanes` one
// block computes its row once, keeps it in shared memory and writes the
// per-lane (n, 6) view: each `block` consecutive lanes share the row, the
// last block ragged. What bounds that: bytes, 24 written a lane (the row's
// arithmetic is once a block); the stores are float2, coalesced.
//
// The constants are ops/rng.py's (tests/test_torch_rng_camera.py reads
// them from this source). No product here has anything to contract with,
// and the f32 draw is exact: a 24-bit integer times a power of two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kTeaDelta = 0x9E3779B9u;
constexpr uint32_t kTeaKey0 = 0xA341316Cu;
constexpr uint32_t kTeaKey1 = 0xC8013EA4u;
constexpr uint32_t kTeaKey2 = 0xAD90777Du;
constexpr uint32_t kTeaKey3 = 0x7E95761Eu;
constexpr uint32_t kLcgA = 1664525u;
constexpr uint32_t kLcgC = 1013904223u;
constexpr uint32_t kDepthKey = 0x85EBCA6Bu;
constexpr int kDraws = 6;         // ops/rng.py CORR_DRAWS
constexpr int kTableCols = 8;     // the (G, 8) table kernel B reads
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1, int rounds) {
  uint32_t s0 = 0;
  for (int r = 0; r < rounds; ++r) {
    s0 += kTeaDelta;
    v0 += ((v1 << 4) + kTeaKey0) ^ (v1 + s0) ^ ((v1 >> 5) + kTeaKey1);
    v1 += ((v0 << 4) + kTeaKey2) ^ (v0 + s0) ^ ((v0 >> 5) + kTeaKey3);
  }
  return v0;
}

// one table row: 8 TEA rounds of the row index, then the LCG's 6 draws
__device__ __forceinline__ void table_row(uint32_t row, uint32_t key, float* u) {
  uint32_t st = tea(row, key, 8);
#pragma unroll
  for (int k = 0; k < kDraws; ++k) {
    st = st * kLcgA + kLcgC;
    u[k] = __fmul_rn(__uint2float_rn(st & 0x00FFFFFFu), 1.0f / 16777216.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rng_tea_kernel(const T* __restrict__ val0, uint32_t val1, int rounds, int n,
               int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = (int32_t)tea((uint32_t)val0[i], val1, rounds);
}

__global__ void __launch_bounds__(kThreads)
rng_table_kernel(uint32_t corr_seed, uint32_t depth, int n_rows,
                 float* __restrict__ table, float* __restrict__ lanes, int n,
                 int block) {
  const uint32_t key = corr_seed ^ (depth * kDepthKey);
  if (lanes == nullptr) {
    const int row = blockIdx.x * kThreads + threadIdx.x;
    if (row >= n_rows) return;
    float u[kDraws];
    table_row((uint32_t)row, key, u);
    float4* t = reinterpret_cast<float4*>(table + (int64_t)row * kTableCols);
    t[0] = make_float4(u[0], u[1], u[2], u[3]);
    t[1] = make_float4(u[4], u[5], 0.f, 0.f);
    return;
  }
  __shared__ float row_u[kDraws];
  const int row = blockIdx.x;
  if (threadIdx.x == 0) {
    float u[kDraws];
    table_row((uint32_t)row, key, u);
#pragma unroll
    for (int k = 0; k < kDraws; ++k) row_u[k] = u[k];
  }
  __syncthreads();
  const int64_t first = (int64_t)row * block;
  const int count = (int)((int64_t)n - first < block ? (int64_t)n - first : block);
  // a lane's 6 floats are 3 float2 (24 B a lane keeps every lane 8-aligned)
  float2* out = reinterpret_cast<float2*>(lanes + first * kDraws);
  for (int j = threadIdx.x; j < count * (kDraws / 2); j += kThreads) {
    const int p = 2 * (j % (kDraws / 2));
    out[j] = make_float2(row_u[p], row_u[p + 1]);
  }
}

}  // namespace

extern "C" int vkrt_rng_tea(const void* val0, int val0_is_64, unsigned int val1,
                            int rounds, int n, void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    if (val0_is_64) {
      rng_tea_kernel<int64_t><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const int64_t*)val0, val1, rounds, n, (int32_t*)out);
    } else {
      rng_tea_kernel<int32_t><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)val0, val1, rounds, n, (int32_t*)out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int vkrt_rng_table(unsigned int corr_seed, unsigned int depth, int n_rows,
                              void* table, void* lanes, int n, int block,
                              void* stream) {
  if (n_rows > 0) {
    const int blocks = lanes ? n_rows : (n_rows + kThreads - 1) / kThreads;
    rng_table_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        corr_seed, depth, n_rows, (float*)table, (float*)lanes, n, block);
  }
  return (int)cudaGetLastError();
}
