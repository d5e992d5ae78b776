// Kernel A: closest / first-hit-kills ray-triangle trace over a BVH.
//
// Replaces vkrt_tpu/ops/pallas/trace.py::_trace_kernel (launched by
// _packed_trace). The TPU kernel votes 1024-ray blocks over a 16-ary
// cluster tree with bit-packed box votes and pre-pivoted triangle tables,
// because Mosaic has no per-lane gathers. A GPU thread gathers freely, so
// here each thread walks its own ray down the binary SAH tree that
// native/bvh_builder.cpp builds (one triangle per leaf).
//
// What binds it on this card: not the card's rates but the latency of a
// chain of dependent, divergent loads (the next node is known only when
// this one's boxes are tested) and the lanes of a warp that idle while its
// slowest ray walks on; the arithmetic is 26 FP32 instructions a box and
// 52 a triangle, far below the FP32 rate, and the tables stay in L2. The
// design therefore makes the chain short and each link wide (walk.cuh):
//   - front to back: the nearer child first, the farther on a short stack
//     with its entry distance, so the closest hit shrinks the search early
//     and most of the tree is culled when it is popped;
//   - an inner node holds both children's boxes and references in one
//     64-byte record: one round of four independent 16-byte loads a level,
//     where a table of single boxes needs two dependent rounds;
//   - a triangle is one 48-byte record, three 16-byte loads of adjacent
//     bytes, in leaf order;
//   - the stack is 32 entries of 8 bytes a thread in local memory, served
//     by L1: in shared memory it halves the blocks an SM holds, and
//     measured slower on every ray set (walk.cuh);
//   - equal-t ties go to the lower triangle id, so the result does not
//     depend on the order of the walk.
//
// Contract (the Pallas kernel's): per-lane limit t_lim; t_lim < 0 (or
// any_hit) is a first-hit-kills lane that stops at its first hit with t in
// (t_min, |t_lim|); on a miss t = |t_lim|, tri = -1, u = v = 0. The MT test
// is vkrt_tpu/ops/intersect.py::mt_block (det eps 1e-9, u >= 0, v >= 0,
// u + v <= 1, t_min < t < t_best) and the slab test nudges zero direction
// components to +-1e-20 as safe_inv_dir does.

#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
trace_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
             Rays rays, float t_min, int any_hit, Hits out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = load_ray(rays, i);
  const float lim = rays.t_lim[i];
  Best b = {fabsf(lim), -1, 0.f, 0.f};
  unsigned visits = 0, leaves = 0;  // unused: kFull counts nothing
  walk<kFull>(nodes, tris, 0, r, t_min, any_hit != 0 || lim < 0.f, b, visits,
              leaves);
  store_hit(out, i, b);
}

}  // namespace

extern "C" int vkrt_trace(const void* nodes, const void* tris, int max_depth,
                          const void* o, int64_t o_sl, int64_t o_sc,
                          const void* d, int64_t d_sl, int64_t d_sc,
                          const void* t_lim, int n, float t_min, int any_hit,
                          void* t_out, void* tri_out, void* u_out, void* v_out,
                          void* stream) {
  if (max_depth > kStack) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const Rays rays = {(const float*)o, o_sl, o_sc, (const float*)d, d_sl, d_sc,
                     (const float*)t_lim, n};
  const Hits out = {(float*)t_out, (int*)tri_out, (float*)u_out, (float*)v_out};
  const int blocks = (n + kThreads - 1) / kThreads;
  trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float4*)tris, rays, t_min, any_hit, out);
  return (int)cudaGetLastError();
}

// What the compiler made of kernel A: registers a thread, static shared
// memory and local memory (stack frame) in bytes a block / a thread, and
// the blocks of kThreads an SM holds at once.
extern "C" int vkrt_trace_info(int* regs, int* shared_bytes, int* local_bytes,
                               int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, trace_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *shared_bytes = (int)attr.sharedSizeBytes;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, trace_kernel, kThreads, 0);
}
