// The texel fetch: one launch a sample_* call of ops/texture.py, one thread
// a lane, writing the (N, 4) f32 RGBA.
//
// Replaces no Pallas kernel: the JAX package fetches texels in XLA
// (vkrt_tpu/ops/texture.py), whose gathers the TPU fuses. The port's plain
// PyTorch version (ops/texture.py) indexes a (M, 4) texel table with int64
// row ids; on this card that dispatches to PyTorch's gather kernel, which
// launches one block of 32 threads a row, one thread moving the 16-byte
// texel: the block scheduler's rate (about 1.7 G blocks/s) and not memory
// bounds it, and some 25 elementwise launches over int64 and f32 columns
// surround each gather (wrap, floor, remainder, row ids, casts, the mix).
// Here a lane reads its own texels from the image stack or atlas, which
// stays in L1/L2 (the sponzoid's six 256x256 images are 6.3 MB, the city's
// atlases smaller).
//
// tex_sample_kernel<kMode, Texel>, by the function called:
//   kLevel0     sample_texture: the padded (K, TH, TW, 4) f32 level 0, each
//               image in its own (w, h) corner (tex_size[k]).
//   kTrilinear  sample_texture_lod: the (K, TH, 2TW, 4) mip atlas, bf16 or
//               f32 (Texel uint2 or float4), level_size[k, l],
//               level_off[k, l] and n_levels[k]; the lod clamped to
//               [0, n_levels - 1], l0 = floor, l1 = min(l0 + 1, last),
//               level(l0) * (1 - frac) + level(l1) * frac.
//   kAniso      sample_texture_aniso: the footprint of ddx/ddy at level 0,
//               the minor axis' lod (clamped so major/minor <= 4), `taps`
//               trilinear taps at uv + major * s along the major axis,
//               summed from 0 in order and divided by the tap count.
// Texture index -1 is white (1, 1, 1, 1), as the plain path's torch.where.
//
// What bounds it: a level-0 or trilinear lane, bytes: it reads its uv (8 B),
// index (4 B) and lod (4 B) and writes 16 B, its texels from L1/L2, a
// warp's lanes on neighbouring texels. A 4-tap aniso lane reads 28 B and
// writes 16 B but makes 8 bilinear fetches, some 645 FP32 instructions:
// operations. So a lane reads each texel as one float4 or uint2 word and
// holds one tap at a time (28-64 registers, no spills).
//
// Numerics: bit for bit the plain path on this card. The bilinear body is
// texture.cuh's (uncontracted __fmul_rn / __fadd_rn / __fsub_rn in the
// plain path's order); the rest is written the same way. torch.maximum,
// torch.minimum and clamp_min propagate a NaN where fmaxf / fminf drop it,
// so t_max / t_min / t_clamp_min test for it first, as PyTorch's CUDA
// kernels do; sqrtf and division are IEEE (the build has no fast math) and
// log2f is the function PyTorch's CUDA log2 calls. A miss lane's
// non-finite derivatives thus give the same NaN lod and the same texels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "texture.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLevel0 = 0, kTrilinear = 1, kAniso = 2;
constexpr float kMaxAniso = 4.0f;  // ops/texture.py MAX_ANISO

// the image stack or atlas and its tables
struct Tables {
  const void* tex;       // (K, TH, pitch) texels: float4, or uint2 of four bf16
  const int* size;       // level 0: (K, 2) (w, h); mip: (K, L, 2)
  const int* off;        // mip: (K, L) x offsets in the atlas
  const int* n_levels;   // mip: (K,)
  int levels;            // L
  int th, pitch;         // the padded height, the row width in texels
};

// each lane's inputs, contiguous (ops/cuda/texture.py checks)
struct Lanes {
  const void* idx;       // (N,) int32 or int64
  int idx64;
  const float* uv;       // (N, 2)
  const float* lod;      // (N,), trilinear
  const float* ddx;      // (N, 2), aniso
  const float* ddy;
  int taps;              // aniso: 2 or 4
  int n;
  float4* out;           // (N, 4)
};

__device__ __forceinline__ float t_max(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {  // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_clamp_min(float a, float lo) {  // torch.clamp_min
  return a != a ? a : fmaxf(a, lo);
}

// sample_texture_lod at one lane (k >= 0)
template <typename Texel>
__device__ __forceinline__ float4 trilinear(const Tables& t, int k, float u, float v,
                                            float lod) {
  const Texel* tex = static_cast<const Texel*>(t.tex);
  const int64_t row0 = (int64_t)k * t.th;
  const int last = t.n_levels[k] - 1;
  const float lod_c = t_min(t_max(lod, 0.0f), (float)last);
  const int l0 = (int)floorf(lod_c);
  const int l1 = min(l0 + 1, last);
  const float frac = __fsub_rn(lod_c, (float)l0);
  const float keep = __fsub_rn(1.0f, frac);
  const int a = k * t.levels + l0, b = k * t.levels + l1;
  const float4 c0 = vkrt_tex::bilinear(tex, row0, t.pitch, t.size[2 * a], t.size[2 * a + 1],
                                       t.off[a], u, v);
  const float4 c1 = vkrt_tex::bilinear(tex, row0, t.pitch, t.size[2 * b], t.size[2 * b + 1],
                                       t.off[b], u, v);
  return make_float4(__fadd_rn(__fmul_rn(c0.x, keep), __fmul_rn(c1.x, frac)),
                     __fadd_rn(__fmul_rn(c0.y, keep), __fmul_rn(c1.y, frac)),
                     __fadd_rn(__fmul_rn(c0.z, keep), __fmul_rn(c1.z, frac)),
                     __fadd_rn(__fmul_rn(c0.w, keep), __fmul_rn(c1.w, frac)));
}

// sample_texture_aniso at one lane (k >= 0)
template <typename Texel>
__device__ __forceinline__ float4 aniso(const Tables& t, const Lanes& a, int64_t i, int k,
                                        float u, float v) {
  const float dxu = a.ddx[2 * i], dxv = a.ddx[2 * i + 1];
  const float dyu = a.ddy[2 * i], dyv = a.ddy[2 * i + 1];
  // _footprint: level 0's (w, h) times each derivative, then its length
  const int l0 = k * t.levels;
  const float w0 = (float)t.size[2 * l0], h0 = (float)t.size[2 * l0 + 1];
  const float pa = __fmul_rn(dxu, w0), pb = __fmul_rn(dxv, h0);
  const float qa = __fmul_rn(dyu, w0), qb = __fmul_rn(dyv, h0);
  const float px = sqrtf(__fadd_rn(__fmul_rn(pa, pa), __fmul_rn(pb, pb)));
  const float py = sqrtf(__fadd_rn(__fmul_rn(qa, qa), __fmul_rn(qb, qb)));
  // _minor_lod (pmax / 4.0 is pmax * 0.25 in PyTorch's CUDA division by a
  // host scalar; exact either way)
  const float pmax = t_max(px, py), pmin = t_min(px, py);
  const float lod =
      log2f(t_clamp_min(t_max(pmin, __fmul_rn(pmax, 1.0f / kMaxAniso)), (float)1e-9));
  const bool along_x = px >= py;
  const float mu = along_x ? dxu : dyu, mv = along_x ? dxv : dyv;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < a.taps; ++j) {
    // (2j + 1 - taps) / (2 taps): -0.25, 0.25 or -0.375 ... 0.375, exact
    const float s = (float)(2 * j + 1 - a.taps) / (float)(2 * a.taps);
    const float4 c = trilinear<Texel>(t, k, __fadd_rn(u, __fmul_rn(mu, s)),
                                      __fadd_rn(v, __fmul_rn(mv, s)), lod);
    acc = make_float4(__fadd_rn(acc.x, c.x), __fadd_rn(acc.y, c.y), __fadd_rn(acc.z, c.z),
                      __fadd_rn(acc.w, c.w));
  }
  const float n = (float)a.taps;
  return make_float4(__fdiv_rn(acc.x, n), __fdiv_rn(acc.y, n), __fdiv_rn(acc.z, n),
                     __fdiv_rn(acc.w, n));
}

template <int kMode, typename Texel>
__global__ void __launch_bounds__(kThreads) tex_sample_kernel(Tables t, Lanes a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int64_t k = a.idx64 ? static_cast<const int64_t*>(a.idx)[i]
                            : (int64_t) static_cast<const int*>(a.idx)[i];
  if (k < 0) {
    a.out[i] = make_float4(1.f, 1.f, 1.f, 1.f);
    return;
  }
  const float u = a.uv[2 * i], v = a.uv[2 * i + 1];
  float4 c;
  if (kMode == kLevel0) {
    c = vkrt_tex::bilinear(static_cast<const Texel*>(t.tex), k * t.th, t.pitch,
                           t.size[2 * k], t.size[2 * k + 1], 0, u, v);
  } else if (kMode == kTrilinear) {
    c = trilinear<Texel>(t, (int)k, u, v, a.lod[i]);
  } else {
    c = aniso<Texel>(t, a, i, (int)k, u, v);
  }
  a.out[i] = c;
}

template <int kMode, typename Texel>
int launch(const Tables& t, const Lanes& a, void* stream) {
  if (a.n > 0) {
    const int blocks = (a.n + kThreads - 1) / kThreads;
    tex_sample_kernel<kMode, Texel><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(t, a);
  }
  return (int)cudaGetLastError();
}

Lanes lanes(const void* idx, int idx64, const void* uv, int n, void* out) {
  Lanes a = {};
  a.idx = idx;
  a.idx64 = idx64;
  a.uv = (const float*)uv;
  a.n = n;
  a.out = (float4*)out;
  return a;
}

}  // namespace

extern "C" int vkrt_tex_level0(const void* tex, const void* tex_size, int th, int tw,
                               const void* idx, int idx64, const void* uv, int n, void* out,
                               void* stream) {
  const Tables t = {tex, (const int*)tex_size, nullptr, nullptr, 0, th, tw};
  return launch<kLevel0, float4>(t, lanes(idx, idx64, uv, n, out), stream);
}

extern "C" int vkrt_tex_lod(const void* atlas, int bf16, const void* level_size,
                            const void* level_off, const void* n_levels, int levels, int th,
                            int pitch, const void* idx, int idx64, const void* uv,
                            const void* lod, int n, void* out, void* stream) {
  const Tables t = {atlas, (const int*)level_size, (const int*)level_off,
                    (const int*)n_levels, levels, th, pitch};
  Lanes a = lanes(idx, idx64, uv, n, out);
  a.lod = (const float*)lod;
  return bf16 ? launch<kTrilinear, uint2>(t, a, stream) : launch<kTrilinear, float4>(t, a, stream);
}

extern "C" int vkrt_tex_aniso(const void* atlas, int bf16, const void* level_size,
                              const void* level_off, const void* n_levels, int levels, int th,
                              int pitch, const void* idx, int idx64, const void* uv,
                              const void* ddx, const void* ddy, int taps, int n, void* out,
                              void* stream) {
  const Tables t = {atlas, (const int*)level_size, (const int*)level_off,
                    (const int*)n_levels, levels, th, pitch};
  Lanes a = lanes(idx, idx64, uv, n, out);
  a.ddx = (const float*)ddx;
  a.ddy = (const float*)ddy;
  a.taps = taps;
  return bf16 ? launch<kAniso, uint2>(t, a, stream) : launch<kAniso, float4>(t, a, stream);
}
