// The bilinear REPEAT fetch of one lane, shared by the texture kernels
// (texture.cu) and kernel B's albedo fetch (shade.cu), so the two cannot
// drift: ops/texture.py::_bilinear_at_level at one lane.
//
// The uv wraps as uv - floor(uv), texel centres sit at half-integer
// coordinates (GL_LINEAR), the texel indices wrap with a floor modulo
// (torch.remainder: x0 = -1 wraps to w - 1), and the four texels mix in
// the plain path's term order. Every multiply, add and subtract is written
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts none of them into a
// multiply-add: a contracted u*w - 0.5 can move floor() across a texel
// edge. A float-to-int cast is (int), the conversion PyTorch's
// .to(torch.int32) compiles to (round toward zero, NaN to 0).
//
// Texels are read as float4 (an f32 image or atlas) or as one uint2 of
// four bf16 values widened to f32 (a bf16 atlas): the widening is exact,
// as the plain path's .float() after the gather is.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vkrt_tex {

// floor modulo for b > 0 (torch.remainder, jnp.mod): -1 wraps to b - 1
__device__ __forceinline__ int fmod_floor(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

__device__ __forceinline__ float4 load_texel(const float4* __restrict__ t, int64_t i) {
  return t[i];
}

__device__ __forceinline__ float4 load_texel(const uint2* __restrict__ t, int64_t i) {
  const uint2 b = t[i];  // little endian: channel 0 is the low half of b.x
  return make_float4(__uint_as_float(b.x << 16), __uint_as_float(b.x & 0xFFFF0000u),
                     __uint_as_float(b.y << 16), __uint_as_float(b.y & 0xFFFF0000u));
}

// (p00 * (1 - ax)) * (1 - ay) + (p10 * ax) * (1 - ay) + (p01 * (1 - ax)) * ay
// + (p11 * ax) * ay, summed left to right; bx = 1 - ax, by = 1 - ay
__device__ __forceinline__ float mix4(float p00, float p10, float p01, float p11, float ax,
                                      float ay, float bx, float by) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(p00, bx), by),
                                       __fmul_rn(__fmul_rn(p10, ax), by)),
                             __fmul_rn(__fmul_rn(p01, bx), ay)),
                   __fmul_rn(__fmul_rn(p11, ax), ay));
}

// The bilinear REPEAT fetch of (u, v) from a w x h image whose rows start
// at row `row0` of a stack `pitch` texels wide, at x offset `xoff` (0 for
// level 0, the level's offset in a mip atlas).
template <typename Texel>
__device__ __forceinline__ float4 bilinear(const Texel* __restrict__ tex, int64_t row0,
                                           int pitch, int w, int h, int xoff, float u,
                                           float v) {
  const float fx = __fsub_rn(__fmul_rn(__fsub_rn(u, floorf(u)), (float)w), 0.5f);
  const float fy = __fsub_rn(__fmul_rn(__fsub_rn(v, floorf(v)), (float)h), 0.5f);
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float ax = __fsub_rn(fx, x0), ay = __fsub_rn(fy, y0);
  const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
  const int xi = (int)x0, yi = (int)y0;
  const int xa = fmod_floor(xi, w) + xoff, xb = fmod_floor(xi + 1, w) + xoff;
  const int64_t ra = (row0 + fmod_floor(yi, h)) * pitch,
                rb = (row0 + fmod_floor(yi + 1, h)) * pitch;
  const float4 c00 = load_texel(tex, ra + xa), c10 = load_texel(tex, ra + xb),
               c01 = load_texel(tex, rb + xa), c11 = load_texel(tex, rb + xb);
  return make_float4(mix4(c00.x, c10.x, c01.x, c11.x, ax, ay, bx, by),
                     mix4(c00.y, c10.y, c01.y, c11.y, ax, ay, bx, by),
                     mix4(c00.z, c10.z, c01.z, c11.z, ax, ay, bx, by),
                     mix4(c00.w, c10.w, c01.w, c11.w, ax, ay, bx, by));
}

}  // namespace vkrt_tex
