// The temporal denoiser (models/denoiser.py): one temporal pass a frame and
// one launch an a-trous iteration, one thread a pixel, every intermediate in
// registers.
//
// Replaces no Pallas kernel: the JAX package runs the denoiser in XLA
// (vkrt_tpu/models/denoiser.py), which fuses its image-space tensor math.
// Added because the port's plain PyTorch version took 59.7% of the denoised
// orbit frame on this card: each a-trous tap rolls padded copies of the
// image, normals, depth, luminance and variance and runs some 15
// elementwise launches over every pixel, 3 iterations x 25 taps, every
// intermediate a round trip through HBM (~3,050 launches a frame).
//
// temporal_kernel, one launch a frame: the unpack of the packed radiance,
// hit distance and normal (ops/nrd.py), the motion vectors and reproject's 4
// validated bilinear history taps, the clamp of the reprojected radiance to
// the 3x3 box of the current one, the accumulation with alpha = 1 / new_len,
// the moments and the variance with its short-history boost. It writes the
// filter's inputs (rad_acc, variance, the raw hit distance) and the new
// state's moments, length, |view_z| and normal.
//
// atrous_kernel<kVar, kHd>, one launch an iteration: the 3x3 variance
// pre-blur and sig_l, the 25 taps at step = 1 << it (dy outer, dx inner),
// each with its normal, depth, luminance and hit-distance weights, the
// accumulation and the final divides. Iteration it reads the outputs of
// it - 1, so a launch never writes a buffer it reads. kVar / kHd: the
// variance and the hit distance are given (the temporal denoiser), or not
// (denoise_gi, spatial only).
//
// Rows: every field is read through three pointers, `top` (the k rows above
// the body), the body and `bot` (the k rows below), each (rows, W, c)
// contiguous; k = 2 * step for a-trous, 1 for the clamp. The full frame
// passes views of its own last and first k rows (roll's periodic wrap) and
// the clamp its own edge rows; a band of a mesh passes the rows the ring
// brought (models/denoiser.py::_ring_halo). Columns wrap for a-trous and
// clamp to the edge for the box.
//
// What bounds it: an a-trous iteration reads 36 B a pixel (image, normal,
// depth, variance, hit distance) and writes 16 (image, variance); the taps
// come from L1/L2 (rows +-8 of the frame). Each tap is a dot product, a
// pow, two exp, a division and some 30 other FP32 instructions; counting
// each library call as one (an optimistic bound) that is about 981 a pixel
// (chip_smoke.py ATROUS_TAP_OPS), which binds: operations. The temporal pass reads about 88 B a pixel and
// writes 48, and its arithmetic is a few hundred instructions: bytes.
//
// Numerics: the plain path on this card, bit for bit where the operations
// allow. Every product and sum is uncontracted (__fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn), in the plain path's order; powf, expf and sqrt are
// the functions PyTorch's CUDA kernels call (no fast math); torch.minimum /
// maximum / clamp_min / clamp propagate a NaN, so t_min / t_max / t_clamp*
// test for it first, as PyTorch's kernels do. PyTorch on the card divides a
// tensor by a Python scalar as a multiply by the scalar's reciprocal (taken
// in double, rounded to float), so those divisors arrive as reciprocals in
// the tap table; `1.0 / t` is t.reciprocal() * 1.0, an IEEE division. A
// length-3 .sum(dim=-1) is PyTorch's reduction: two threads an output, the
// first summing elements 0 and 2, the second adding element 1 (sum3).
// Python constants are (float) of their double, as PyTorch casts them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlockX = 32, kBlockY = 8;  // atrous: 2D blocks, taps shared in L1
constexpr int kThreads = 256;             // temporal: one row of lanes
constexpr int kTaps = 25;                 // the 5x5 B3-spline taps
constexpr int kCenter = 12;               // tap (0, 0)

// Python floats of models/denoiser.py and ops/nrd.py as PyTorch casts them
constexpr float kEps4 = (float)1e-4;      // sig_l's floor, the hit-distance miss, wsum's
constexpr float kEps8 = (float)1e-8;      // the a-trous weight floor
constexpr float kTiny = (float)1e-20;     // safe_w and the normal's length floor
constexpr float kHdMin = (float)0.05;     // the hit distance's floor
constexpr float kHdScale = 6.0f;          // hd * 6.0 / r

// the tap table (ops/cuda/denoise.py::tap_table), copied from host memory
struct TapTable {
  float kw[kTaps];      // _KERNEL[dy] * _KERNEL[dx]
  float inv_z[kTaps];   // (float)(1 / (SIGMA_Z |sy| + SIGMA_Z |sx| + 1e-3))
  float inv_r[kTaps];   // (float)(1 / (sqrt(dy^2 + dx^2) / 2)), the centre 0
  float sigma_n, sigma_l;
  float inv_9;          // the pre-blur's 1 / 9.0
};
constexpr int kTableFloats = 3 * kTaps + 3;

// a field of c floats a pixel over rows -k .. h + k - 1
struct Field {
  const float* top;   // (k, W, c): rows -k .. -1
  const float* body;  // (h, W, c)
  const float* bot;   // (k, W, c): rows h .. h + k - 1
};

struct AtrousArgs {
  Field img, nrm, z, var;  // var.body null: no variance
  const float* hd;         // (h, W) raw hit distance, or null
  int w, h, step;
  float* out_img;          // (h, W, 3)
  float* out_var;          // (h, W), with var
};

struct TemporalArgs {
  const float* packed;      // (rows, W, 4) YCoCg radiance + hit distance
  const float* packed_top;  // (1, W, 4): row -1 of the clamp's box
  const float* packed_bot;  // (1, W, 4): row `rows`
  const float* norm_rough;  // (rows, W, 4) oct-packed normal + roughness
  const float* view_z;      // (rows, W)
  const float* pos;         // world positions, strided
  int64_t pos_lane, pos_comp;
  const float* vp;          // the history's view_proj (4, 4)
  const float* h_rad;       // the whole frame's history: (W * H, 3)
  const float* h_m1;        // (W * H,) each
  const float* h_m2;
  const float* h_len;
  const float* h_z;
  const float* h_nrm;       // (W * H, 3)
  int w, h, rows;           // h: the frame's height; rows: this band's
  float max_history, depth_reject, normal_reject;
  float* rad_acc;           // (rows * W, 3)
  float* variance;          // (rows * W,) each
  float* hit_dist;
  float* m1;
  float* m2;
  float* len;
  float* abs_z;
  float* normal;            // (rows * W, 3)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float t_max(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {  // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_clamp_min(float a, float lo) {  // clamp_min(t, scalar)
  return a != a ? a : fmaxf(a, lo);
}
__device__ __forceinline__ float t_clamp_max(float a, float hi) {  // clamp_max(t, scalar)
  return a != a ? a : fminf(a, hi);
}
__device__ __forceinline__ float t_clamp(float a, float lo, float hi) {  // clamp(t, s, s)
  return a != a ? a : fminf(fmaxf(a, lo), hi);
}
// torch.clamp(t, lo_tensor, hi_tensor): a NaN value, then a NaN bound, wins
__device__ __forceinline__ float t_clamp_t(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// a length-3 .sum(dim=-1) as PyTorch's CUDA reduction adds it
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, c), b);
}

__device__ __forceinline__ float luma(float r, float g, float b) {  // _luminance
  return add(add(mul(r, 0.25f), mul(g, 0.5f)), mul(b, 0.25f));
}

__device__ __forceinline__ int wrap(int x, int w) {
  const int r = x % w;
  return r < 0 ? r + w : r;
}

// row y (-k <= y < h + k) of a field of `wc` floats a row
__device__ __forceinline__ const float* row_of(const Field& f, int y, int h, int k,
                                               int64_t wc) {
  if (y < 0) return f.top + (int64_t)(y + k) * wc;
  if (y >= h) return f.bot + (int64_t)(y - h) * wc;
  return f.body + (int64_t)y * wc;
}

template <bool kVar, bool kHd>
__global__ void __launch_bounds__(kBlockX * kBlockY) atrous_kernel(AtrousArgs a, TapTable t) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const int k = 2 * a.step;
  const int64_t w1 = a.w, w3 = 3 * (int64_t)a.w;
  const int64_t i = (int64_t)y * a.w + x;
  const float* ic = a.img.body + 3 * i;
  const float* nc = a.nrm.body + 3 * i;
  const float n0 = nc[0], n1 = nc[1], n2 = nc[2];
  const float zc = a.z.body[i];
  const float lum = luma(ic[0], ic[1], ic[2]);

  float sig_l = 0.0f;
  if (kVar) {  // 3x3 pre-blur of the variance (clamped at 0, as on input)
    float vb = 0.0f;
    for (int dy = -1; dy <= 1; ++dy) {
      const float* row = row_of(a.var, y + dy, a.h, k, w1);
      for (int dx = -1; dx <= 1; ++dx) vb = add(vb, t_clamp_min(row[wrap(x + dx, a.w)], 0.0f));
    }
    sig_l = add(mul(__fsqrt_rn(mul(vb, t.inv_9)), t.sigma_l), kEps4);
  }
  float hd = 0.0f;
  if (kHd) {  // 0 = no GI data (miss): nothing to preserve, full blur
    const float v = a.hd[i];
    hd = v <= kEps4 ? 1.0f : t_clamp(v, kHdMin, 1.0f);
  }

  int cols[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) cols[j] = wrap(x + (j - 2) * a.step, a.w);
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wsum = 0.0f, vacc = 0.0f;
  for (int dy = -2; dy <= 2; ++dy) {
    const int yq = y + dy * a.step;
    const float* ir = row_of(a.img, yq, a.h, k, w3);
    const float* nr = row_of(a.nrm, yq, a.h, k, w3);
    const float* zr = row_of(a.z, yq, a.h, k, w1);
    const float* vr = kVar ? row_of(a.var, yq, a.h, k, w1) : nullptr;
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      const int tap = (dy + 2) * 5 + dx + 2;
      const int xq = cols[dx + 2];
      const float q0 = ir[3 * xq], q1 = ir[3 * xq + 1], q2 = ir[3 * xq + 2];
      const float dot = sum3(mul(n0, nr[3 * xq]), mul(n1, nr[3 * xq + 1]),
                             mul(n2, nr[3 * xq + 2]));
      const float w_n = powf(t_clamp_min(dot, 0.0f), t.sigma_n);
      const float w_z = expf(mul(-fabsf(sub(zc, zr[xq])), t.inv_z[tap]));
      float wgt = mul(mul(w_n, t.kw[tap]), w_z);
      if (kVar) wgt = mul(wgt, expf(dvd(-fabsf(sub(lum, luma(q0, q1, q2))), sig_l)));
      if (kHd && tap != kCenter)  // short hit distances shrink the blur radius
        wgt = mul(wgt, add(mul(t_clamp_max(mul(mul(hd, kHdScale), t.inv_r[tap]), 1.0f), 0.5f),
                           0.5f));
      acc0 = add(acc0, mul(q0, wgt));
      acc1 = add(acc1, mul(q1, wgt));
      acc2 = add(acc2, mul(q2, wgt));
      wsum = add(wsum, wgt);
      if (kVar) vacc = add(vacc, mul(mul(t_clamp_min(vr[xq], 0.0f), wgt), wgt));
    }
  }
  const float den = t_clamp_min(wsum, kEps8);
  float* out = a.out_img + 3 * i;
  out[0] = dvd(acc0, den);
  out[1] = dvd(acc1, den);
  out[2] = dvd(acc2, den);
  if (kVar) a.out_var[i] = dvd(vacc, t_clamp_min(mul(wsum, wsum), kEps8));
}

// ycocg_to_linear of one packed pixel
__device__ __forceinline__ void unpack_radiance(const float* p, float* c) {
  const float y = p[0], co = p[1], cg = p[2];
  const float t = sub(y, cg);
  c[0] = t_clamp_min(add(t, co), 0.0f);
  c[1] = t_clamp_min(add(y, cg), 0.0f);
  c[2] = t_clamp_min(sub(t, co), 0.0f);
}

// unpack_normal_and_roughness' normal: the octahedral decode, normalised
__device__ __forceinline__ void decode_normal(const float* p, float* n) {
  const float e0 = sub(mul(p[0], 2.0f), 1.0f), e1 = sub(mul(p[1], 2.0f), 1.0f);
  const float z = sub(sub(1.0f, fabsf(e0)), fabsf(e1));
  const float t = t_clamp(-z, 0.0f, 1.0f);
  const float x = sub(e0, mul(t, e0 >= 0.0f ? 1.0f : -1.0f));
  const float y = sub(e1, mul(t, e1 >= 0.0f ? 1.0f : -1.0f));
  const float len = t_clamp_min(
      __fsqrt_rn(t_clamp_min(add(add(mul(x, x), mul(y, y)), mul(z, z)), 0.0f)), kTiny);
  n[0] = dvd(x, len);
  n[1] = dvd(y, len);
  n[2] = dvd(z, len);
}

// row j of [p, 1] @ m.T, in the dot product's order
__device__ __forceinline__ float project(const float* m, int j, float x, float y, float z) {
  return add(add(add(mul(x, m[4 * j]), mul(y, m[4 * j + 1])), mul(z, m[4 * j + 2])),
             m[4 * j + 3]);
}

__global__ void __launch_bounds__(kThreads) temporal_kernel(TemporalArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)a.rows * a.w) return;
  const int y = (int)(i / a.w), x = (int)(i % a.w);
  float cur[3], nrm[3];
  unpack_radiance(a.packed + 4 * i, cur);
  const float hit = a.packed[4 * i + 3];
  decode_normal(a.norm_rough + 4 * i, nrm);

  // motion_vectors: the previous frame's pixel of this world point
  const float* p = a.pos + i * a.pos_lane;
  const float px = p[0], py = p[a.pos_comp], pz = p[2 * a.pos_comp];
  const float cx = project(a.vp, 0, px, py, pz), cy = project(a.vp, 1, px, py, pz);
  const float w = project(a.vp, 3, px, py, pz);
  const float safe_w = fabsf(w) < kTiny ? kTiny : w;
  const float sx = sub(mul(add(mul(dvd(cx, safe_w), 0.5f), 0.5f), (float)a.w), 0.5f);
  const float sy = sub(mul(add(mul(dvd(cy, safe_w), 0.5f), 0.5f), (float)a.h), 0.5f);
  const bool in_prev = w > 0.0f && sx >= -0.5f && sx <= (float)((double)a.w - 0.5) &&
                       sy >= -0.5f && sy <= (float)((double)a.h - 0.5);

  // reproject: 4 bilinear taps, each validated by depth and normal
  const float fx0 = floorf(sx), fy0 = floorf(sy);
  const float fx = sub(sx, fx0), fy = sub(sy, fy0);
  const int x0 = min(max((int)fx0, 0), a.w - 1), y0 = min(max((int)fy0, 0), a.h - 1);
  const int x1 = min(x0 + 1, a.w - 1), y1 = min(y0 + 1, a.h - 1);
  const float w_abs = fabsf(w);
  const float z_lim = mul(t_clamp_min(w_abs, 1.0f), a.depth_reject);
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
  const int64_t idx[4] = {(int64_t)y0 * a.w + x0, (int64_t)y0 * a.w + x1,
                          (int64_t)y1 * a.w + x0, (int64_t)y1 * a.w + x1};
  const float wt[4] = {mul(gx, gy), mul(fx, gy), mul(gx, fy), mul(fx, fy)};
  float ar0 = 0.0f, ar1 = 0.0f, ar2 = 0.0f, am1 = 0.0f, am2 = 0.0f, al = 0.0f, ws = 0.0f;
#pragma unroll
  for (int tp = 0; tp < 4; ++tp) {
    const int64_t j = idx[tp];
    const float hl = a.h_len[j];
    const float* pn = a.h_nrm + 3 * j;
    const bool ok = in_prev && hl > 0.0f && fabsf(sub(a.h_z[j], w_abs)) <= z_lim &&
                    sum3(mul(pn[0], nrm[0]), mul(pn[1], nrm[1]), mul(pn[2], nrm[2])) >=
                        a.normal_reject;
    const float wv = ok ? wt[tp] : 0.0f;
    ar0 = add(ar0, mul(a.h_rad[3 * j], wv));
    ar1 = add(ar1, mul(a.h_rad[3 * j + 1], wv));
    ar2 = add(ar2, mul(a.h_rad[3 * j + 2], wv));
    am1 = add(am1, mul(a.h_m1[j], wv));
    am2 = add(am2, mul(a.h_m2[j], wv));
    al = add(al, mul(hl, wv));
    ws = add(ws, wv);
  }
  const bool valid = ws > kEps4;
  const float inv = dvd(1.0f, t_clamp_min(ws, kEps4));
  float hr[3] = {valid ? mul(ar0, inv) : 0.0f, valid ? mul(ar1, inv) : 0.0f,
                 valid ? mul(ar2, inv) : 0.0f};
  const float hm1 = valid ? mul(am1, inv) : 0.0f;
  const float hm2 = valid ? mul(am2, inv) : 0.0f;
  const float hlen = valid ? mul(al, inv) : 0.0f;

  // _neighborhood_clamp: the 3x3 box of the current radiance, columns
  // clamped to the edge, rows -1 and `rows` from the halo rows
  float lo[3] = {cur[0], cur[1], cur[2]}, hi[3] = {cur[0], cur[1], cur[2]};
  for (int dy = -1; dy <= 1; ++dy) {
    const int yq = y + dy;
    const float* row = yq < 0 ? a.packed_top
                       : yq >= a.rows ? a.packed_bot
                                      : a.packed + (int64_t)yq * a.w * 4;
    for (int dx = -1; dx <= 1; ++dx) {
      float q[3];
      unpack_radiance(row + 4 * min(max(x + dx, 0), a.w - 1), q);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = t_min(lo[c], q[c]);
        hi[c] = t_max(hi[c], q[c]);
      }
    }
  }

  // the accumulation and the moments
  const float new_len = t_clamp_max(add(hlen, 1.0f), a.max_history);
  const float alpha = dvd(1.0f, new_len);
  const float keep = sub(1.0f, alpha);
  float* out = a.rad_acc + 3 * i;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = add(mul(t_clamp_t(hr[c], lo[c], hi[c]), keep), mul(cur[c], alpha));
  const float lum = luma(cur[0], cur[1], cur[2]);
  const float m1 = add(mul(hm1, keep), mul(lum, alpha));
  const float m2 = add(mul(hm2, keep), mul(mul(lum, lum), alpha));
  // short history: inflate the variance so the spatial filter works harder
  const float var = add(t_clamp_min(sub(m2, mul(m1, m1)), 0.0f),
                        new_len < 4.0f ? mul(alpha, 0.5f) : 0.0f);
  a.variance[i] = var;
  a.hit_dist[i] = hit;
  a.m1[i] = m1;
  a.m2[i] = m2;
  a.len[i] = new_len;
  a.abs_z[i] = fabsf(a.view_z[i]);
  float* n = a.normal + 3 * i;
  n[0] = nrm[0];
  n[1] = nrm[1];
  n[2] = nrm[2];
}

template <bool kVar, bool kHd>
void launch_atrous(const AtrousArgs& a, const TapTable& t, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((a.w + kBlockX - 1) / kBlockX, (a.h + kBlockY - 1) / kBlockY);
  atrous_kernel<kVar, kHd><<<grid, block, 0, stream>>>(a, t);
}

}  // namespace

// One a-trous iteration at `step` over a (height, width) frame or band. The
// fields' top / bottom pointers hold 2 * step rows each; var and hd null
// leave the variance and the hit distance out. `taps` is host memory: the
// tap table of ops/cuda/denoise.py::tap_table (78 floats).
extern "C" int vkrt_denoise_atrous(const void* img, const void* img_top, const void* img_bot,
                                   const void* nrm, const void* nrm_top, const void* nrm_bot,
                                   const void* z, const void* z_top, const void* z_bot,
                                   const void* var, const void* var_top, const void* var_bot,
                                   const void* hd, const void* taps, int width, int height,
                                   int step, void* out_img, void* out_var, void* stream) {
  static_assert(sizeof(TapTable) == kTableFloats * sizeof(float), "tap table layout");
  if (width > 0 && height > 0) {
    AtrousArgs a;
    a.img = {(const float*)img_top, (const float*)img, (const float*)img_bot};
    a.nrm = {(const float*)nrm_top, (const float*)nrm, (const float*)nrm_bot};
    a.z = {(const float*)z_top, (const float*)z, (const float*)z_bot};
    a.var = {(const float*)var_top, (const float*)var, (const float*)var_bot};
    a.hd = (const float*)hd;
    a.w = width;
    a.h = height;
    a.step = step;
    a.out_img = (float*)out_img;
    a.out_var = (float*)out_var;
    TapTable t;
    memcpy(&t, taps, sizeof(t));
    cudaStream_t s = (cudaStream_t)stream;
    if (var && hd) launch_atrous<true, true>(a, t, s);
    else if (var) launch_atrous<true, false>(a, t, s);
    else if (hd) launch_atrous<false, true>(a, t, s);
    else launch_atrous<false, false>(a, t, s);
  }
  return (int)cudaGetLastError();
}

// The temporal pass over `rows` rows (the frame, or a band) of a frame of
// width x height, reprojecting against the whole frame's history.
extern "C" int vkrt_denoise_temporal(
    const void* packed, const void* packed_top, const void* packed_bot,
    const void* norm_rough, const void* view_z, const void* pos, int64_t pos_lane,
    int64_t pos_comp, const void* view_proj, const void* hist_rad, const void* hist_m1,
    const void* hist_m2, const void* hist_len, const void* prev_view_z,
    const void* prev_normal, int width, int height, int rows, float max_history,
    float depth_reject, float normal_reject, void* rad_acc, void* variance, void* hit_dist,
    void* m1, void* m2, void* len, void* abs_z, void* normal, void* stream) {
  const int64_t n = (int64_t)rows * width;
  if (n > 0) {
    TemporalArgs a = {(const float*)packed, (const float*)packed_top,
                      (const float*)packed_bot, (const float*)norm_rough,
                      (const float*)view_z, (const float*)pos, pos_lane, pos_comp,
                      (const float*)view_proj, (const float*)hist_rad,
                      (const float*)hist_m1, (const float*)hist_m2, (const float*)hist_len,
                      (const float*)prev_view_z, (const float*)prev_normal, width, height,
                      rows, max_history, depth_reject, normal_reject, (float*)rad_acc,
                      (float*)variance, (float*)hit_dist, (float*)m1, (float*)m2,
                      (float*)len, (float*)abs_z, (float*)normal};
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    temporal_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
