// Kernel B: one bounce of hit shading, BSDF sampling and deferred NEE.
//
// Replaces vkrt_tpu/ops/pallas/shade.py::_shade_kernel (launched by
// shade_call, driven by bounce_chain_packed). The TPU kernel works on
// (8, 128) packed tiles, reads attributes interpolated inside the trace
// kernel, and selects materials and lights with one-hot loops capped at 32
// and 8 rows, because Mosaic has no per-lane gathers. Here one thread
// shades one lane over structure-of-arrays columns ((C, N) rows, so a warp
// reads 128 contiguous bytes per column), gathers the winner's corner
// attributes by triangle id, and looks the material and light up by
// index, with no caps.
//
// What bounds it on this card: memory traffic. Per lane it reads 14 carry
// + 1 seed + 7 ray + 4 hit (+1 shadow verdict) words and writes 14 + 1 +
// 7 + 7 words, about 220 bytes, plus gathers into small tables that stay
// in L1/L2 (the albedo instantiation: 24 B of corner uv and four 16-byte
// texels more a hit lane); the ~300 FP32 operations and 4 sin/cos per lane
// are well under the FP32 rate at that byte count. The design keeps every access
// coalesced, computes both lobes branch-free (as the TPU kernel does) so a
// warp never diverges on the lobe pick, and keeps the LCG in uint32.
//
// Numerics follow the TPU kernel's operation order: the LCG is
// 1664525*s + 1013904223 mod 2^32 with u = (s & 0xFFFFFF) * 2^-24, the
// draw order and the separate diffuse/specular streams are kept, and every
// pl.reciprocal(x) of the TPU kernel is 1.0f / x here (IEEE, no fast math).
//
// Two instantiations. shade_kernel<false> shades untextured scenes.
// shade_kernel<true> is the TPU kernel's albedo mode for scenes whose only
// texture is baseColor (shade.py:191, 200-205, 302-307): there the albedo
// block was fetched outside the kernel (xla_albedo_block), because Mosaic
// has no per-lane gathers; here a hit lane fetches it itself: the delta-form
// uv of the winner's corners, the material's baseColor texture, four float4
// texel reads of level 0 with REPEAT wrap and GL_LINEAR weights, multiplied
// into the base colour before the BSDF. Miss lanes fetch nothing, texture
// index -1 is white. The uv is computed with __fmul_rn / __fadd_rn in
// ops/texture.py's order, so no multiply-add is contracted; the wrap, the
// four reads and the mix are texture.cuh's, which the texture kernels
// (texture.cu) share.

#include <cuda_runtime.h>
#include <stdint.h>

#include "texture.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCorrBlock = 1024;  // lanes per corr-table row (pool order)
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kTwoPi = 6.28318530717958647692f;

// carry rows; see vkrt_tpu_torch/ops/cuda/shade.py
constexpr int C_CW = 0, C_HV = 3, C_ACTIVE = 6, C_SPEC = 7, C_LDIST = 8,
              C_HD = 9, C_PEND = 10, C_PSH = 13, CARRY_COLS = 14;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize3(V3 a) {
  const float inv =
      1.0f / fmaxf(sqrtf(fmaxf(a.x * a.x + a.y * a.y + a.z * a.z, 0.f)), 1e-20f);
  return {a.x * inv, a.y * inv, a.z * inv};
}
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}
__device__ __forceinline__ float k_direct(float r) {
  return (r + 1.0f) * (r + 1.0f) * 0.125f;
}
__device__ __forceinline__ float g_schlick(float nv, float k) {
  return nv / (nv * (1.0f - k) + k);
}
__device__ __forceinline__ float g_smith(float nl, float nv, float k) {
  return g_schlick(nv, k) * g_schlick(nl, k);
}
__device__ __forceinline__ float rnd(uint32_t& s) {
  s = 1664525u * s + 1013904223u;
  return (float)(s & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

struct Params {
  int n, d, first, resolve_hd, hitdist_accumulate, n_lights;
  float hitdist_weight, t_min, t_max, clear_r, clear_g, clear_b, clamp_lo,
      clamp_hi;
};

// The tables of the albedo fetch (read by shade_kernel<true> only).
struct Albedo {
  const float* corner_uv;   // (T, 3, 2)
  const int* mat_base_tex;  // (M,), -1 = none
  const float4* tex;        // (K, TH, TW) texels, level 0, f32 RGBA
  const int* tex_size;      // (K, 2) each image's own (w, h)
  int th, tw;               // the padded image size
};

// ops/texture.py::sample_texture at one lane, rgb only (-1: white)
__device__ __forceinline__ V3 fetch_albedo(const Albedo& a, int mat, float u,
                                           float v, const float* cu) {
  const int k = a.mat_base_tex[mat];
  if (k < 0) return {1.f, 1.f, 1.f};
  // uv = a0 + u*(a1-a0) + v*(a2-a0), uncontracted
  const float uu = __fadd_rn(__fadd_rn(cu[0], __fmul_rn(u, __fsub_rn(cu[2], cu[0]))),
                             __fmul_rn(v, __fsub_rn(cu[4], cu[0])));
  const float vv = __fadd_rn(__fadd_rn(cu[1], __fmul_rn(u, __fsub_rn(cu[3], cu[1]))),
                             __fmul_rn(v, __fsub_rn(cu[5], cu[1])));
  const float4 c = vkrt_tex::bilinear(a.tex, (int64_t)k * a.th, a.tw, a.tex_size[2 * k],
                                      a.tex_size[2 * k + 1], 0, uu, vv);
  return {c.x, c.y, c.z};
}

template <bool kAlbedo>
__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ carry, const int* __restrict__ seed_in,
             const float* __restrict__ rays, const float* __restrict__ hit_t,
             const int* __restrict__ hit_tri, const float* __restrict__ hit_u,
             const float* __restrict__ hit_v, const int* __restrict__ sh_tri,
             const float* __restrict__ corner_normal,
             const float* __restrict__ corner_tangent,
             const int* __restrict__ tri_mat, const float* __restrict__ mat_tab,
             const float* __restrict__ light_tab,
             const float* __restrict__ corr_tab, Albedo alb, Params p,
             float* __restrict__ carry_out, int* __restrict__ seed_out,
             float* __restrict__ next_rays, float* __restrict__ shadow_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int64_t N = p.n;
  auto col = [&](const float* base, int c) { return base[c * N + i]; };

  // --- unpack carry ---------------------------------------------------------
  const uint32_t seed0 = (uint32_t)seed_in[i];
  float cwr = col(carry, C_CW), cwg = col(carry, C_CW + 1), cwb = col(carry, C_CW + 2);
  float hvr = col(carry, C_HV), hvg = col(carry, C_HV + 1), hvb = col(carry, C_HV + 2);
  const bool active = col(carry, C_ACTIVE) > 0.f;
  const bool is_spec = col(carry, C_SPEC) > 0.f;
  const float light_dist = col(carry, C_LDIST);
  float hd = col(carry, C_HD);
  const float pr = col(carry, C_PEND), pg = col(carry, C_PEND + 1),
              pb = col(carry, C_PEND + 2);
  const bool pend_sh = col(carry, C_PSH) > 0.f;

  // --- resolve the PREVIOUS bounce's pending NEE (deferred shadow) ----------
  if (!p.first) {
    const bool blocked = sh_tri[i] >= 0 && pend_sh;
    if (!blocked) {
      hvr = hvr + pr;
      hvg = hvg + pg;
      hvb = hvb + pb;
    }
    if (p.resolve_hd) {  // prev bounce was depth 1 (rgen:103-114)
      float hd_new = blocked ? 0.5f * light_dist : light_dist;
      hd_new = hd_new * p.hitdist_weight;
      if (pend_sh) hd = p.hitdist_accumulate ? hd + hd_new : hd_new;
    }
  }

  // --- this bounce's ray + hit ----------------------------------------------
  const V3 dir = {col(rays, 3), col(rays, 4), col(rays, 5)};
  const int tri = hit_tri[i];
  const bool is_hit = tri >= 0;
  const bool miss = (!is_hit && active) || !active;
  const float t_hit = hit_t[i];
  // o + t*d uncontracted, as the plain version rounds it: a hit on a plane
  // through the origin from a far camera (the city's ground, y = 0, from
  // 300 away) cancels there, and a fused multiply-add moves the result by
  // ulps of the camera height
  const V3 pos = {__fadd_rn(col(rays, 0), __fmul_rn(t_hit, dir.x)),
                  __fadd_rn(col(rays, 1), __fmul_rn(t_hit, dir.y)),
                  __fadd_rn(col(rays, 2), __fmul_rn(t_hit, dir.z))};

  // --- the winner's corner attributes (zero on miss lanes) ------------------
  V3 nrm = {0.f, 0.f, 0.f}, tan = {0.f, 0.f, 0.f};
  V3 albedo = {1.f, 1.f, 1.f};
  float tw = 0.f;
  int mat = 0;
  if (is_hit) {
    const float u = hit_u[i], v = hit_v[i];
    const float* cn = corner_normal + 9 * (int64_t)tri;
    const float* ct = corner_tangent + 12 * (int64_t)tri;
    nrm.x = cn[0] + u * (cn[3] - cn[0]) + v * (cn[6] - cn[0]);
    nrm.y = cn[1] + u * (cn[4] - cn[1]) + v * (cn[7] - cn[1]);
    nrm.z = cn[2] + u * (cn[5] - cn[2]) + v * (cn[8] - cn[2]);
    tan.x = ct[0] + u * (ct[4] - ct[0]) + v * (ct[8] - ct[0]);
    tan.y = ct[1] + u * (ct[5] - ct[1]) + v * (ct[9] - ct[1]);
    tan.z = ct[2] + u * (ct[6] - ct[2]) + v * (ct[10] - ct[2]);
    tw = ct[3];
    mat = tri_mat[tri];
    if (kAlbedo) albedo = fetch_albedo(alb, mat, u, v, alb.corner_uv + 6 * (int64_t)tri);
  }

  // --- surface frame ----------------------------------------------------------
  const V3 n = normalize3(nrm);
  V3 t = normalize3(tan);
  const float tn = dot3(t, n);
  t = normalize3({t.x - tn * n.x, t.y - tn * n.y, t.z - tn * n.z});
  V3 b = cross3(n, t);
  b = {tw * b.x, tw * b.y, tw * b.z};

  // --- material by index -------------------------------------------------------
  const float* mt = mat_tab + 8 * (int64_t)mat;
  float baser = mt[0], baseg = mt[1], baseb = mt[2];
  const float metal = mt[3], rough = mt[4], emr = mt[5], emg = mt[6], emb = mt[7];
  if (kAlbedo) {  // base_color = base_factor * fetch(base_tex)
    baser = baser * albedo.x;
    baseg = baseg * albedo.y;
    baseb = baseb * albedo.z;
  }

  // --- sample_bsdf -----------------------------------------------------------
  const V3 vv = normalize3({-dir.x, -dir.y, -dir.z});
  const bool gate = p.d == 0 || is_spec;
  const float e_r = gate ? emr : 0.f, e_g = gate ? emg : 0.f, e_b = gate ? emb : 0.f;
  const float ratio = 0.5f * (1.0f - metal);
  const float rough_c = fminf(fmaxf(rough, 0.01f), 0.99f);
  const float metal_c = fminf(fmaxf(metal, 0.01f), 0.99f);

  const float* cu = corr_tab ? corr_tab + 8 * (int64_t)(i / kCorrBlock) : nullptr;
  uint32_t seed = seed0;
  float r1 = rnd(seed);
  if (cu) r1 = cu[0];
  const bool is_diffuse = r1 < ratio;

  // ---- diffuse branch (light pick + NEE + cosine hemisphere) ----
  uint32_t seed_d = seed;
  float r_light = rnd(seed_d);
  if (cu) r_light = cu[1];
  int lidx = (int)(r_light * (float)p.n_lights);
  lidx = min(max(lidx, 0), p.n_lights - 1);
  const float* lt = light_tab + 8 * (int64_t)lidx;
  const float lpx = lt[0], lpy = lt[1], lpz = lt[2], lcr = lt[3], lcg = lt[4],
              lcb = lt[5], lint = lt[6], ltype = lt[7];

  const V3 ld = {lpx - pos.x, lpy - pos.y, lpz - pos.z};
  const float ldist = sqrtf(fmaxf(dot3(ld, ld), 0.f));
  const float linv = 1.0f / fmaxf(ldist, 1e-20f);
  const V3 l = {ld.x * linv, ld.y * linv, ld.z * linv};

  const V3 h = normalize3({l.x + vv.x, l.y + vv.y, l.z + vv.z});
  const float li_scale = lint * (1.0f / fmaxf(ldist * ldist, 1e-20f));
  const float lir = lcr * li_scale, lig = lcg * li_scale, lib = lcb * li_scale;
  const float cos_nee = fmaxf(dot3(l, n), 0.f);

  const float f0r = baser * metal + 0.04f * (1.0f - metal);
  const float f0g = baseg * metal + 0.04f * (1.0f - metal);
  const float f0b = baseb * metal + 0.04f * (1.0f - metal);
  const float hv_abs = fabsf(dot3(h, vv));
  const float fres = pow5(fmaxf(1.0f - hv_abs, 0.f));
  const float fr = f0r + (1.0f - f0r) * fres;
  const float fg = f0g + (1.0f - f0g) * fres;
  const float fb = f0b + (1.0f - f0b) * fres;
  const float alpha_raw = rough * rough;
  const float a2 = alpha_raw * alpha_raw;
  const float nh = dot3(n, h);
  const float dterm = nh * nh * (a2 - 1.0f) + 1.0f;
  float ndf = a2 * kInvPi * (1.0f / (dterm * dterm + 1e-4f));
  if (nh <= 0.f) ndf = 0.f;
  const float k_raw = k_direct(rough);
  const float nv_abs = fabsf(dot3(n, vv));
  const float nl_abs = fabsf(dot3(n, l));
  const float g = g_smith(nl_abs, nv_abs, k_raw);
  const float down = 4.0f * nv_abs * nl_abs + 1e-4f;
  const float spec_s = ndf * g * (1.0f / down);
  const float kdr = (1.0f - fr) * (1.0f - metal);
  const float kdg = (1.0f - fg) * (1.0f - metal);
  const float kdb = (1.0f - fb) * (1.0f - metal);
  float brdfr = kdr * baser * kInvPi + spec_s * fr;
  float brdfg = kdg * baseg * kInvPi + spec_s * fg;
  float brdfb = kdb * baseb * kInvPi + spec_s * fb;
  if (!(ltype == 0.f && cos_nee > 0.f)) brdfr = brdfg = brdfb = 0.f;
  const bool pos_gate = dot3(l, n) > 0.f;
  const float nl_f = (float)p.n_lights;
  const float neer = pos_gate ? nl_f * brdfr * lir * cos_nee : 0.f;
  const float neeg = pos_gate ? nl_f * brdfg * lig * cos_nee : 0.f;
  const float neeb = pos_gate ? nl_f * brdfb * lib * cos_nee : 0.f;

  // cosine hemisphere bounce (random.glsl:35-45) in the (T,B,N) frame
  float hr1 = rnd(seed_d);
  float hr2 = rnd(seed_d);
  if (cu) {
    hr1 = cu[2];
    hr2 = cu[3];
  }
  const float sq = sqrtf(hr1);
  const float phi = kTwoPi * hr2;
  const float cxl = cosf(phi) * sq;
  const float cyl = sinf(phi) * sq;
  const float czl = sqrtf(fmaxf(1.0f - hr1, 0.f));
  const V3 dd = normalize3({cxl * t.x + cyl * b.x + czl * n.x,
                            cxl * t.y + cyl * b.y + czl * n.y,
                            cxl * t.z + cyl * b.z + czl * n.z});
  const float dn = dot3(dd, n);
  const float pdf_d = ratio * dn * kInvPi;
  const float wscale = dn * (1.0f / fmaxf(pdf_d, 1e-12f));
  const float wdr = (1.0f - metal_c) * baser * kInvPi * wscale;
  const float wdg = (1.0f - metal_c) * baseg * kInvPi * wscale;
  const float wdb = (1.0f - metal_c) * baseb * kInvPi * wscale;

  // ---- specular branch: GGX importance sample (random.glsl:56-70) ----
  const float alpha_c = rough_c * rough_c;
  const float a2c = alpha_c * alpha_c;
  uint32_t seed_s = seed;
  float g1 = rnd(seed_s);
  float g2 = rnd(seed_s);
  if (cu) {
    g1 = cu[4];
    g2 = cu[5];
  }
  const float cos_t = sqrtf(fmaxf((1.0f - g2) / ((a2c - 1.0f) * g2 + 1.0f), 0.f));
  const float sin_t = fminf(fmaxf(sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.f)), 0.f), 1.0f);
  const float gphi = g1 * kTwoPi;
  const float hlx = sin_t * cosf(gphi);
  const float hly = sin_t * sinf(gphi);
  const V3 sh = normalize3({hlx * t.x + hly * b.x + cos_t * n.x,
                            hlx * t.y + hly * b.y + cos_t * n.y,
                            hlx * t.z + hly * b.z + cos_t * n.z});
  const float hv_dot = dot3(vv, sh);
  const V3 ds = normalize3({-vv.x + 2.0f * hv_dot * sh.x,
                            -vv.y + 2.0f * hv_dot * sh.y,
                            -vv.z + 2.0f * hv_dot * sh.z});
  const float f0cr = 0.04f * (1.0f - metal_c) + baser * metal_c;
  const float f0cg = 0.04f * (1.0f - metal_c) + baseg * metal_c;
  const float f0cb = 0.04f * (1.0f - metal_c) + baseb * metal_c;
  const float k_c = k_direct(rough_c);
  const float nh_s = dot3(n, sh);
  const float lh_s = dot3(ds, sh);
  const float pdf_s = (1.0f - ratio) * nh_s * (1.0f / (4.0f * lh_s + 1e-4f));
  const float nl_s = fabsf(dot3(n, ds));
  const float g_s = g_smith(nl_s, nv_abs, k_c);
  const float hv_s = fabsf(dot3(sh, vv));
  const float fres_s = pow5(fmaxf(1.0f - hv_s, 0.f));
  const float fsr = f0cr + (1.0f - f0cr) * fres_s;
  const float fsg = f0cg + (1.0f - f0cg) * fres_s;
  const float fsb = f0cb + (1.0f - f0cb) * fres_s;
  const float down_s = 4.0f * nv_abs * nl_s + 1e-4f;
  const float cos_s = dot3(ds, n);
  const float sscale = g_s * (1.0f / (down_s * pdf_s)) * cos_s;
  const float wsr = fsr * sscale, wsg = fsg * sscale, wsb = fsb * sscale;

  // ---- lobe select (per-branch RNG streams) ----
  const V3 nd = is_diffuse ? dd : ds;
  float bwr = is_diffuse ? wdr : wsr;
  float bwg = is_diffuse ? wdg : wsg;
  float bwb = is_diffuse ? wdb : wsb;
  const float epr = e_r + (is_diffuse ? neer : 0.f);
  const float epg = e_g + (is_diffuse ? neeg : 0.f);
  const float epb = e_b + (is_diffuse ? neeb : 0.f);
  const uint32_t bs_seed = is_diffuse ? seed_d : seed_s;

  // --- rmiss + bounce-carry update --------------------------------------------
  float mvr = 0.01f, mvg = 0.01f, mvb = 0.01f;
  if (p.d == 0) {  // clearColor*0.8 on primary (rmiss:15)
    mvr = p.clear_r * 0.8f;
    mvg = p.clear_g * 0.8f;
    mvb = p.clear_b * 0.8f;
  }
  const float hv_this_r = miss ? mvr : epr;
  const float hv_this_g = miss ? mvg : epg;
  const float hv_this_b = miss ? mvb : epb;
  const bool spec_this = miss ? is_spec : !is_diffuse;
  const float ldist_this = miss ? light_dist : ldist;
  const bool do_shadow = active && !miss && !spec_this;
  const bool active_next = active && !miss;

  // pending NEE contribution for THIS bounce (firefly clamp, rgen:101)
  const float np_r = active ? fminf(hv_this_r * cwr, 10.0f) : 0.f;
  const float np_g = active ? fminf(hv_this_g * cwg, 10.0f) : 0.f;
  const float np_b = active ? fminf(hv_this_b * cwb, 10.0f) : 0.f;

  bwr = fminf(fmaxf(bwr, p.clamp_lo), p.clamp_hi);
  bwg = fminf(fmaxf(bwg, p.clamp_lo), p.clamp_hi);
  bwb = fminf(fmaxf(bwb, p.clamp_lo), p.clamp_hi);
  if (!miss) {
    cwr = cwr * bwr;
    cwg = cwg * bwg;
    cwb = cwb * bwb;
  }
  seed_out[i] = (int)(miss ? seed0 : bs_seed);

  // --- emit next + shadow rays -------------------------------------------------
  auto put = [&](float* base, int c, float x) { base[c * N + i] = x; };
  put(next_rays, 0, active_next ? pos.x : 1e30f);
  put(next_rays, 1, active_next ? pos.y : 1e30f);
  put(next_rays, 2, active_next ? pos.z : 1e30f);
  put(next_rays, 3, active_next ? nd.x : 0.f);
  put(next_rays, 4, active_next ? nd.y : 0.f);
  put(next_rays, 5, active_next ? nd.z : 0.f);
  put(next_rays, 6, active_next ? p.t_max : -1.0f);
  // NEGATIVE limit = the trace kernel's first-hit-kills mode
  put(shadow_rays, 0, pos.x);
  put(shadow_rays, 1, pos.y);
  put(shadow_rays, 2, pos.z);
  put(shadow_rays, 3, do_shadow ? l.x : 0.f);
  put(shadow_rays, 4, do_shadow ? l.y : 0.f);
  put(shadow_rays, 5, do_shadow ? l.z : 0.f);
  put(shadow_rays, 6, do_shadow ? -fmaxf(ldist_this - 0.1f, p.t_min) : 0.f);

  put(carry_out, C_CW, cwr);
  put(carry_out, C_CW + 1, cwg);
  put(carry_out, C_CW + 2, cwb);
  put(carry_out, C_HV, hvr);
  put(carry_out, C_HV + 1, hvg);
  put(carry_out, C_HV + 2, hvb);
  put(carry_out, C_ACTIVE, active_next ? 1.f : 0.f);
  put(carry_out, C_SPEC, spec_this ? 1.f : 0.f);
  put(carry_out, C_LDIST, ldist_this);
  put(carry_out, C_HD, hd);
  put(carry_out, C_PEND, np_r);
  put(carry_out, C_PEND + 1, np_g);
  put(carry_out, C_PEND + 2, np_b);
  put(carry_out, C_PSH, do_shadow ? 1.f : 0.f);
}

}  // namespace

extern "C" int vkrt_shade(
    const void* carry, const void* seed, const void* rays, const void* hit_t,
    const void* hit_tri, const void* hit_u, const void* hit_v,
    const void* sh_tri, const void* corner_normal, const void* corner_tangent,
    const void* tri_mat, const void* mat_tab, const void* light_tab,
    int n_lights, const void* corr_tab, const void* corner_uv,
    const void* mat_base_tex, const void* tex_rgba, const void* tex_size,
    int tex_h, int tex_w, int n, int d,
    int first, int resolve_hd, float hitdist_weight, int hitdist_accumulate,
    float t_min, float t_max, float clear_r, float clear_g, float clear_b,
    float clamp_lo, float clamp_hi, void* carry_out, void* seed_out,
    void* next_rays, void* shadow_rays, void* stream) {
  static_assert(CARRY_COLS == 14, "carry layout");
  if (n > 0) {
    Params p;
    p.n = n;
    p.d = d;
    p.first = first;
    p.resolve_hd = resolve_hd;
    p.hitdist_accumulate = hitdist_accumulate;
    p.n_lights = n_lights;
    p.hitdist_weight = hitdist_weight;
    p.t_min = t_min;
    p.t_max = t_max;
    p.clear_r = clear_r;
    p.clear_g = clear_g;
    p.clear_b = clear_b;
    p.clamp_lo = clamp_lo;
    p.clamp_hi = clamp_hi;
    const Albedo alb = {(const float*)corner_uv, (const int*)mat_base_tex,
                        (const float4*)tex_rgba, (const int*)tex_size, tex_h,
                        tex_w};
    const int blocks = (n + kThreads - 1) / kThreads;
    auto kernel = tex_rgba ? &shade_kernel<true> : &shade_kernel<false>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)carry, (const int*)seed, (const float*)rays,
        (const float*)hit_t, (const int*)hit_tri, (const float*)hit_u,
        (const float*)hit_v, (const int*)sh_tri, (const float*)corner_normal,
        (const float*)corner_tangent, (const int*)tri_mat,
        (const float*)mat_tab, (const float*)light_tab,
        (const float*)corr_tab, alb, p, (float*)carry_out, (int*)seed_out,
        (float*)next_rays, (float*)shadow_rays);
  }
  return (int)cudaGetLastError();
}

// What the compiler made of one instantiation of kernel B (albedo 0 or 1):
// registers a thread, static shared bytes a block, local bytes a thread,
// and the blocks of kThreads an SM holds at once.
extern "C" int vkrt_shade_info(int albedo, int* info) {
  cudaFuncAttributes attr;
  auto kernel = albedo ? &shade_kernel<true> : &shade_kernel<false>;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kernel,
                                                            kThreads, 0);
}
