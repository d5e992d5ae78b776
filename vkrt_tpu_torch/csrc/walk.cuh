// The ray-BVH walk shared by kernel A (trace.cu) and kernel D
// (trace_variants.cu), so the two cannot drift: the slab test, the
// Moller-Trumbore test and the front-to-back walk over child-box records.
// Kernel E's variants (trace_variants.cu) take their slab test, triangle
// test, tie rule and pop from here too.
//
// Tables (built on the host, vkrt_tpu_torch/ops/cuda/trace.py):
//   nodes: one 64-byte record per inner node, four float4
//          [left min.xyz | left ref] [left max.xyz | right ref]
//          [right min.xyz | depth]   [right max.xyz | 0]
//          ref >= 0 is a record, ref < 0 is the triangle record ~ref;
//   tris:  one 48-byte record per triangle in leaf order, three float4
//          [v0.xyz | scene triangle id] [e1.xyz | 0] [e2.xyz | 0].
// One level of the walk is one round of four independent 16-byte loads of
// adjacent bytes; a triangle test is three.
//
// The walk keeps one (ref, entry distance) pair per level it has left a
// farther child behind on: kStack entries of 8 bytes a thread, a 256-byte
// array in local memory, which the L1 cache serves. (Held in shared memory
// it costs 32 KB a block, an SM then holds 6 blocks in place of 12, and
// every ray set measured ran 8-27% slower: occupancy is worth more to this
// walk than a stack without local-memory traffic. Held in registers, two
// arrays indexed only in fully unrolled loops, it ran 2-3 times slower.)
// A tree deeper than kStack is refused by the callers.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-9f;
constexpr float kSlabScale = 1.0f + 2.0f * 1.7881396e-7f;  // 1 + 2*gamma(3)
constexpr int kThreads = 128;
constexpr int kStack = 32;       // stack entries a thread: the deepest tree taken
constexpr int kDone = INT_MIN;   // no reference left: ~kDone is no triangle slot
// A stack entry: the reference left behind and its entry distance (bits)
typedef uint2 StackEntry;

enum WalkMode { kFull = 0, kBoxes = 1, kTop = 2, kCount = 3 };

// The Moller-Trumbore arithmetic rounds every product and sum on its own
// (no fused multiply-add), in the operation order of mt_block, so the
// kernels accept exactly the triangles the plain version accepts. With
// contracted FMAs a ray on the shared diagonal of a quad could miss both
// of its triangles while the plain version hits one of them.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

__device__ __forceinline__ float safe_inv(float d) {
  float n = fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d;
  return 1.0f / n;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// The rays of a launch: (N,3) o and d with lane and component strides (in
// elements), (N,) contiguous limits.
struct Rays {
  const float* o;
  int64_t o_sl, o_sc;
  const float* d;
  int64_t d_sl, d_sc;
  const float* t_lim;
  int n;
};

// The hit record of a launch, (N,) each.
struct Hits {
  float* t;
  int* tri;
  float* u;
  float* v;
};

__device__ __forceinline__ Ray load_ray(const Rays& rays, int i) {
  const int64_t io = (int64_t)i * rays.o_sl, id = (int64_t)i * rays.d_sl;
  Ray r;
  r.ox = rays.o[io];
  r.oy = rays.o[io + rays.o_sc];
  r.oz = rays.o[io + 2 * rays.o_sc];
  r.dx = rays.d[id];
  r.dy = rays.d[id + rays.d_sc];
  r.dz = rays.d[id + 2 * rays.d_sc];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// The slab test of one box against (t_min, best); tnear is the entry
// distance. The far bound is widened by 1 + 2*gamma(3) (Ize 2013) so
// rounding never culls a box whose triangle the MT test would accept.
__device__ __forceinline__ bool slab(const float4 lo, const float4 hi,
                                     const Ray& r, float t_min, float best,
                                     float& tnear) {
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  tnear = fmaxf(
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)), t_min);
  const float tfar = fminf(
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)), best);
  return tnear <= tfar * kSlabScale;
}

// The closest hit so far of one ray.
struct Best {
  float t;
  int tri;
  float u, v;
};

__device__ __forceinline__ void store_hit(const Hits& out, int i, const Best& b) {
  out.t[i] = b.t;
  out.tri[i] = b.tri;
  out.u[i] = b.u;
  out.v[i] = b.v;
}

// Moller-Trumbore of one triangle (vertex a, edges e1 and e2; the w lanes
// are not read): true with t, u, v when the ray crosses it beyond t_min.
// The far bound is the caller's.
__device__ __forceinline__ bool mt_test(const float4 a, const float4 e1,
                                        const float4 e2, const Ray& r,
                                        float t_min, float& t, float& u,
                                        float& v) {
  const float px = sub(mul(r.dy, e2.z), mul(r.dz, e2.y));
  const float py = sub(mul(r.dz, e2.x), mul(r.dx, e2.z));
  const float pz = sub(mul(r.dx, e2.y), mul(r.dy, e2.x));
  const float det = dot3(e1.x, e1.y, e1.z, px, py, pz);
  if (!(fabsf(det) > kDetEps)) return false;
  const float inv_det = 1.0f / det;
  const float tx = r.ox - a.x, ty = r.oy - a.y, tz = r.oz - a.z;
  u = mul(dot3(tx, ty, tz, px, py, pz), inv_det);
  const float qx = sub(mul(ty, e1.z), mul(tz, e1.y));
  const float qy = sub(mul(tz, e1.x), mul(tx, e1.z));
  const float qz = sub(mul(tx, e1.y), mul(ty, e1.x));
  v = mul(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv_det);
  t = mul(dot3(e2.x, e2.y, e2.z, qx, qy, qz), inv_det);
  return u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f && t > t_min;
}

// A loaded triangle record (a, e1, e2) against the closest hit so far. A
// hit at an equal t goes to the lower scene triangle id, as the plain
// version's argmin gives it, so the winner does not depend on the order of
// the walk (b.tri is -1 while b.t is the ray's limit, so a hit at the limit
// itself is never taken).
__device__ __forceinline__ bool mt_update(const float4 a, const float4 e1,
                                          const float4 e2, const Ray& r,
                                          float t_min, Best& b) {
  float t, u, v;
  if (!mt_test(a, e1, e2, r, t_min, t, u, v)) return false;
  const int tri = __float_as_int(a.w);
  if (t < b.t || (t == b.t && tri < b.tri)) {
    b = {t, tri, u, v};
    return true;
  }
  return false;
}

// The triangle record `slot` of the table against the closest hit so far.
__device__ __forceinline__ bool mt_record(const float4* __restrict__ tris,
                                          int slot, const Ray& r, float t_min,
                                          Best& b) {
  const float4* rec = tris + 3 * (int64_t)slot;
  const float4 a = __ldg(rec), e1 = __ldg(rec + 1), e2 = __ldg(rec + 2);
  return mt_update(a, e1, e2, r, t_min, b);
}

// The newest stack entry whose entry distance is still within best (the
// slab test's own far bound, so this is that test taken again), or kDone.
__device__ __forceinline__ int pop(const StackEntry* stack, int& sp, float best) {
  const float reach = best * kSlabScale;
  while (sp > 0) {
    --sp;
    const StackEntry e = stack[sp];
    if (__uint_as_float(e.y) <= reach) return (int)e.x;
  }
  return kDone;
}

// The front-to-back walk of one ray from the root record, with kMode's
// stages cut (kFull is kernel A's walk): down the records to a leaf, its
// triangle, and the next reference from the stack, until none is left. At
// a record both child boxes are tested against (t_min, best); the walk
// goes on into the nearer one that is hit and pushes the farther with its
// entry distance; a hit ends the walk of a first-hit-kills ray (which
// takes the nearer child first too: its first hit is likelier there).
// kBoxes and kTop test no triangle, so best never shrinks; kTop goes into
// no record whose children lie deeper than cut_depth. Modes other than
// kFull count the slab tests (two a record) and the leaves reached.
template <int kMode>
__device__ __forceinline__ void walk(const float4* __restrict__ nodes,
                                     const float4* __restrict__ tris,
                                     int cut_depth, const Ray& r, float t_min,
                                     bool kill, Best& b, unsigned& visits,
                                     unsigned& leaves) {
  StackEntry stack[kStack];
  int sp = 0;
  int ref = 0;
  while (ref != kDone) {
    while (ref >= 0) {
      const float4* rec = nodes + 4 * (int64_t)ref;
      const float4 n0 = __ldg(rec), n1 = __ldg(rec + 1);
      const float4 n2 = __ldg(rec + 2), n3 = __ldg(rec + 3);
      if (kMode != kFull) visits += 2;
      float tl, tr;
      bool hl = slab(n0, n1, r, t_min, b.t, tl);
      bool hr = slab(n2, n3, r, t_min, b.t, tr);
      const int cl = __float_as_int(n0.w), cr = __float_as_int(n1.w);
      if (kMode == kTop && __float_as_int(n2.w) + 2 > cut_depth) {
        hl = hl && cl < 0;
        hr = hr && cr < 0;
      }
      if (hl && hr) {
        const bool left_first = tl <= tr;
        stack[sp] = make_uint2((unsigned)(left_first ? cr : cl),
                               __float_as_uint(left_first ? tr : tl));
        ++sp;
        ref = left_first ? cl : cr;
      } else if (hl) {
        ref = cl;
      } else if (hr) {
        ref = cr;
      } else {
        ref = pop(stack, sp, b.t);
      }
    }
    if (ref == kDone) break;
    if (kMode != kFull) ++leaves;
    if (kMode == kFull || kMode == kCount) {
      if (mt_record(tris, ~ref, r, t_min, b) && kill) break;
    }
    ref = pop(stack, sp, b.t);
  }
}

}  // namespace
