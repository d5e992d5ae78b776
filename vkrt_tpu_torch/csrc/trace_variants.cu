// Kernels D and E: kernel A's walk with stages cut out (D) and with another
// traversal structure (E), for measuring where kernel A's time goes.
//
// D, trace_ablate<mode>: replaces benchmarks/scratch/ablate_kernel.py::
// make_kernel (launched at :95), the TPU closest kernel with its super
// votes, cluster votes or triangle work cut. Modes:
//   full   - kernel A's walk, bit-equal to kernel A (csrc/trace.cu);
//   boxes  - the whole walk with slab tests only: leaves count as misses and
//            t never shrinks (the counterpart of "votes");
//   top    - slab tests of the nodes of depth <= cut_depth only, from a
//            per-node depth column the host derives from the skip links
//            (the counterpart of "svote");
//   count  - full, plus per-ray node visits (slab tests) and leaf visits
//            (Moller-Trumbore tests) as int32 (the counterpart of "count"
//            and of variants.py's "flatcount").
// boxes and top return the miss record; so that the compiler keeps their
// walk, the visit counter decides one impossible branch of the output.
//
// E, trace_variant<variant>: replaces benchmarks/scratch/variants.py::
// make_kernel (launched at :220), traversal-structure variants of the TPU
// closest kernel. Every variant computes kernel A's closest hit (bound
// |t_lim|, no first-hit-kills lanes):
//   threaded - kernel A's stackless skip-link walk ("plain");
//   ordered  - a per-thread stack that visits the nearer child first; in
//              the threaded preorder tree the children of inner node i are
//              i + 1 and skip[i + 1]. The stack holds at most one entry per
//              level: kStack entries, and a deeper tree is refused
//              ("ordered");
//   flat     - a linear scan over the boxes of a cut of the tree (the nodes
//              at depth cut_depth and the shallower leaves, all rays read
//              the same list), then a threaded walk inside each subtree
//              that is hit ("flat");
//   mt       - Moller-Trumbore on the first k_tris triangles, no boxes: the
//              rate of the triangle pipeline ("mtK").
//
// What bounds them on this card: the same as kernel A, divergent node and
// triangle loads (32 B per node visit, 36 B per triangle test) and the
// branchy walk, with a few dozen FP32 operations per visit; mt is bound by
// FP32 operations (about 52 a test). The Moller-Trumbore test and the slab
// test are kernel A's, operation for operation (every MT product and sum
// rounded on its own), so verdicts agree with kernel A's at quad diagonals.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-9f;
constexpr float kSlabScale = 1.0f + 2.0f * 1.7881396e-7f;  // 1 + 2*gamma(3)
constexpr int kThreads = 128;
constexpr int kStack = 64;  // the ordered walk's stack entries

enum AblateMode { kFull = 0, kBoxes = 1, kTop = 2, kCount = 3 };
enum Variant { kThreaded = 0, kOrdered = 1, kFlat = 2, kMt = 3 };

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

__device__ __forceinline__ Ray load_ray(const float* o, int64_t o_sl,
                                        int64_t o_sc, const float* d,
                                        int64_t d_sl, int64_t d_sc, int i) {
  const int64_t io = (int64_t)i * o_sl, id = (int64_t)i * d_sl;
  Ray r;
  r.ox = o[io];
  r.oy = o[io + o_sc];
  r.oz = o[io + 2 * o_sc];
  r.dx = d[id];
  r.dy = d[id + d_sc];
  r.dz = d[id + 2 * d_sc];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// kernel A's slab test of one node box against (t_min, best), far bound
// widened; tnear is the entry distance
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

// kernel A's Moller-Trumbore test of triangle `tri`; on acceptance
// (t in (t_min, b.t)) it becomes the closest hit and the call returns true
__device__ __forceinline__ bool mt(const float* __restrict__ v0,
                                   const float* __restrict__ e1,
                                   const float* __restrict__ e2, int tri,
                                   const Ray& r, float t_min, Best& b) {
  const float* pa = v0 + 3 * (int64_t)tri;
  const float* pb = e1 + 3 * (int64_t)tri;
  const float* pc = e2 + 3 * (int64_t)tri;
  const float v0x = __ldg(pa), v0y = __ldg(pa + 1), v0z = __ldg(pa + 2);
  const float e1x = __ldg(pb), e1y = __ldg(pb + 1), e1z = __ldg(pb + 2);
  const float e2x = __ldg(pc), e2y = __ldg(pc + 1), e2z = __ldg(pc + 2);
  const float px = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float py = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  if (!(fabsf(det) > kDetEps)) return false;
  const float inv_det = 1.0f / det;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = mul(dot3(tx, ty, tz, px, py, pz), inv_det);
  const float qx = sub(mul(ty, e1z), mul(tz, e1y));
  const float qy = sub(mul(tz, e1x), mul(tx, e1z));
  const float qz = sub(mul(tx, e1y), mul(ty, e1x));
  const float v = mul(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv_det);
  const float t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
  if (u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f && t > t_min && t < b.t) {
    b = {t, tri, u, v};
    return true;
  }
  return false;
}

// kernel A's stackless walk over nodes [start, end) of a threaded subtree,
// with kMode's stages cut (kFull is kernel A's walk). It counts the slab
// tests (visits) and the leaves whose box was hit; a hit ends the walk of a
// first-hit-kills ray.
template <int kMode>
__device__ __forceinline__ void walk(const float4* __restrict__ nodes,
                                     int start, int end,
                                     const int* __restrict__ depth,
                                     int cut_depth,
                                     const float* __restrict__ v0,
                                     const float* __restrict__ e1,
                                     const float* __restrict__ e2,
                                     const Ray& r, float t_min, bool kill,
                                     Best& b, unsigned& visits,
                                     unsigned& leaves) {
  int node = start;
  while (node < end) {
    const float4 lo = __ldg(&nodes[2 * node]);
    const float4 hi = __ldg(&nodes[2 * node + 1]);
    const int skip = __float_as_int(lo.w);
    const int tri = __float_as_int(hi.w);
    ++visits;
    float tnear;
    if (!slab(lo, hi, r, t_min, b.t, tnear)) {
      node = skip;
      continue;
    }
    if (tri < 0) {  // inner node: descend (top: only above the cut)
      node = (kMode == kTop && __ldg(&depth[node]) >= cut_depth) ? skip : node + 1;
      continue;
    }
    ++leaves;
    if (kMode == kFull || kMode == kCount) {
      if (mt(v0, e1, e2, tri, r, t_min, b) && kill) return;
    }
    node = skip;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
ablate_kernel(const float4* __restrict__ nodes, int n_nodes,
              const int* __restrict__ depth, int cut_depth,
              const float* __restrict__ v0, const float* __restrict__ e1,
              const float* __restrict__ e2, const float* __restrict__ o,
              int64_t o_sl, int64_t o_sc, const float* __restrict__ d,
              int64_t d_sl, int64_t d_sc, const float* __restrict__ t_lim,
              int n, float t_min, int any_hit, float* __restrict__ t_out,
              int* __restrict__ tri_out, float* __restrict__ u_out,
              float* __restrict__ v_out, int* __restrict__ counts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, o_sl, o_sc, d, d_sl, d_sc, i);
  const float lim = t_lim[i];
  Best b = {fabsf(lim), -1, 0.f, 0.f};
  unsigned visits = 0, leaves = 0;
  walk<kMode>(nodes, 0, n_nodes, depth, cut_depth, v0, e1, e2, r, t_min,
              any_hit != 0 || lim < 0.f, b, visits, leaves);
  if ((kMode == kBoxes || kMode == kTop) && visits == 0xffffffffu) b.tri = -2;
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
  if (kMode == kCount) {
    counts[i] = (int)visits;
    counts[n + i] = (int)leaves;
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const float4* __restrict__ nodes, int n_nodes,
               const int* __restrict__ cut, int n_cut, int k_tris,
               const float* __restrict__ v0, const float* __restrict__ e1,
               const float* __restrict__ e2, const float* __restrict__ o,
               int64_t o_sl, int64_t o_sc, const float* __restrict__ d,
               int64_t d_sl, int64_t d_sc, const float* __restrict__ t_lim,
               int n, float t_min, float* __restrict__ t_out,
               int* __restrict__ tri_out, float* __restrict__ u_out,
               float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, o_sl, o_sc, d, d_sl, d_sc, i);
  Best b = {fabsf(t_lim[i]), -1, 0.f, 0.f};
  float tnear;
  unsigned visits = 0, leaves = 0;  // unused: kernel D's count mode reads them
  if (kVariant == kThreaded) {
    walk<kFull>(nodes, 0, n_nodes, nullptr, 0, v0, e1, e2, r, t_min, false, b,
                visits, leaves);
  } else if (kVariant == kFlat) {
    for (int c = 0; c < n_cut; ++c) {
      const int root = __ldg(&cut[c]);
      const float4 lo = __ldg(&nodes[2 * root]);
      const float4 hi = __ldg(&nodes[2 * root + 1]);
      if (!slab(lo, hi, r, t_min, b.t, tnear)) continue;
      const int tri = __float_as_int(hi.w);
      if (tri >= 0) {
        mt(v0, e1, e2, tri, r, t_min, b);
      } else {
        walk<kFull>(nodes, root + 1, __float_as_int(lo.w), nullptr, 0, v0, e1,
                    e2, r, t_min, false, b, visits, leaves);
      }
    }
  } else if (kVariant == kMt) {
    for (int tri = 0; tri < k_tris; ++tri) mt(v0, e1, e2, tri, r, t_min, b);
  } else {  // kOrdered
    int stack_node[kStack];
    float stack_t[kStack];
    int sp = 0;
    int node = slab(__ldg(&nodes[0]), __ldg(&nodes[1]), r, t_min, b.t, tnear) ? 0 : -1;
    for (;;) {
      if (node < 0) {  // pop the nearest pending subtree still in reach
        while (sp > 0) {
          --sp;
          if (stack_t[sp] <= b.t * kSlabScale) {
            node = stack_node[sp];
            break;
          }
        }
        if (node < 0) break;
      }
      const int tri = __float_as_int(__ldg(&nodes[2 * node + 1]).w);
      if (tri >= 0) {  // its box was hit when it was reached
        mt(v0, e1, e2, tri, r, t_min, b);
        node = -1;
        continue;
      }
      const int left = node + 1;
      const float4 llo = __ldg(&nodes[2 * left]);
      const int right = __float_as_int(llo.w);
      float tl, tr;
      const bool hl = slab(llo, __ldg(&nodes[2 * left + 1]), r, t_min, b.t, tl);
      const bool hr = slab(__ldg(&nodes[2 * right]), __ldg(&nodes[2 * right + 1]),
                           r, t_min, b.t, tr);
      if (hl && hr) {
        const bool left_first = tl <= tr;
        stack_node[sp] = left_first ? right : left;
        stack_t[sp] = left_first ? tr : tl;
        ++sp;
        node = left_first ? left : right;
      } else {
        node = hl ? left : (hr ? right : -1);
      }
    }
  }
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

template <int kMode>
void launch_ablate(cudaStream_t s, int blocks, const float4* nodes,
                   int n_nodes, const int* depth, int cut_depth,
                   const float* v0, const float* e1, const float* e2,
                   const float* o, int64_t o_sl, int64_t o_sc, const float* d,
                   int64_t d_sl, int64_t d_sc, const float* t_lim, int n,
                   float t_min, int any_hit, float* t_out, int* tri_out,
                   float* u_out, float* v_out, int* counts) {
  ablate_kernel<kMode><<<blocks, kThreads, 0, s>>>(
      nodes, n_nodes, depth, cut_depth, v0, e1, e2, o, o_sl, o_sc, d, d_sl,
      d_sc, t_lim, n, t_min, any_hit, t_out, tri_out, u_out, v_out, counts);
}

template <int kVariant>
void launch_variant(cudaStream_t s, int blocks, const float4* nodes,
                    int n_nodes, const int* cut, int n_cut, int k_tris,
                    const float* v0, const float* e1, const float* e2,
                    const float* o, int64_t o_sl, int64_t o_sc,
                    const float* d, int64_t d_sl, int64_t d_sc,
                    const float* t_lim, int n, float t_min, float* t_out,
                    int* tri_out, float* u_out, float* v_out) {
  variant_kernel<kVariant><<<blocks, kThreads, 0, s>>>(
      nodes, n_nodes, cut, n_cut, k_tris, v0, e1, e2, o, o_sl, o_sc, d, d_sl,
      d_sc, t_lim, n, t_min, t_out, tri_out, u_out, v_out);
}

}  // namespace

extern "C" int vkrt_trace_ablate(int mode, const void* nodes, int n_nodes,
                                 const void* depth, int cut_depth,
                                 const void* v0, const void* e1,
                                 const void* e2, const void* o, int64_t o_sl,
                                 int64_t o_sc, const void* d, int64_t d_sl,
                                 int64_t d_sc, const void* t_lim, int n,
                                 float t_min, int any_hit, void* t_out,
                                 void* tri_out, void* u_out, void* v_out,
                                 void* counts, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  auto* f = launch_ablate<kFull>;
  switch (mode) {
    case kFull: f = launch_ablate<kFull>; break;
    case kBoxes: f = launch_ablate<kBoxes>; break;
    case kTop: f = launch_ablate<kTop>; break;
    case kCount: f = launch_ablate<kCount>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  f((cudaStream_t)stream, blocks, (const float4*)nodes, n_nodes,
    (const int*)depth, cut_depth, (const float*)v0, (const float*)e1,
    (const float*)e2, (const float*)o, o_sl, o_sc, (const float*)d, d_sl,
    d_sc, (const float*)t_lim, n, t_min, any_hit, (float*)t_out,
    (int*)tri_out, (float*)u_out, (float*)v_out, (int*)counts);
  return (int)cudaGetLastError();
}

extern "C" int vkrt_trace_variant(int variant, int max_depth, const void* nodes,
                                  int n_nodes, const void* cut, int n_cut,
                                  int k_tris,
                                  const void* v0, const void* e1,
                                  const void* e2, const void* o, int64_t o_sl,
                                  int64_t o_sc, const void* d, int64_t d_sl,
                                  int64_t d_sc, const void* t_lim, int n,
                                  float t_min, void* t_out, void* tri_out,
                                  void* u_out, void* v_out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  auto* f = launch_variant<kThreaded>;
  switch (variant) {
    case kThreaded: f = launch_variant<kThreaded>; break;
    case kOrdered:
      if (max_depth > kStack) return (int)cudaErrorInvalidValue;
      f = launch_variant<kOrdered>;
      break;
    case kFlat: f = launch_variant<kFlat>; break;
    case kMt: f = launch_variant<kMt>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  f((cudaStream_t)stream, blocks, (const float4*)nodes, n_nodes,
    (const int*)cut, n_cut, k_tris, (const float*)v0, (const float*)e1,
    (const float*)e2, (const float*)o, o_sl, o_sc, (const float*)d, d_sl,
    d_sc, (const float*)t_lim, n, t_min, (float*)t_out, (int*)tri_out,
    (float*)u_out, (float*)v_out);
  return (int)cudaGetLastError();
}
