// Kernels D and E: kernel A's walk with stages cut out (D) and other
// traversal structures (E), for measuring where kernel A's time goes.
//
// D, trace_ablate<mode>: replaces benchmarks/scratch/ablate_kernel.py::
// make_kernel (launched at :95), the TPU closest kernel with its super
// votes, cluster votes or triangle work cut. It is kernel A's own walk
// (walk.cuh: front to back over child-box records), instantiated in
// another mode:
//   full   - kernel A's walk, bit-equal to kernel A (csrc/trace.cu);
//   boxes  - the whole walk with slab tests only: leaves count as misses and
//            t never shrinks (the counterpart of "votes");
//   top    - slab tests of the boxes of depth <= cut_depth only, by the
//            depth each record carries (the counterpart of "svote");
//   count  - full, plus per-ray slab tests (two a record) and triangle
//            tests as int32 (the counterpart of "count" and of
//            variants.py's "flatcount").
// boxes and top return the miss record; so that the compiler keeps their
// walk, the visit counter decides one impossible branch of the output.
// Only kernel D's instantiations carry the counters: kernel A's kFull
// compiles them away.
//
// E, trace_variant<variant>: replaces benchmarks/scratch/variants.py::
// make_kernel (launched at :220), traversal-structure variants of the TPU
// closest kernel. They are the record of the alternatives to kernel A's
// design, over the threaded table (one 32-byte box a node, skip links) and
// the scene's three triangle tables. ordered, flat and mt compute the
// closest hit on every lane (bound |t_lim|); threaded does so on closest
// lanes only; an equal-t tie goes to the triangle met first:
//   threaded - the stackless skip-link walk in fixed preorder, which was
//              kernel A's first design ("plain"). As that design did, it
//              ends a first-hit-kills lane (t_lim < 0) at its first hit
//              and promises only the verdict there, so the old walk stays
//              measurable on any-hit rays too;
//   ordered  - the nearer child first with a per-thread stack array that
//              the compiler keeps in local memory, each level two
//              dependent rounds of loads (in the threaded tree the
//              children of inner node i are i + 1 and skip[i + 1]): the
//              ordering alone, without kernel A's records, kept as it
//              was beside kernel A. kOrderedStack
//              entries; a deeper tree is refused ("ordered");
//   flat     - a linear scan over the boxes of a cut of the tree (the nodes
//              at depth cut_depth and the shallower leaves, all rays read
//              the same list), then a threaded walk inside each subtree
//              that is hit ("flat");
//   mt       - Moller-Trumbore on the first k_tris triangles, no boxes: the
//              rate of the triangle pipeline ("mtK").
//
// What binds them on this card: as kernel A, the latency of dependent,
// divergent loads and the idle lanes of a warp, not the card's rates;
// threaded and flat visit several times the nodes of an ordered walk
// because their closest hit shrinks late. mt is bound by FP32 instructions
// (52 a test). The Moller-Trumbore test and the slab test are kernel A's,
// operation for operation (walk.cuh), so verdicts agree with kernel A's at
// quad diagonals.

#include "walk.cuh"

namespace {

constexpr int kOrderedStack = 64;  // variant ordered's stack entries

enum Variant { kThreaded = 0, kOrdered = 1, kFlat = 2, kMt = 3 };

__device__ __forceinline__ float4 load3(const float* __restrict__ p, int tri) {
  p += 3 * (int64_t)tri;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
}

// Triangle `tri` of the scene's three tables; on acceptance (t in
// (t_min, b.t)) it becomes the closest hit and the call returns true
__device__ __forceinline__ bool mt(const float* __restrict__ v0,
                                   const float* __restrict__ e1,
                                   const float* __restrict__ e2, int tri,
                                   const Ray& r, float t_min, Best& b) {
  float t, u, v;
  if (!mt_test(load3(v0, tri), load3(e1, tri), load3(e2, tri), r, t_min, t, u, v) ||
      !(t < b.t))
    return false;
  b = {t, tri, u, v};
  return true;
}

// The stackless walk over nodes [start, end) of a threaded subtree: on a
// box hit at an inner node go to node + 1, otherwise follow the skip link;
// a hit ends the walk of a first-hit-kills ray.
// nodes: (M, 2) float4 = [min.xyz | skip], [max.xyz | tri], tri -1 if inner
__device__ __forceinline__ void walk_threaded(const float4* __restrict__ nodes,
                                              int start, int end,
                                              const float* __restrict__ v0,
                                              const float* __restrict__ e1,
                                              const float* __restrict__ e2,
                                              const Ray& r, float t_min,
                                              bool kill, Best& b) {
  int node = start;
  while (node < end) {
    const float4 lo = __ldg(&nodes[2 * node]);
    const float4 hi = __ldg(&nodes[2 * node + 1]);
    const int tri = __float_as_int(hi.w);
    float tnear;
    const bool hit = slab(lo, hi, r, t_min, b.t, tnear);
    if (hit && tri < 0) {  // inner node: descend
      node = node + 1;
      continue;
    }
    if (hit && mt(v0, e1, e2, tri, r, t_min, b) && kill) return;
    node = __float_as_int(lo.w);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
ablate_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
              int cut_depth, Rays rays, float t_min, int any_hit, Hits out,
              int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = load_ray(rays, i);
  const float lim = rays.t_lim[i];
  Best b = {fabsf(lim), -1, 0.f, 0.f};
  unsigned visits = 0, leaves = 0;
  walk<kMode>(nodes, tris, cut_depth, r, t_min, any_hit != 0 || lim < 0.f, b,
              visits, leaves);
  if ((kMode == kBoxes || kMode == kTop) && visits == 0xffffffffu) b.tri = -2;
  store_hit(out, i, b);
  if (kMode == kCount) {
    counts[i] = (int)visits;
    counts[rays.n + i] = (int)leaves;
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const float4* __restrict__ nodes, int n_nodes,
               const int* __restrict__ cut, int n_cut, int k_tris,
               const float* __restrict__ v0, const float* __restrict__ e1,
               const float* __restrict__ e2, Rays rays, float t_min, Hits out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = load_ray(rays, i);
  const float lim = rays.t_lim[i];
  Best b = {fabsf(lim), -1, 0.f, 0.f};
  float tnear;
  if (kVariant == kThreaded) {
    walk_threaded(nodes, 0, n_nodes, v0, e1, e2, r, t_min, lim < 0.f, b);
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
        walk_threaded(nodes, root + 1, __float_as_int(lo.w), v0, e1, e2, r,
                      t_min, false, b);
      }
    }
  } else if (kVariant == kMt) {
    for (int tri = 0; tri < k_tris; ++tri) mt(v0, e1, e2, tri, r, t_min, b);
  } else {  // kOrdered
    int stack_node[kOrderedStack];
    float stack_t[kOrderedStack];
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
  store_hit(out, i, b);
}

template <int kMode>
void launch_ablate(cudaStream_t s, int blocks, const float4* nodes,
                   const float4* tris, int cut_depth, const Rays& rays,
                   float t_min, int any_hit, const Hits& out, int* counts) {
  ablate_kernel<kMode><<<blocks, kThreads, 0, s>>>(
      nodes, tris, cut_depth, rays, t_min, any_hit, out, counts);
}

template <int kVariant>
void launch_variant(cudaStream_t s, int blocks, const float4* nodes,
                    int n_nodes, const int* cut, int n_cut, int k_tris,
                    const float* v0, const float* e1, const float* e2,
                    const Rays& rays, float t_min, const Hits& out) {
  variant_kernel<kVariant><<<blocks, kThreads, 0, s>>>(
      nodes, n_nodes, cut, n_cut, k_tris, v0, e1, e2, rays, t_min, out);
}

}  // namespace

// nodes, tris: kernel A's record tables; max_depth: the tree's depth
extern "C" int vkrt_trace_ablate(int mode, const void* nodes, const void* tris,
                                 int max_depth, int cut_depth, const void* o,
                                 int64_t o_sl, int64_t o_sc, const void* d,
                                 int64_t d_sl, int64_t d_sc, const void* t_lim,
                                 int n, float t_min, int any_hit, void* t_out,
                                 void* tri_out, void* u_out, void* v_out,
                                 void* counts, void* stream) {
  if (max_depth > kStack) return (int)cudaErrorInvalidValue;
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
  f((cudaStream_t)stream, blocks, (const float4*)nodes, (const float4*)tris,
    cut_depth,
    {(const float*)o, o_sl, o_sc, (const float*)d, d_sl, d_sc,
     (const float*)t_lim, n},
    t_min, any_hit, {(float*)t_out, (int*)tri_out, (float*)u_out, (float*)v_out},
    (int*)counts);
  return (int)cudaGetLastError();
}

// nodes: the threaded table; v0, e1, e2: the scene's triangle tables
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
      if (max_depth > kOrderedStack) return (int)cudaErrorInvalidValue;
      f = launch_variant<kOrdered>;
      break;
    case kFlat: f = launch_variant<kFlat>; break;
    case kMt: f = launch_variant<kMt>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  f((cudaStream_t)stream, blocks, (const float4*)nodes, n_nodes,
    (const int*)cut, n_cut, k_tris, (const float*)v0, (const float*)e1,
    (const float*)e2,
    {(const float*)o, o_sl, o_sc, (const float*)d, d_sl, d_sc,
     (const float*)t_lim, n},
    t_min, {(float*)t_out, (int*)tri_out, (float*)u_out, (float*)v_out});
  return (int)cudaGetLastError();
}
