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
// closest kernel over its 16-wide tree. They are the record of the
// alternatives to kernel A's design. Every one reads its triangles as
// kernel A's 48-byte records and decides an equal-t tie as kernel A does
// (mt_record: the lower triangle id), so each is bit-equal to brute force
// and to kernel A on closest lanes, the triangle id included:
//   ordered  - the wide front-to-back walk, the counterpart of the TPU's
//              16 boxes a visit: records of up to four children, their
//              boxes as columns of one 128-byte line (pack_bvh4_nodes), so
//              a level is one round of seven independent 16-byte loads of
//              adjacent bytes and four slab tests. The children that are
//              hit are sorted by entry distance with a five-exchange
//              network; the walk goes on into the nearest and pushes the
//              others, the farthest first, with their entry distances
//              (kWideStack entries in local memory; a tree that can need
//              more is refused). An empty slot has reference 0 and is
//              skipped by it: no box loses the slab test for every ray. A
//              first-hit-kills lane (t_lim < 0) ends at its first hit.
//              With a counts buffer it also counts, a ray, the slab tests
//              (one a child a record holds: an empty slot is no work the
//              closest hit needs), the triangle tests and the records
//              read. Measured against this
//              form and slower (PERF.md): the top 21 records copied to
//              shared memory, the children in a per-octant order without
//              the sort, 12 blocks an SM forced by 40 registers, and
//              64-byte records of 8-bit boxes;
//   binary   - the nearer child first over the threaded table with a
//              per-thread stack in local memory, each level two dependent
//              rounds of loads (the children of inner node i are i + 1 and
//              skip[i + 1]): the ordering alone, without records, as it was
//              before kernel A took it over. kBinaryStack entries; a deeper
//              tree is refused;
//   threaded - the stackless skip-link walk in fixed preorder, which was
//              kernel A's first design ("plain"). As that design did, it
//              ends a first-hit-kills lane at its first hit;
//   flat     - a linear scan over the boxes of a cut of the tree (the nodes
//              at depth cut_depth and the shallower leaves; all rays read
//              the same list), then a threaded walk inside each subtree
//              that is hit ("flat"). The block copies the list into shared
//              memory with cp.async in tiles of kCutTile boxes, double
//              buffered, and every thread scans a tile by broadcast reads;
//   mt       - Moller-Trumbore on the first k_tris triangle records in
//              scene order, no boxes: the rate of the triangle pipeline
//              ("mtK"). Tiles of kMtTile records through shared memory as
//              flat's; a test is three broadcast 16-byte reads.
// ordered, binary, flat and mt compute the closest hit on every lane (bound
// |t_lim|) but for ordered's first-hit-kills lanes.
//
// What binds them on this card: as kernel A, the latency of dependent,
// divergent loads and the idle lanes of a warp, not the card's rates;
// threaded and flat visit several times the nodes of an ordered walk
// because their closest hit shrinks late. mt is bound by FP32 instructions
// (52 a test). There is no matrix product in a slab or a Moller-Trumbore
// test, so none of these kernels uses the tensor cores. The tests are
// kernel A's own functions (walk.cuh).

#include <cuda_pipeline.h>

#include "walk.cuh"

namespace {

constexpr int kBinaryStack = 64;  // variant binary's stack entries
constexpr int kWideStack = 64;    // variant ordered's stack entries
constexpr int kCutTile = 128;     // flat: cut boxes a shared-memory tile
constexpr int kMtTile = 128;      // mt: triangle records a shared-memory tile

enum Variant { kThreaded = 0, kOrdered = 1, kFlat = 2, kMt = 3, kBinary = 4,
               kOrderedCount = 5 };

// The tables of a launch. nodes: the threaded table (M, 2) float4 =
// [min.xyz | skip], [max.xyz | leaf slot], slot -1 at inner nodes; wide:
// pack_bvh4_nodes' records; cut: (C, 2) float4, the cut nodes' rows of
// `nodes` with, at an inner node, ~(its first child) in place of the -1;
// tris: kernel A's triangle records in leaf order; scene_tris: the same
// records in scene order.
struct Tables {
  const float4* nodes;
  int n_nodes;
  const float4* wide;
  int n_wide;
  const float4* cut;
  int n_cut;
  const float4* tris;
  const float4* scene_tris;
  int k_tris;
};

// The stackless walk over nodes [start, end) of a threaded subtree: on a
// box hit at an inner node go to node + 1, otherwise follow the skip link;
// a hit ends the walk of a first-hit-kills ray.
__device__ __forceinline__ void walk_threaded(const float4* __restrict__ nodes,
                                              int start, int end,
                                              const float4* __restrict__ tris,
                                              const Ray& r, float t_min,
                                              bool kill, Best& b) {
  int node = start;
  while (node < end) {
    const float4 lo = __ldg(&nodes[2 * node]);
    const float4 hi = __ldg(&nodes[2 * node + 1]);
    const int slot = __float_as_int(hi.w);
    float tnear;
    const bool hit = slab(lo, hi, r, t_min, b.t, tnear);
    if (hit && slot < 0) {  // inner node: descend
      node = node + 1;
      continue;
    }
    if (hit && mt_record(tris, slot, r, t_min, b) && kill) return;
    node = __float_as_int(lo.w);
  }
}

// The nearer child first over the threaded table, a stack of node ids and
// entry distances in local memory.
__device__ __forceinline__ void walk_binary(const float4* __restrict__ nodes,
                                            const float4* __restrict__ tris,
                                            const Ray& r, float t_min, Best& b) {
  int stack_node[kBinaryStack];
  float stack_t[kBinaryStack];
  int sp = 0;
  float tnear;
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
    const int slot = __float_as_int(__ldg(&nodes[2 * node + 1]).w);
    if (slot >= 0) {  // its box was hit when it was reached
      mt_record(tris, slot, r, t_min, b);
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

// The block's copy of `count` float4 from global to shared memory, 16 bytes
// a cp.async; every thread of the block calls it and commits the group.
__device__ __forceinline__ void copy_async(float4* dst, const float4* src,
                                           int count) {
  for (int k = threadIdx.x; k < count; k += kThreads)
    __pipeline_memcpy_async(dst + k, src + k, sizeof(float4));
  __pipeline_commit();
}

// A list of `n` items of kWidth float4 each through two shared-memory tiles
// of kTile items: tile k + 1 is copied while tile k is scanned. Every
// thread of the block takes part in the copies and the barriers; `item`
// is called on each item of a tile, in order, by the threads with a ray
// (that loop unrolled kUnroll times).
template <int kTile, int kWidth, int kUnroll, typename Item>
__device__ __forceinline__ void scan_tiles(const float4* __restrict__ list, int n,
                                           bool active, Item item) {
  __shared__ float4 buf[2][kTile * kWidth];
  const int n_tiles = (n + kTile - 1) / kTile;
  copy_async(buf[0], list, min(n, kTile) * kWidth);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int count = min(n - tile * kTile, kTile);
    if (tile + 1 < n_tiles) {
      copy_async(buf[(tile + 1) & 1], list + (int64_t)(tile + 1) * kTile * kWidth,
                 min(n - (tile + 1) * kTile, kTile) * kWidth);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the tile is whole for every thread
    if (active) {
      const float4* it = buf[tile & 1];
#pragma unroll kUnroll
      for (int k = 0; k < count; ++k) item(it + k * kWidth);
    }
    __syncthreads();  // before the next copy lands in this buffer
  }
}

// One child column of a wide record: its reference where the ray hits its
// box and the slot is not empty, else 0; t is then the entry distance,
// else inf.
__device__ __forceinline__ int wide_child(float lox, float loy, float loz,
                                          float hix, float hiy, float hiz,
                                          float ref, const Ray& r, float t_min,
                                          float best, float& t) {
  const int c = __float_as_int(ref);
  const bool hit = slab(make_float4(lox, loy, loz, 0.f),
                        make_float4(hix, hiy, hiz, 0.f), r, t_min, best, t);
  if (hit && c != 0) return c;
  t = __int_as_float(0x7f800000);
  return 0;
}

__device__ __forceinline__ void exchange(float& ta, int& ca, float& tb, int& cb) {
  if (ta > tb) {
    const float t = ta;
    ta = tb;
    tb = t;
    const int c = ca;
    ca = cb;
    cb = c;
  }
}

__device__ __forceinline__ void push(StackEntry* stack, int& sp, int c, float t) {
  if (c != 0) {
    stack[sp] = make_uint2((unsigned)c, __float_as_uint(t));
    ++sp;
  }
}

// The wide front-to-back walk of one ray from record 0: walk.cuh's walk
// over records of up to four children. kCount counts slab tests (one a
// child the record holds), leaves reached and records read.
template <bool kCount>
__device__ __forceinline__ void walk_wide(const float4* __restrict__ wide,
                                          const float4* __restrict__ tris,
                                          const Ray& r, float t_min, bool kill,
                                          Best& b, unsigned& visits,
                                          unsigned& leaves, unsigned& records) {
  StackEntry stack[kWideStack];
  int sp = 0;
  int ref = 0;
  while (ref != kDone) {
    while (ref >= 0) {
      const float4* rec = wide + 8 * (int64_t)ref;
      const float4 lx = __ldg(rec), ly = __ldg(rec + 1), lz = __ldg(rec + 2);
      const float4 hx = __ldg(rec + 3), hy = __ldg(rec + 4), hz = __ldg(rec + 5);
      const float4 cr = __ldg(rec + 6);
      if (kCount) {
        visits += (__float_as_int(cr.x) != 0) + (__float_as_int(cr.y) != 0) +
                  (__float_as_int(cr.z) != 0) + (__float_as_int(cr.w) != 0);
        ++records;
      }
      float t0, t1, t2, t3;
      int c0 = wide_child(lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, cr.x, r, t_min, b.t, t0);
      int c1 = wide_child(lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, cr.y, r, t_min, b.t, t1);
      int c2 = wide_child(lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, cr.z, r, t_min, b.t, t2);
      int c3 = wide_child(lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, cr.w, r, t_min, b.t, t3);
      // nearest first: misses (inf) sink to the end
      exchange(t0, c0, t1, c1);
      exchange(t2, c2, t3, c3);
      exchange(t0, c0, t2, c2);
      exchange(t1, c1, t3, c3);
      exchange(t1, c1, t2, c2);
      push(stack, sp, c3, t3);
      push(stack, sp, c2, t2);
      push(stack, sp, c1, t1);
      ref = c0 != 0 ? c0 : pop(stack, sp, b.t);
    }
    if (ref == kDone) break;
    if (kCount) ++leaves;
    if (mt_record(tris, ~ref, r, t_min, b) && kill) break;
    ref = pop(stack, sp, b.t);
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

// Threads past rays.n hold no ray but stay for the shared-memory copies
// and barriers of flat and mt.
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
variant_kernel(Tables tab, Rays rays, float t_min, Hits out,
               int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < rays.n;
  Ray r = {};
  float lim = 0.f;
  if (active) {
    r = load_ray(rays, i);
    lim = rays.t_lim[i];
  }
  Best b = {fabsf(lim), -1, 0.f, 0.f};
  if constexpr (kVariant == kThreaded) {
    if (active)
      walk_threaded(tab.nodes, 0, tab.n_nodes, tab.tris, r, t_min, lim < 0.f, b);
  } else if constexpr (kVariant == kBinary) {
    if (active) walk_binary(tab.nodes, tab.tris, r, t_min, b);
  } else if constexpr (kVariant == kFlat) {
    scan_tiles<kCutTile, 2, 1>(tab.cut, tab.n_cut, active, [&](const float4* box) {
      const float4 lo = box[0], hi = box[1];
      float tnear;
      if (!slab(lo, hi, r, t_min, b.t, tnear)) return;
      const int w = __float_as_int(hi.w);
      if (w >= 0) {
        mt_record(tab.tris, w, r, t_min, b);
      } else {
        walk_threaded(tab.nodes, ~w, __float_as_int(lo.w), tab.tris, r, t_min,
                      false, b);
      }
    });
  } else if constexpr (kVariant == kMt) {
    scan_tiles<kMtTile, 3, 4>(tab.scene_tris, tab.k_tris, active,
                              [&](const float4* rec) {
      mt_update(rec[0], rec[1], rec[2], r, t_min, b);
    });
  } else {  // kOrdered, kOrderedCount
    unsigned visits = 0, leaves = 0, records = 0;
    if (active)
      walk_wide<kVariant == kOrderedCount>(tab.wide, tab.tris, r, t_min, lim < 0.f, b,
                                           visits, leaves, records);
    if (kVariant == kOrderedCount && active) {
      counts[i] = (int)visits;
      counts[rays.n + i] = (int)leaves;
      counts[2 * (int64_t)rays.n + i] = (int)records;
    }
  }
  if (active) store_hit(out, i, b);
}

template <int kMode>
void launch_ablate(cudaStream_t s, int blocks, const float4* nodes,
                   const float4* tris, int cut_depth, const Rays& rays,
                   float t_min, int any_hit, const Hits& out, int* counts) {
  ablate_kernel<kMode><<<blocks, kThreads, 0, s>>>(
      nodes, tris, cut_depth, rays, t_min, any_hit, out, counts);
}

template <int kVariant>
void launch_variant(cudaStream_t s, int blocks, const Tables& tab,
                    const Rays& rays, float t_min, const Hits& out, int* counts) {
  variant_kernel<kVariant><<<blocks, kThreads, 0, s>>>(tab, rays, t_min, out, counts);
}

// What the compiler made of a kernel: registers a thread, static shared
// memory a block, local memory (stack frame) a thread, and the blocks of
// kThreads an SM holds at once.
template <typename Kernel>
int kernel_info(Kernel kernel, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kernel,
                                                            kThreads, 0);
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

// The tables are Tables' (nodes ... k_tris); max_depth is the threaded
// tree's depth (binary's stack), wide_stack the entries the wide tree can
// need (ordered's); counts, (3, n) int32 or null, is ordered's alone.
extern "C" int vkrt_trace_variant(int variant, int max_depth, int wide_stack,
                                  const void* nodes, int n_nodes,
                                  const void* wide, int n_wide, const void* cut,
                                  int n_cut, const void* tris,
                                  const void* scene_tris, int k_tris,
                                  const void* o, int64_t o_sl, int64_t o_sc,
                                  const void* d, int64_t d_sl, int64_t d_sc,
                                  const void* t_lim, int n, float t_min,
                                  void* t_out, void* tri_out, void* u_out,
                                  void* v_out, void* counts, void* stream) {
  if (counts != nullptr && variant != kOrdered) return (int)cudaErrorInvalidValue;
  auto* f = launch_variant<kThreaded>;
  switch (variant) {
    case kThreaded: f = launch_variant<kThreaded>; break;
    case kOrdered:
      if (wide_stack > kWideStack || n_wide < 1) return (int)cudaErrorInvalidValue;
      f = counts != nullptr ? launch_variant<kOrderedCount> : launch_variant<kOrdered>;
      break;
    case kBinary:
      if (max_depth > kBinaryStack) return (int)cudaErrorInvalidValue;
      f = launch_variant<kBinary>;
      break;
    case kFlat: f = launch_variant<kFlat>; break;
    case kMt: f = launch_variant<kMt>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  f((cudaStream_t)stream, blocks,
    {(const float4*)nodes, n_nodes, (const float4*)wide, n_wide,
     (const float4*)cut, n_cut, (const float4*)tris, (const float4*)scene_tris,
     k_tris},
    {(const float*)o, o_sl, o_sc, (const float*)d, d_sl, d_sc,
     (const float*)t_lim, n},
    t_min, {(float*)t_out, (int*)tri_out, (float*)u_out, (float*)v_out},
    (int*)counts);
  return (int)cudaGetLastError();
}

// info: registers, shared bytes, local bytes, blocks an SM of a variant's
// instantiation (kOrderedCount = 5 is ordered with counts)
extern "C" int vkrt_trace_variant_info(int variant, int* info) {
  switch (variant) {
    case kThreaded: return kernel_info(variant_kernel<kThreaded>, info);
    case kOrdered: return kernel_info(variant_kernel<kOrdered>, info);
    case kFlat: return kernel_info(variant_kernel<kFlat>, info);
    case kMt: return kernel_info(variant_kernel<kMt>, info);
    case kBinary: return kernel_info(variant_kernel<kBinary>, info);
    case kOrderedCount: return kernel_info(variant_kernel<kOrderedCount>, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
