// Native scene-build runtime: binned SAH BVH construction (the port's copy
// of native/bvh_builder.cpp, without the cluster decomposition that only
// the Pallas kernels used).
//
// Scene build happens once on the host, so it is plain C++ (exposed via
// ctypes) while the per-ray work runs in the CUDA trace kernels, which walk
// the flat threaded tree this file emits.
//
// Exposed C ABI:
//   vkrt_build_bvh - flat threaded preorder BVH (skip links, 1 tri/leaf)
//
// Built at first use by vkrt_tpu_torch/utils/native.py.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    if (hi.x < lo.x) return 0.f;
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct BuildTri {
  AABB box;
  Vec3 centroid;
  int id;
  bool degenerate;
};

struct Node {
  AABB box;
  int left = -1;    // index into nodes; -1 for leaf
  int right = -1;
  int first = 0;    // leaf range [first, last) into tri order
  int count = 0;
};

constexpr int kBins = 16;

struct Builder {
  std::vector<BuildTri> tris;
  std::vector<int> order;  // permutation being partitioned
  std::vector<Node> nodes;
  int leaf_size;

  AABB range_bounds(int first, int count, bool centroids) const {
    AABB b;
    for (int i = 0; i < count; i++) {
      const BuildTri &t = tris[order[first + i]];
      if (centroids)
        b.grow(t.centroid);
      else
        b.grow(t.box);
    }
    return b;
  }

  int build_range(int first, int count) {
    int node_id = (int)nodes.size();
    nodes.emplace_back();
    Node &n = nodes.back();
    n.box = range_bounds(first, count, false);
    if (count <= leaf_size) {
      n.first = first;
      n.count = count;
      return node_id;
    }
    AABB cb = range_bounds(first, count, true);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    float lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    float extent = ext[axis];
    int mid;
    if (extent < 1e-12f) {
      mid = first + count / 2;  // all centroids coincide: median split
    } else {
      // binned SAH
      AABB bin_box[kBins];
      int bin_cnt[kBins] = {0};
      float inv = kBins / extent;
      auto bin_of = [&](const BuildTri &t) {
        float c = axis == 0 ? t.centroid.x : (axis == 1 ? t.centroid.y : t.centroid.z);
        int b = (int)((c - lo) * inv);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int i = 0; i < count; i++) {
        const BuildTri &t = tris[order[first + i]];
        int b = bin_of(t);
        bin_cnt[b]++;
        bin_box[b].grow(t.box);
      }
      float right_area[kBins];
      AABB acc;
      int right_cnt[kBins];
      int run = 0;
      for (int b = kBins - 1; b >= 1; b--) {
        acc.grow(bin_box[b]);
        run += bin_cnt[b];
        right_area[b] = acc.area();
        right_cnt[b] = run;
      }
      AABB lacc;
      int lrun = 0;
      float best_cost = FLT_MAX;
      int best_split = -1;
      for (int b = 0; b < kBins - 1; b++) {
        lacc.grow(bin_box[b]);
        lrun += bin_cnt[b];
        if (lrun == 0 || lrun == count) continue;
        float cost = lacc.area() * lrun + right_area[b + 1] * right_cnt[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      if (best_split < 0) {
        mid = first + count / 2;
        std::nth_element(
            order.begin() + first, order.begin() + mid,
            order.begin() + first + count, [&](int a, int b2) {
              auto c = [&](int t) {
                const Vec3 &p = tris[t].centroid;
                return axis == 0 ? p.x : (axis == 1 ? p.y : p.z);
              };
              return c(a) < c(b2);
            });
      } else {
        auto it = std::partition(
            order.begin() + first, order.begin() + first + count,
            [&](int t) { return bin_of(tris[t]) <= best_split; });
        mid = (int)(it - order.begin());
        if (mid == first || mid == first + count) mid = first + count / 2;
      }
    }
    int l = build_range(first, mid - first);
    int r = build_range(mid, first + count - mid);
    nodes[node_id].left = l;
    nodes[node_id].right = r;
    return node_id;
  }
};

// preorder flattening with skip links; leaves carry <= leaf_size tris, each
// emitted as its own single-triangle node (tight per-tri boxes).
struct Flattener {
  const Builder &b;
  float *node_min;
  float *node_max;
  int32_t *node_skip;
  int32_t *node_tri;
  int cursor = 0;

  void emit_box(const AABB &box, int skip, int tri) {
    node_min[cursor * 3 + 0] = box.lo.x;
    node_min[cursor * 3 + 1] = box.lo.y;
    node_min[cursor * 3 + 2] = box.lo.z;
    node_max[cursor * 3 + 0] = box.hi.x;
    node_max[cursor * 3 + 1] = box.hi.y;
    node_max[cursor * 3 + 2] = box.hi.z;
    node_skip[cursor] = skip;
    node_tri[cursor] = tri;
    cursor++;
  }

  int subtree_size(int id) const {
    const Node &n = b.nodes[id];
    if (n.left < 0) return n.count;  // leaf expands to count single-tri nodes
    return 1 + subtree_size(n.left) + subtree_size(n.right);
  }

  void flatten(int id) {
    const Node &n = b.nodes[id];
    if (n.left < 0) {
      for (int i = 0; i < n.count; i++) {
        int tid = b.order[n.first + i];
        emit_box(b.tris[tid].box, cursor + 1, tid);
      }
      return;
    }
    int sz = subtree_size(id);
    emit_box(n.box, cursor + sz, -1);
    flatten(n.left);
    flatten(n.right);
  }
};

Builder make_builder(const float *v0, const float *e1, const float *e2,
                     int n_tris, int leaf_size) {
  Builder b;
  b.leaf_size = leaf_size;
  b.tris.resize(n_tris);
  b.order.reserve(n_tris);
  for (int i = 0; i < n_tris; i++) {
    Vec3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
    Vec3 p1{a.x + e1[i * 3], a.y + e1[i * 3 + 1], a.z + e1[i * 3 + 2]};
    Vec3 p2{a.x + e2[i * 3], a.y + e2[i * 3 + 1], a.z + e2[i * 3 + 2]};
    BuildTri t;
    t.box.grow(a);
    t.box.grow(p1);
    t.box.grow(p2);
    t.centroid = {(t.box.lo.x + t.box.hi.x) * 0.5f,
                  (t.box.lo.y + t.box.hi.y) * 0.5f,
                  (t.box.lo.z + t.box.hi.z) * 0.5f};
    t.id = i;
    float ex = 0.f;
    for (int j = 0; j < 3; j++) ex += std::fabs(e1[i * 3 + j]) + std::fabs(e2[i * 3 + j]);
    t.degenerate = ex == 0.f;
    b.tris[i] = t;
    if (!t.degenerate) b.order.push_back(i);
  }
  return b;
}

}  // namespace

extern "C" {

// Flat threaded preorder BVH. Outputs sized for 2*n_tris-1 nodes worst case.
// Returns the number of nodes written, or -1 on error.
int vkrt_build_bvh(const float *v0, const float *e1, const float *e2,
                   int n_tris, int leaf_size, float *node_min, float *node_max,
                   int32_t *node_skip, int32_t *node_tri) {
  if (n_tris <= 0) return -1;
  Builder b = make_builder(v0, e1, e2, n_tris, std::max(leaf_size, 1));
  if (b.order.empty()) return 0;
  b.nodes.reserve(2 * b.order.size());
  b.build_range(0, (int)b.order.size());
  Flattener f{b, node_min, node_max, node_skip, node_tri};
  f.flatten(0);
  return f.cursor;
}

}  // extern "C"
