// Native BVH builder: binned-SAH BVH2 flattened with skip links.
//
// The C++ counterpart of the reference's native acceleration layer
// (LuisaCompute builds hardware/embree BVHs in C++; akari_cpp_ext holds the
// reference's other native pieces). The Python/numpy builder in
// akari_render/accel/bvh.py is the fallback; this one handles
// multi-million-triangle scenes at load time.
//
// C ABI (ctypes): see native/__init__.py. All outputs are caller-readable
// buffers allocated here and freed with akr_free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kLeafSize = 4;
constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const Aabb &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float surface() const {
    float dx = std::max(0.f, hi.x - lo.x);
    float dy = std::max(0.f, hi.y - lo.y);
    float dz = std::max(0.f, hi.z - lo.z);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  Aabb box;
  int32_t start = 0;  // leaf: first tri in reordered array
  int32_t count = 0;  // leaf: tri count; 0 = inner
  int32_t skip = -1;  // next node on miss (subtree end)
};

struct Builder {
  const float *v0, *e1, *e2;
  int64_t n;
  std::vector<Aabb> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int32_t> ids;
  std::vector<Node> nodes;
  std::vector<int32_t> order;

  void init() {
    tri_box.resize(n);
    centroid.resize(n);
    ids.resize(n);
    for (int64_t i = 0; i < n; i++) {
      Vec3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
      Vec3 b{a.x + e1[i * 3], a.y + e1[i * 3 + 1], a.z + e1[i * 3 + 2]};
      Vec3 c{a.x + e2[i * 3], a.y + e2[i * 3 + 1], a.z + e2[i * 3 + 2]};
      Aabb bb;
      bb.grow(a);
      bb.grow(b);
      bb.grow(c);
      tri_box[i] = bb;
      centroid[i] = {(bb.lo.x + bb.hi.x) * 0.5f, (bb.lo.y + bb.hi.y) * 0.5f,
                     (bb.lo.z + bb.hi.z) * 0.5f};
      ids[i] = (int32_t)i;
    }
    nodes.reserve(2 * n / kLeafSize + 64);
    order.reserve(n);
    build(0, (int64_t)n);
    // skip links: each node's skip = index right after its subtree; set via
    // a second pass using subtree extents recorded during build (we store
    // them in `skip` already).
  }

  static float axis_of(const Vec3 &v, int a) {
    return a == 0 ? v.x : (a == 1 ? v.y : v.z);
  }

  // builds the subtree over ids[lo, hi); returns node index
  int32_t build(int64_t lo, int64_t hi) {
    int32_t me = (int32_t)nodes.size();
    nodes.emplace_back();
    Aabb box;
    Aabb cbox;
    for (int64_t i = lo; i < hi; i++) {
      box.grow(tri_box[ids[i]]);
      cbox.grow(centroid[ids[i]]);
    }
    nodes[me].box = box;

    int64_t count = hi - lo;
    bool make_leaf = count <= kLeafSize;
    int axis = 0;
    int64_t mid = (lo + hi) / 2;
    if (!make_leaf) {
      Vec3 ext{cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
               cbox.hi.z - cbox.lo.z};
      axis = (ext.y > ext.x) ? 1 : 0;
      if (axis_of(ext, 2) > axis_of(ext, axis)) axis = 2;
      float extent = axis_of(ext, axis);
      if (extent < 1e-12f) {
        make_leaf = count <= kLeafSize * 4;  // degenerate cluster
        if (!make_leaf) {
          // median split on original order to guarantee progress
          std::nth_element(ids.begin() + lo, ids.begin() + mid,
                           ids.begin() + hi);
        }
      } else {
        // binned SAH
        float k = kBins / extent;
        float cmin = axis_of(cbox.lo, axis);
        Aabb bin_box[kBins];
        int64_t bin_cnt[kBins] = {0};
        for (int64_t i = lo; i < hi; i++) {
          int b = (int)std::min<float>(
              kBins - 1, (axis_of(centroid[ids[i]], axis) - cmin) * k);
          bin_box[b].grow(tri_box[ids[i]]);
          bin_cnt[b]++;
        }
        float best_cost = 1e30f;
        int best_b = -1;
        Aabb left_acc[kBins];
        int64_t left_cnt[kBins];
        Aabb acc;
        int64_t cacc = 0;
        for (int b = 0; b < kBins - 1; b++) {
          acc.grow(bin_box[b]);
          cacc += bin_cnt[b];
          left_acc[b] = acc;
          left_cnt[b] = cacc;
        }
        Aabb racc;
        int64_t rcnt = 0;
        for (int b = kBins - 1; b >= 1; b--) {
          racc.grow(bin_box[b]);
          rcnt += bin_cnt[b];
          if (left_cnt[b - 1] == 0 || rcnt == 0) continue;
          float cost =
              left_acc[b - 1].surface() * left_cnt[b - 1] + racc.surface() * rcnt;
          if (cost < best_cost) {
            best_cost = cost;
            best_b = b;
          }
        }
        if (best_b < 0) {
          std::nth_element(
              ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
              [&](int32_t a, int32_t b2) {
                return axis_of(centroid[a], axis) < axis_of(centroid[b2], axis);
              });
        } else {
          float split = cmin + best_b / k;
          auto it = std::partition(ids.begin() + lo, ids.begin() + hi,
                                   [&](int32_t a) {
                                     return axis_of(centroid[a], axis) < split;
                                   });
          mid = it - ids.begin();
          if (mid == lo || mid == hi) mid = (lo + hi) / 2;
        }
      }
    }

    if (make_leaf) {
      nodes[me].start = (int32_t)order.size();
      nodes[me].count = (int32_t)count;
      for (int64_t i = lo; i < hi; i++) order.push_back(ids[i]);
    } else {
      build(lo, mid);
      build(mid, hi);
    }
    nodes[me].skip = (int32_t)nodes.size();
    return me;
  }
};

}  // namespace

extern "C" {

// Returns number of nodes; fills *out pointers (malloc'd, free with akr_free).
int64_t akr_build_bvh(const float *v0, const float *e1, const float *e2,
                      int64_t n_tris, float **out_bmin, float **out_bmax,
                      int32_t **out_start, int32_t **out_count,
                      int32_t **out_skip, int32_t **out_order) {
  Builder b;
  b.v0 = v0;
  b.e1 = e1;
  b.e2 = e2;
  b.n = n_tris;
  b.init();
  int64_t m = (int64_t)b.nodes.size();
  *out_bmin = (float *)malloc(m * 3 * sizeof(float));
  *out_bmax = (float *)malloc(m * 3 * sizeof(float));
  *out_start = (int32_t *)malloc(m * sizeof(int32_t));
  *out_count = (int32_t *)malloc(m * sizeof(int32_t));
  *out_skip = (int32_t *)malloc(m * sizeof(int32_t));
  *out_order = (int32_t *)malloc(n_tris * sizeof(int32_t));
  for (int64_t i = 0; i < m; i++) {
    const Node &nd = b.nodes[i];
    (*out_bmin)[i * 3] = nd.box.lo.x;
    (*out_bmin)[i * 3 + 1] = nd.box.lo.y;
    (*out_bmin)[i * 3 + 2] = nd.box.lo.z;
    (*out_bmax)[i * 3] = nd.box.hi.x;
    (*out_bmax)[i * 3 + 1] = nd.box.hi.y;
    (*out_bmax)[i * 3 + 2] = nd.box.hi.z;
    (*out_start)[i] = nd.start;
    (*out_count)[i] = nd.count;
    (*out_skip)[i] = nd.skip;
  }
  std::memcpy(*out_order, b.order.data(), n_tris * sizeof(int32_t));
  return m;
}

void akr_free(void *p) { free(p); }

}  // extern "C"
