// Native BVH builder: binned-SAH (+ LBVH/Morton fast path).
//
// TPU-native counterpart of the reference's host-side BVH construction
// (src/accelerators/bvh.rs:273-473 recursive binned SAH, :474-676 HLBVH
// morton/radix build, :774-811 flatten). Exposed as a C ABI consumed via
// ctypes (pbrt_tpu_torch/geom/native_build.py); a copy of the JAX package's
// builder, so that both packages cut the same clusters.
//
// Build: g++ -O3 -shared -fPIC -o libbvh.so bvh_builder.cc
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBuckets = 12;

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Bounds {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Bounds &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
  int max_axis() const {
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    if (dx > dy && dx > dz) return 0;
    return dy > dz ? 1 : 2;
  }
};

struct Builder {
  const Bounds *prim;          // per-prim bounds
  const Vec3 *centroid;        // per-prim centroids
  int32_t *order;              // permutation being built
  int max_leaf;
  // output SoA
  std::vector<float> bmin, bmax;
  std::vector<int32_t> rp, nprims, axis;

  int new_node() {
    bmin.insert(bmin.end(), {0, 0, 0});
    bmax.insert(bmax.end(), {0, 0, 0});
    rp.push_back(0);
    nprims.push_back(0);
    axis.push_back(0);
    return static_cast<int>(rp.size()) - 1;
  }

  void set_bounds(int ni, const Bounds &b) {
    bmin[3 * ni] = b.lo.x;
    bmin[3 * ni + 1] = b.lo.y;
    bmin[3 * ni + 2] = b.lo.z;
    bmax[3 * ni] = b.hi.x;
    bmax[3 * ni + 1] = b.hi.y;
    bmax[3 * ni + 2] = b.hi.z;
  }

  int build(int lo, int hi) {
    int ni = new_node();
    Bounds nb;
    for (int i = lo; i < hi; ++i) nb.grow(prim[order[i]]);
    set_bounds(ni, nb);
    int n = hi - lo;
    if (n <= max_leaf) {
      rp[ni] = lo;
      nprims[ni] = n;
      return ni;
    }
    Bounds cb;
    for (int i = lo; i < hi; ++i) cb.grow(centroid[order[i]]);
    int ax = cb.max_axis();
    axis[ni] = ax;
    float cmin = cb.lo[ax], cext = cb.hi[ax] - cb.lo[ax];
    int mid;
    if (cext < 1e-12f) {
      mid = lo + n / 2;
    } else {
      // binned SAH (bvh.rs:319-430)
      int count[kBuckets] = {};
      Bounds bb[kBuckets];
      float inv = kBuckets / cext;
      for (int i = lo; i < hi; ++i) {
        int b = std::min(int((centroid[order[i]][ax] - cmin) * inv), kBuckets - 1);
        count[b]++;
        bb[b].grow(prim[order[i]]);
      }
      float best_cost = FLT_MAX;
      int best = -1;
      for (int k = 0; k < kBuckets - 1; ++k) {
        Bounds b0, b1;
        int c0 = 0, c1 = 0;
        for (int j = 0; j <= k; ++j) {
          if (count[j]) b0.grow(bb[j]);
          c0 += count[j];
        }
        for (int j = k + 1; j < kBuckets; ++j) {
          if (count[j]) b1.grow(bb[j]);
          c1 += count[j];
        }
        if (!c0 || !c1) continue;
        float cost = 0.125f + (c0 * b0.area() + c1 * b1.area()) / nb.area();
        if (cost < best_cost) {
          best_cost = cost;
          best = k;
        }
      }
      if (best < 0) {
        mid = lo + n / 2;
        std::nth_element(order + lo, order + mid, order + hi,
                         [&](int32_t a, int32_t b) {
                           return centroid[a][ax] < centroid[b][ax];
                         });
      } else if (best_cost < float(n) || n > max_leaf) {
        auto it = std::partition(order + lo, order + hi, [&](int32_t p) {
          int b = std::min(int((centroid[p][ax] - cmin) * inv), kBuckets - 1);
          return b <= best;
        });
        mid = static_cast<int>(it - order);
        if (mid == lo || mid == hi) mid = lo + n / 2;
      } else {
        rp[ni] = lo;
        nprims[ni] = n;
        return ni;
      }
    }
    build(lo, mid);
    int right = build(mid, hi);
    rp[ni] = right;
    return ni;
  }
};

}  // namespace

extern "C" {

// Returns node count. Caller passes out buffers sized for 2*T nodes.
int bvh_build_sah(const float *prim_min, const float *prim_max, int t,
                  int max_leaf, float *out_bmin, float *out_bmax,
                  int32_t *out_rp, int32_t *out_n, int32_t *out_axis,
                  int32_t *out_order) {
  if (t <= 0) return 0;
  std::vector<Bounds> prims(t);
  std::vector<Vec3> cents(t);
  for (int i = 0; i < t; ++i) {
    prims[i].lo = {prim_min[3 * i], prim_min[3 * i + 1], prim_min[3 * i + 2]};
    prims[i].hi = {prim_max[3 * i], prim_max[3 * i + 1], prim_max[3 * i + 2]};
    cents[i] = {(prims[i].lo.x + prims[i].hi.x) * 0.5f,
                (prims[i].lo.y + prims[i].hi.y) * 0.5f,
                (prims[i].lo.z + prims[i].hi.z) * 0.5f};
    out_order[i] = i;
  }
  Builder b;
  b.prim = prims.data();
  b.centroid = cents.data();
  b.order = out_order;
  b.max_leaf = max_leaf;
  int est = 2 * t + 2;
  b.bmin.reserve(3 * est);
  b.bmax.reserve(3 * est);
  b.rp.reserve(est);
  b.nprims.reserve(est);
  b.axis.reserve(est);
  b.build(0, t);
  int m = static_cast<int>(b.rp.size());
  std::memcpy(out_bmin, b.bmin.data(), sizeof(float) * 3 * m);
  std::memcpy(out_bmax, b.bmax.data(), sizeof(float) * 3 * m);
  std::memcpy(out_rp, b.rp.data(), sizeof(int32_t) * m);
  std::memcpy(out_n, b.nprims.data(), sizeof(int32_t) * m);
  std::memcpy(out_axis, b.axis.data(), sizeof(int32_t) * m);
  return m;
}

// Morton-code LBVH build (HLBVH fast path, bvh.rs:474-676): sorts prims
// by 30-bit morton code then emits an implicit median-split tree over the
// sorted order. Faster, slightly lower quality than SAH.
static inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

int bvh_build_lbvh(const float *prim_min, const float *prim_max, int t,
                   int max_leaf, float *out_bmin, float *out_bmax,
                   int32_t *out_rp, int32_t *out_n, int32_t *out_axis,
                   int32_t *out_order) {
  if (t <= 0) return 0;
  std::vector<Bounds> prims(t);
  std::vector<Vec3> cents(t);
  Bounds world;
  for (int i = 0; i < t; ++i) {
    prims[i].lo = {prim_min[3 * i], prim_min[3 * i + 1], prim_min[3 * i + 2]};
    prims[i].hi = {prim_max[3 * i], prim_max[3 * i + 1], prim_max[3 * i + 2]};
    cents[i] = {(prims[i].lo.x + prims[i].hi.x) * 0.5f,
                (prims[i].lo.y + prims[i].hi.y) * 0.5f,
                (prims[i].lo.z + prims[i].hi.z) * 0.5f};
    world.grow(cents[i]);
    out_order[i] = i;
  }
  Vec3 ext = {std::max(world.hi.x - world.lo.x, 1e-12f),
              std::max(world.hi.y - world.lo.y, 1e-12f),
              std::max(world.hi.z - world.lo.z, 1e-12f)};
  std::vector<uint32_t> morton(t);
  for (int i = 0; i < t; ++i) {
    uint32_t mx = uint32_t(std::min(1023.f, (cents[i].x - world.lo.x) / ext.x * 1024.f));
    uint32_t my = uint32_t(std::min(1023.f, (cents[i].y - world.lo.y) / ext.y * 1024.f));
    uint32_t mz = uint32_t(std::min(1023.f, (cents[i].z - world.lo.z) / ext.z * 1024.f));
    morton[i] = (expand_bits(mx) << 2) | (expand_bits(my) << 1) | expand_bits(mz);
  }
  std::sort(out_order, out_order + t,
            [&](int32_t a, int32_t b) { return morton[a] < morton[b]; });
  Builder b;  // reuse Builder node emission with median splits via SAH path
  b.prim = prims.data();
  b.centroid = cents.data();
  b.order = out_order;
  b.max_leaf = max_leaf;
  // simple recursive median split over the sorted order
  struct Rec {
    Builder *b;
    int max_leaf;
    int operator()(int lo, int hi) {
      Builder &bb = *b;
      int ni = bb.new_node();
      Bounds nb;
      for (int i = lo; i < hi; ++i) nb.grow(bb.prim[bb.order[i]]);
      bb.set_bounds(ni, nb);
      int n = hi - lo;
      if (n <= max_leaf) {
        bb.rp[ni] = lo;
        bb.nprims[ni] = n;
        return ni;
      }
      bb.axis[ni] = nb.max_axis();
      int mid = lo + n / 2;
      (*this)(lo, mid);
      int right = (*this)(mid, hi);
      bb.rp[ni] = right;
      return ni;
    }
  } rec{&b, max_leaf};
  rec(0, t);
  int m = static_cast<int>(b.rp.size());
  std::memcpy(out_bmin, b.bmin.data(), sizeof(float) * 3 * m);
  std::memcpy(out_bmax, b.bmax.data(), sizeof(float) * 3 * m);
  std::memcpy(out_rp, b.rp.data(), sizeof(int32_t) * m);
  std::memcpy(out_n, b.nprims.data(), sizeof(int32_t) * m);
  std::memcpy(out_axis, b.axis.data(), sizeof(int32_t) * m);
  return m;
}

}  // extern "C"
