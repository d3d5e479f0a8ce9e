// Native SAH BVH builder.
//
// The framework's C++ runtime component replacing the role of
// accelerators/bvh.cpp's recursiveBuild + flattenBVHTree (reference
// src/accelerators/bvh.cpp:203-260): the build itself is a
// host-side cold path, but for 10^5-10^6 triangle scenes a Python builder
// is minutes while this is milliseconds. Emits the flattened depth-first
// LinearBVHNode SoA layout consumed by the JAX/Pallas traversal
// (pbrt_tpu/scene/bvh.py).
//
// Build: g++ -O2 -shared -fPIC -o libpbrt_native.so bvh_builder.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumBuckets = 12;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float surface_area(const Vec3 &lo, const Vec3 &hi) {
  float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}
inline float axis_of(const Vec3 &v, int ax) {
  return ax == 0 ? v.x : (ax == 1 ? v.y : v.z);
}

struct Builder {
  const Vec3 *lo;
  const Vec3 *hi;
  std::vector<Vec3> cent;
  std::vector<int> order;
  int leaf_max;

  std::vector<Vec3> node_lo, node_hi;
  std::vector<int> node_right, node_count, node_axis;

  int make_node(const Vec3 &blo, const Vec3 &bhi, int right, int count,
                int axis) {
    node_lo.push_back(blo);
    node_hi.push_back(bhi);
    node_right.push_back(right);
    node_count.push_back(count);
    node_axis.push_back(axis);
    return (int)node_lo.size() - 1;
  }

  // Iterative build with explicit stack (depth-first so that the first
  // child is node+1, matching the flattened traversal layout).
  void build(int n) {
    struct Task {
      int start, end, parent;
      bool second;
    };
    std::vector<Task> stack;
    stack.push_back({0, n, -1, false});

    while (!stack.empty()) {
      Task t = stack.back();
      stack.pop_back();
      // bounds of range
      Vec3 blo = {1e30f, 1e30f, 1e30f}, bhi = {-1e30f, -1e30f, -1e30f};
      Vec3 clo = blo, chi = bhi;
      for (int k = t.start; k < t.end; ++k) {
        int i = order[k];
        blo = vmin(blo, lo[i]);
        bhi = vmax(bhi, hi[i]);
        clo = vmin(clo, cent[i]);
        chi = vmax(chi, cent[i]);
      }
      int my_idx = (int)node_lo.size();
      if (t.second && t.parent >= 0) node_right[t.parent] = my_idx;
      int count = t.end - t.start;
      if (count <= leaf_max) {
        make_node(blo, bhi, t.start, count, 0);
        continue;
      }
      // split dimension = largest centroid extent
      float ex = chi.x - clo.x, ey = chi.y - clo.y, ez = chi.z - clo.z;
      int dim = (ex > ey && ex > ez) ? 0 : (ey > ez ? 1 : 2);
      float cmin = axis_of(clo, dim), cmax = axis_of(chi, dim);
      if (cmax - cmin < 1e-12f) {
        make_node(blo, bhi, t.start, count, 0);
        continue;
      }
      // binned SAH
      struct Bucket {
        int n = 0;
        Vec3 lo = {1e30f, 1e30f, 1e30f};
        Vec3 hi = {-1e30f, -1e30f, -1e30f};
      } buckets[kNumBuckets];
      float inv_extent = kNumBuckets / (cmax - cmin);
      for (int k = t.start; k < t.end; ++k) {
        int i = order[k];
        int b = std::min(kNumBuckets - 1,
                         (int)((axis_of(cent[i], dim) - cmin) * inv_extent));
        buckets[b].n++;
        buckets[b].lo = vmin(buckets[b].lo, lo[i]);
        buckets[b].hi = vmax(buckets[b].hi, hi[i]);
      }
      float best_cost = 1e30f;
      int best_split = -1;
      for (int s = 0; s < kNumBuckets - 1; ++s) {
        Vec3 llo = {1e30f, 1e30f, 1e30f}, lhi = {-1e30f, -1e30f, -1e30f};
        Vec3 rlo = llo, rhi = lhi;
        int nl = 0, nr = 0;
        for (int b = 0; b <= s; ++b) {
          if (!buckets[b].n) continue;
          nl += buckets[b].n;
          llo = vmin(llo, buckets[b].lo);
          lhi = vmax(lhi, buckets[b].hi);
        }
        for (int b = s + 1; b < kNumBuckets; ++b) {
          if (!buckets[b].n) continue;
          nr += buckets[b].n;
          rlo = vmin(rlo, buckets[b].lo);
          rhi = vmax(rhi, buckets[b].hi);
        }
        if (!nl || !nr) continue;
        float cost = nl * surface_area(llo, lhi) + nr * surface_area(rlo, rhi);
        if (cost < best_cost) {
          best_cost = cost;
          best_split = s;
        }
      }
      int mid;
      if (best_split < 0) {
        mid = t.start + count / 2;
        std::nth_element(order.begin() + t.start, order.begin() + mid,
                         order.begin() + t.end, [&](int a, int b) {
                           return axis_of(cent[a], dim) <
                                  axis_of(cent[b], dim);
                         });
      } else {
        auto it = std::partition(
            order.begin() + t.start, order.begin() + t.end, [&](int i) {
              int b = std::min(kNumBuckets - 1,
                               (int)((axis_of(cent[i], dim) - cmin) *
                                     inv_extent));
              return b <= best_split;
            });
        mid = (int)(it - order.begin());
        if (mid == t.start || mid == t.end) mid = t.start + count / 2;
      }
      make_node(blo, bhi, -1, 0, dim);
      // push right first; left is processed next → left child = my_idx+1
      stack.push_back({mid, t.end, my_idx, true});
      stack.push_back({t.start, mid, my_idx, false});
    }
  }
};

}  // namespace

extern "C" {

// Returns number of nodes written; output arrays must have capacity 2n.
int bvh_build_sah(const float *lo, const float *hi, int n_prims,
                  int leaf_max, float *out_node_lo, float *out_node_hi,
                  int *out_right, int *out_count, int *out_axis,
                  int *out_prim_order) {
  Builder b;
  b.lo = reinterpret_cast<const Vec3 *>(lo);
  b.hi = reinterpret_cast<const Vec3 *>(hi);
  b.leaf_max = leaf_max;
  b.cent.resize(n_prims);
  b.order.resize(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    b.cent[i] = {0.5f * (b.lo[i].x + b.hi[i].x),
                 0.5f * (b.lo[i].y + b.hi[i].y),
                 0.5f * (b.lo[i].z + b.hi[i].z)};
    b.order[i] = i;
  }
  b.build(n_prims);
  int nn = (int)b.node_lo.size();
  std::memcpy(out_node_lo, b.node_lo.data(), nn * sizeof(Vec3));
  std::memcpy(out_node_hi, b.node_hi.data(), nn * sizeof(Vec3));
  std::memcpy(out_right, b.node_right.data(), nn * sizeof(int));
  std::memcpy(out_count, b.node_count.data(), nn * sizeof(int));
  std::memcpy(out_axis, b.node_axis.data(), nn * sizeof(int));
  std::memcpy(out_prim_order, b.order.data(), n_prims * sizeof(int));
  return nn;
}
}

// ---------------------------------------------------------------------------
// SBVH: binned SAH with SPATIAL splits (Stich et al. 2009, "Spatial
// Splits in Bounding Volume Hierarchies"). Role of an upgraded
// accelerators/bvh.cpp build: spatial splits cut child-overlap on meshes
// like killeroo, which directly reduces traversal node entries. References may be DUPLICATED
// (a triangle straddling a split plane goes to both sides with clipped
// bounds); the emitted prim_order therefore has n_refs >= n_prims
// entries and downstream leaf tables index it, not the prim array.
// ---------------------------------------------------------------------------

namespace {

struct Ref {
  int prim;
  Vec3 lo, hi;
};

struct SBuilder {
  const Vec3 *v0, *v1, *v2;
  int leaf_max;
  std::vector<Vec3> node_lo, node_hi;
  std::vector<int> node_right, node_count, node_axis;
  std::vector<int> out_order;
  float root_sa = 0.0f;
  // spatial-split attempt gate: overlap-SA / root-SA (SBVH alpha)
  static constexpr float kAlpha = 1e-5f;
  static constexpr int kSpatialBins = 16;

  int make_node(const Vec3 &blo, const Vec3 &bhi, int right, int count,
                int axis) {
    node_lo.push_back(blo);
    node_hi.push_back(bhi);
    node_right.push_back(right);
    node_count.push_back(count);
    node_axis.push_back(axis);
    return (int)node_lo.size() - 1;
  }

  // clip triangle `p` to the axis slab [a, b] and return the AABB of the
  // clipped polygon (Sutherland-Hodgman on one axis), intersected with
  // the ref's existing bounds
  static void clip_tri_slab(const Vec3 tri[3], int ax, float a, float b,
                            const Vec3 &ref_lo, const Vec3 &ref_hi,
                            Vec3 *out_lo, Vec3 *out_hi) {
    Vec3 poly[8], tmp[8];
    int n = 3;
    poly[0] = tri[0]; poly[1] = tri[1]; poly[2] = tri[2];
    // clip against x >= a then x <= b
    for (int pass = 0; pass < 2; ++pass) {
      float plane = pass == 0 ? a : b;
      float sign = pass == 0 ? 1.0f : -1.0f;
      int m = 0;
      for (int i = 0; i < n; ++i) {
        const Vec3 &p = poly[i];
        const Vec3 &q = poly[(i + 1) % n];
        float dp = sign * (axis_of(p, ax) - plane);
        float dq = sign * (axis_of(q, ax) - plane);
        if (dp >= 0) tmp[m++] = p;
        if ((dp > 0 && dq < 0) || (dp < 0 && dq > 0)) {
          float t = dp / (dp - dq);
          tmp[m++] = {p.x + t * (q.x - p.x), p.y + t * (q.y - p.y),
                      p.z + t * (q.z - p.z)};
        }
      }
      n = m;
      for (int i = 0; i < n; ++i) poly[i] = tmp[i];
      if (n == 0) break;
    }
    Vec3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n; ++i) {
      lo = vmin(lo, poly[i]);
      hi = vmax(hi, poly[i]);
    }
    // numeric safety: stay inside the parent ref bounds
    *out_lo = vmax(lo, ref_lo);
    *out_hi = vmin(hi, ref_hi);
    if (n == 0) { *out_lo = ref_lo; *out_hi = ref_lo; }
  }

  void build(std::vector<Ref> &refs, int parent, bool second,
             int depth = 0) {
    Vec3 blo = {1e30f, 1e30f, 1e30f}, bhi = {-1e30f, -1e30f, -1e30f};
    Vec3 clo = blo, chi = bhi;
    for (const Ref &r : refs) {
      blo = vmin(blo, r.lo);
      bhi = vmax(bhi, r.hi);
      Vec3 c = {0.5f * (r.lo.x + r.hi.x), 0.5f * (r.lo.y + r.hi.y),
                0.5f * (r.lo.z + r.hi.z)};
      clo = vmin(clo, c);
      chi = vmax(chi, c);
    }
    int my_idx = (int)node_lo.size();
    if (second && parent >= 0) node_right[parent] = my_idx;
    int count = (int)refs.size();
    if (count <= leaf_max) {
      int start = (int)out_order.size();
      for (const Ref &r : refs) out_order.push_back(r.prim);
      make_node(blo, bhi, start, count, 0);
      return;
    }

    // depth guard: degenerate ref sets could otherwise recurse O(n)
    // (and C++ stack-overflow); past this depth force median splits,
    // which halve the range every level
    bool force_median = depth > 48;

    // ---- object split (binned SAH over centroid extent axis)
    float ex = chi.x - clo.x, ey = chi.y - clo.y, ez = chi.z - clo.z;
    int dim = (ex > ey && ex > ez) ? 0 : (ey > ez ? 1 : 2);
    float cmin = axis_of(clo, dim), cmax = axis_of(chi, dim);
    float best_obj_cost = 1e30f;
    int best_obj_split = -1;
    Vec3 obj_llo, obj_lhi, obj_rlo, obj_rhi;
    if (cmax - cmin > 1e-12f) {
      struct Bucket {
        int n = 0;
        Vec3 lo = {1e30f, 1e30f, 1e30f};
        Vec3 hi = {-1e30f, -1e30f, -1e30f};
      } bk[kNumBuckets];
      float inv = kNumBuckets / (cmax - cmin);
      for (const Ref &r : refs) {
        float c = 0.5f * (axis_of(r.lo, dim) + axis_of(r.hi, dim));
        int b = std::min(kNumBuckets - 1, (int)((c - cmin) * inv));
        if (b < 0) b = 0;
        bk[b].n++;
        bk[b].lo = vmin(bk[b].lo, r.lo);
        bk[b].hi = vmax(bk[b].hi, r.hi);
      }
      for (int s = 0; s < kNumBuckets - 1; ++s) {
        Vec3 llo = {1e30f, 1e30f, 1e30f}, lhi = {-1e30f, -1e30f, -1e30f};
        Vec3 rlo = llo, rhi = lhi;
        int nl = 0, nr = 0;
        for (int b = 0; b <= s; ++b)
          if (bk[b].n) { nl += bk[b].n; llo = vmin(llo, bk[b].lo);
                         lhi = vmax(lhi, bk[b].hi); }
        for (int b = s + 1; b < kNumBuckets; ++b)
          if (bk[b].n) { nr += bk[b].n; rlo = vmin(rlo, bk[b].lo);
                         rhi = vmax(rhi, bk[b].hi); }
        if (!nl || !nr) continue;
        float cost = nl * surface_area(llo, lhi)
            + nr * surface_area(rlo, rhi);
        if (cost < best_obj_cost) {
          best_obj_cost = cost;
          best_obj_split = s;
          obj_llo = llo; obj_lhi = lhi; obj_rlo = rlo; obj_rhi = rhi;
        }
      }
    }

    // ---- spatial split attempt, gated on child overlap (SBVH alpha)
    float best_sp_cost = 1e30f;
    int best_sp_bin = -1;
    int sp_dim = dim;
    bool try_spatial = false;
    if (best_obj_split >= 0) {
      Vec3 olo = vmax(obj_llo, obj_rlo);
      Vec3 ohi = vmin(obj_lhi, obj_rhi);
      if (ohi.x > olo.x && ohi.y > olo.y && ohi.z > olo.z &&
          surface_area(olo, ohi) > kAlpha * root_sa)
        try_spatial = true;
    } else {
      try_spatial = true;   // no valid object split: spatial may still work
    }
    float bx = bhi.x - blo.x, by = bhi.y - blo.y, bz = bhi.z - blo.z;
    sp_dim = (bx > by && bx > bz) ? 0 : (by > bz ? 1 : 2);
    float smin = axis_of(blo, sp_dim), smax = axis_of(bhi, sp_dim);
    if (try_spatial && smax - smin > 1e-10f) {
      struct SBin {
        int enter = 0, exit = 0;
        Vec3 lo = {1e30f, 1e30f, 1e30f};
        Vec3 hi = {-1e30f, -1e30f, -1e30f};
      } sb[kSpatialBins];
      float inv = kSpatialBins / (smax - smin);
      float w = (smax - smin) / kSpatialBins;
      for (const Ref &r : refs) {
        int b0 = std::min(kSpatialBins - 1,
                          std::max(0, (int)((axis_of(r.lo, sp_dim) - smin)
                                            * inv)));
        int b1 = std::min(kSpatialBins - 1,
                          std::max(0, (int)((axis_of(r.hi, sp_dim) - smin)
                                            * inv)));
        sb[b0].enter++;
        sb[b1].exit++;
        Vec3 tri[3] = {v0[r.prim], v1[r.prim], v2[r.prim]};
        for (int b = b0; b <= b1; ++b) {
          Vec3 clo2, chi2;
          if (b0 == b1) { clo2 = r.lo; chi2 = r.hi; }
          else clip_tri_slab(tri, sp_dim, smin + b * w, smin + (b + 1) * w,
                             r.lo, r.hi, &clo2, &chi2);
          sb[b].lo = vmin(sb[b].lo, clo2);
          sb[b].hi = vmax(sb[b].hi, chi2);
        }
      }
      for (int s = 0; s < kSpatialBins - 1; ++s) {
        Vec3 llo = {1e30f, 1e30f, 1e30f}, lhi = {-1e30f, -1e30f, -1e30f};
        Vec3 rlo = llo, rhi = lhi;
        int nl = 0, nr = 0;
        for (int b = 0; b <= s; ++b) {
          nl += sb[b].enter;
          if (sb[b].lo.x < 1e29f) { llo = vmin(llo, sb[b].lo);
                                    lhi = vmax(lhi, sb[b].hi); }
        }
        for (int b = s + 1; b < kSpatialBins; ++b) {
          nr += sb[b].exit;
          if (sb[b].lo.x < 1e29f) { rlo = vmin(rlo, sb[b].lo);
                                    rhi = vmax(rhi, sb[b].hi); }
        }
        if (!nl || !nr) continue;
        float cost = nl * surface_area(llo, lhi)
            + nr * surface_area(rlo, rhi);
        if (cost < best_sp_cost) { best_sp_cost = cost; best_sp_bin = s; }
      }
    }

    std::vector<Ref> left, right;
    int used_dim = dim;
    if (force_median) { best_sp_bin = -1; best_obj_split = -1; }
    if (best_sp_bin >= 0 && best_sp_cost < best_obj_cost) {
      // ---- spatial split execution (duplicate straddlers, clipped)
      used_dim = sp_dim;
      float w = (smax - smin) / kSpatialBins;
      float plane = smin + (best_sp_bin + 1) * w;
      for (const Ref &r : refs) {
        if (axis_of(r.hi, sp_dim) <= plane) left.push_back(r);
        else if (axis_of(r.lo, sp_dim) >= plane) right.push_back(r);
        else {
          Vec3 tri[3] = {v0[r.prim], v1[r.prim], v2[r.prim]};
          Ref rl = r, rr = r;
          clip_tri_slab(tri, sp_dim, -1e30f, plane, r.lo, r.hi,
                        &rl.lo, &rl.hi);
          clip_tri_slab(tri, sp_dim, plane, 1e30f, r.lo, r.hi,
                        &rr.lo, &rr.hi);
          left.push_back(rl);
          right.push_back(rr);
        }
      }
      if (left.empty() || right.empty()) { left.clear(); right.clear(); }
    }
    if (left.empty() && right.empty()) {
      // ---- object split execution (or median fallback)
      if (best_obj_split >= 0) {
        float inv = kNumBuckets / (cmax - cmin);
        for (const Ref &r : refs) {
          float c = 0.5f * (axis_of(r.lo, dim) + axis_of(r.hi, dim));
          int b = std::min(kNumBuckets - 1,
                           std::max(0, (int)((c - cmin) * inv)));
          (b <= best_obj_split ? left : right).push_back(r);
        }
      }
      if (left.empty() || right.empty()) {
        left.clear(); right.clear();
        std::vector<Ref> sorted = refs;
        std::sort(sorted.begin(), sorted.end(),
                  [&](const Ref &a, const Ref &b2) {
                    return axis_of(a.lo, dim) + axis_of(a.hi, dim)
                        < axis_of(b2.lo, dim) + axis_of(b2.hi, dim);
                  });
        size_t half = sorted.size() / 2;
        left.assign(sorted.begin(), sorted.begin() + half);
        right.assign(sorted.begin() + half, sorted.end());
      }
      used_dim = dim;
    }
    refs.clear();
    refs.shrink_to_fit();
    make_node(blo, bhi, -1, 0, used_dim);
    build(left, my_idx, false, depth + 1);
    build(right, my_idx, true, depth + 1);
  }
};

}  // namespace

extern "C" {

// SBVH build from triangle vertices. out_prim_order capacity must be
// order_capacity; node arrays capacity 2*order_capacity. Returns the
// node count and writes the emitted reference count to *out_n_refs;
// returns -1 if capacities would be exceeded (caller falls back to SAH).
int bvh_build_sbvh(const float *v0f, const float *v1f, const float *v2f,
                   int n_prims, int leaf_max, float *out_node_lo,
                   float *out_node_hi, int *out_right, int *out_count,
                   int *out_axis, int *out_prim_order,
                   int order_capacity, int *out_n_refs) {
  SBuilder b;
  b.v0 = reinterpret_cast<const Vec3 *>(v0f);
  b.v1 = reinterpret_cast<const Vec3 *>(v1f);
  b.v2 = reinterpret_cast<const Vec3 *>(v2f);
  b.leaf_max = leaf_max;
  std::vector<Ref> refs(n_prims);
  Vec3 rlo = {1e30f, 1e30f, 1e30f}, rhi = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n_prims; ++i) {
    Vec3 lo = vmin(vmin(b.v0[i], b.v1[i]), b.v2[i]);
    Vec3 hi = vmax(vmax(b.v0[i], b.v1[i]), b.v2[i]);
    refs[i] = {i, lo, hi};
    rlo = vmin(rlo, lo);
    rhi = vmax(rhi, hi);
  }
  b.root_sa = surface_area(rlo, rhi);
  b.out_order.reserve(n_prims * 2);
  b.build(refs, -1, false);
  int nn = (int)b.node_lo.size();
  int n_refs = (int)b.out_order.size();
  if (n_refs > order_capacity || 2 * n_refs > 4 * order_capacity)
    return -1;
  std::memcpy(out_node_lo, b.node_lo.data(), nn * sizeof(Vec3));
  std::memcpy(out_node_hi, b.node_hi.data(), nn * sizeof(Vec3));
  std::memcpy(out_right, b.node_right.data(), nn * sizeof(int));
  std::memcpy(out_count, b.node_count.data(), nn * sizeof(int));
  std::memcpy(out_axis, b.node_axis.data(), nn * sizeof(int));
  std::memcpy(out_prim_order, b.out_order.data(), n_refs * sizeof(int));
  *out_n_refs = n_refs;
  return nn;
}
}
