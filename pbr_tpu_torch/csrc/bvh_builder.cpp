// Native SAH BVH builder.
//
// Mirrors pbr_tpu/accel/bvh.py exactly (full-sweep SAH with stable
// centroid sorts, mean-split fallback above sah_faces_limit, larger-
// surface-area child first, preorder linearization with escape indices,
// epsilon-padded face AABBs) so the Python and native builders produce
// byte-identical arrays — tests assert equality. The reference's builder
// was the largest host component (source/accelstructures/BVH.cpp, 1,055
// LoC C++); this is its TPU-framework counterpart for large scenes where
// NumPy build time matters.
//
// C ABI for ctypes: pbr_build_bvh() fills a result struct of malloc'd
// arrays; pbr_free_bvh() releases them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Vec3f {
  float x, y, z;
};

static inline Vec3f vmin(const Vec3f& a, const Vec3f& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3f vmax(const Vec3f& a, const Vec3f& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

// Surface area in f32 (matching NumPy's f32 _surface_area); costs then
// accumulate in double exactly like NumPy's f32-SA x f64-count products.
static inline float surface_area_f(const Vec3f& mn, const Vec3f& mx) {
  float dx = mx.x - mn.x, dy = mx.y - mn.y, dz = mx.z - mn.z;
  return 2.0f * (dx * dy + dy * dz + dx * dz);
}

struct Node {
  Vec3f bb_min, bb_max;
  int32_t left = -1, right = -1;  // indices into node pool
  std::vector<int64_t> faces;     // leaf payload
  int32_t size = 1;               // subtree node count
  bool skip = false;              // skip-ahead: elide from the linear stream
  int32_t esize = 1;              // emitted subtree size (records serialized)
};

struct Builder {
  const Vec3f* fmin;
  const Vec3f* fmax;
  const float* cx;  // per-axis centroid arrays
  const float* cy;
  const float* cz;
  int64_t max_faces;
  int64_t sah_limit;
  double skip_cmp;  // < 0 disables skip-ahead (matches accel/bvh.py)
  std::vector<Node> pool;

  const float* centroid(int axis) const {
    return axis == 0 ? cx : (axis == 1 ? cy : cz);
  }

  int32_t make_node(std::vector<int64_t>& ids) {
    Vec3f mn = fmin[ids[0]], mx = fmax[ids[0]];
    for (size_t i = 1; i < ids.size(); i++) {
      mn = vmin(mn, fmin[ids[i]]);
      mx = vmax(mx, fmax[ids[i]]);
    }
    int32_t self = (int32_t)pool.size();
    pool.push_back(Node{mn, mx});

    int64_t n = (int64_t)ids.size();
    if (n <= max_faces) {
      pool[self].faces = std::move(ids);
      return self;
    }

    std::vector<int64_t> left_ids, right_ids;
    if (n <= sah_limit) {
      // Full-sweep SAH on all three axes; stable sort matches NumPy's
      // argsort(kind='stable') tie behavior.
      double best_cost = 0.0;
      int best_axis = -1;
      int64_t best_split = 0;
      std::vector<int64_t> best_order;
      std::vector<double> cost_l(n), cost_r(n);
      for (int axis = 0; axis < 3; axis++) {
        const float* c = centroid(axis);
        // Start each axis from the incoming face order: stable-sort ties
        // must resolve exactly like NumPy's argsort(kind='stable') on the
        // original subset order.
        std::vector<int64_t> order(ids);
        std::stable_sort(order.begin(), order.end(),
                         [&](int64_t a, int64_t b) { return c[a] < c[b]; });
        // prefix AABB surface areas (splits 1..n-1)
        Vec3f mn2 = fmin[order[0]], mx2 = fmax[order[0]];
        for (int64_t i = 0; i < n - 1; i++) {
          if (i > 0) {
            mn2 = vmin(mn2, fmin[order[i]]);
            mx2 = vmax(mx2, fmax[order[i]]);
          }
          cost_l[i] = (double)surface_area_f(mn2, mx2) * (double)(i + 1);
        }
        Vec3f mn3 = fmin[order[n - 1]], mx3 = fmax[order[n - 1]];
        for (int64_t i = n - 1; i >= 1; i--) {
          if (i < n - 1) {
            mn3 = vmin(mn3, fmin[order[i]]);
            mx3 = vmax(mx3, fmax[order[i]]);
          }
          cost_r[i - 1] = (double)surface_area_f(mn3, mx3) * (double)(n - i);
        }
        // argmin over split positions, first-wins ties (np.argmin)
        double bc = cost_l[0] + cost_r[0];
        int64_t bi = 0;
        for (int64_t i = 1; i < n - 1; i++) {
          double cc = cost_l[i] + cost_r[i];
          if (cc < bc) {
            bc = cc;
            bi = i;
          }
        }
        if (best_axis < 0 || bc < best_cost) {
          best_cost = bc;
          best_axis = axis;
          best_split = bi + 1;
          best_order = order;
        }
      }
      left_ids.assign(best_order.begin(), best_order.begin() + best_split);
      right_ids.assign(best_order.begin() + best_split, best_order.end());
    } else {
      // Mean split: best of three axes by induced-SAH cost, 50:50 fallback.
      const Vec3f mnn = pool[self].bb_min, mxx = pool[self].bb_max;
      double best_cost = 0.0;
      bool have = false;
      std::vector<int64_t> bl, br;
      for (int axis = 0; axis < 3; axis++) {
        float mid = 0.5f * ((axis == 0 ? mnn.x : axis == 1 ? mnn.y : mnn.z) +
                            (axis == 0 ? mxx.x : axis == 1 ? mxx.y : mxx.z));
        const float* c = centroid(axis);
        std::vector<int64_t> l, r;
        for (int64_t id : ids) (c[id] < mid ? l : r).push_back(id);
        if (l.empty() || r.empty()) continue;
        Vec3f lmn = fmin[l[0]], lmx = fmax[l[0]];
        for (size_t i = 1; i < l.size(); i++) {
          lmn = vmin(lmn, fmin[l[i]]);
          lmx = vmax(lmx, fmax[l[i]]);
        }
        Vec3f rmn = fmin[r[0]], rmx = fmax[r[0]];
        for (size_t i = 1; i < r.size(); i++) {
          rmn = vmin(rmn, fmin[r[i]]);
          rmx = vmax(rmx, fmax[r[i]]);
        }
        double cost = (double)surface_area_f(lmn, lmx) * (double)l.size() +
                      (double)surface_area_f(rmn, rmx) * (double)r.size();
        if (!have || cost < best_cost) {
          have = true;
          best_cost = cost;
          bl = std::move(l);
          br = std::move(r);
        }
      }
      if (!have) {
        int64_t half = n / 2;
        left_ids.assign(ids.begin(), ids.begin() + half);
        right_ids.assign(ids.begin() + half, ids.end());
      } else {
        left_ids = std::move(bl);
        right_ids = std::move(br);
      }
    }

    int32_t li = make_node(left_ids);
    int32_t ri = make_node(right_ids);
    // Larger-surface-area child first (f32 comparison, like NumPy).
    float sa_l = surface_area_f(pool[li].bb_min, pool[li].bb_max);
    float sa_r = surface_area_f(pool[ri].bb_min, pool[ri].bb_max);
    if (sa_r > sa_l) std::swap(li, ri);
    pool[self].left = li;
    pool[self].right = ri;
    pool[self].size = 1 + pool[li].size + pool[ri].size;
    // Skip-ahead marking (reference BVH::skipAheadOfNodes, BVH.cpp:770-795):
    // an inner left child with SA close to this node's is elided from the
    // serialized stream. f32 ratio promoted to double exactly like NumPy
    // comparing a f32 quotient against a Python float.
    if (skip_cmp >= 0.0 && pool[li].left >= 0) {
      float sa_self = surface_area_f(pool[self].bb_min, pool[self].bb_max);
      float sa_first = surface_area_f(pool[li].bb_min, pool[li].bb_max);
      if (sa_self > 0.0f && (double)(sa_first / sa_self) >= skip_cmp) {
        pool[li].skip = true;
      }
    }
    int32_t contrib_l = pool[li].esize - (pool[li].skip ? 1 : 0);
    pool[self].esize = 1 + contrib_l + pool[ri].esize;
    return self;
  }
};

}  // namespace

extern "C" {

struct PbrBvhResult {
  int64_t n_nodes;
  int64_t n_faces;
  float* bb_min;        // (n_nodes*3)
  float* bb_max;        // (n_nodes*3)
  int32_t* leaf_first;  // (n_nodes)
  int32_t* leaf_count;  // (n_nodes)
  int32_t* exit_idx;    // (n_nodes)
  int64_t* leaf_order;  // (n_faces)
};

// skip_cmp < 0 disables skip-ahead; >= 0 elides inner left children with
// SA(left)/SA(node) >= skip_cmp (reference bvh.skip_ahead_compare).
int pbr_build_bvh(const float* v0, const float* v1, const float* v2,
                  int64_t n_faces, int64_t max_faces, int64_t sah_limit,
                  double skip_cmp, PbrBvhResult* out) {
  if (n_faces <= 0) return 1;
  std::vector<Vec3f> fmin(n_faces), fmax(n_faces);
  std::vector<float> cx(n_faces), cy(n_faces), cz(n_faces);
  for (int64_t i = 0; i < n_faces; i++) {
    Vec3f a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3f b{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    Vec3f c{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    Vec3f mn = vmin(vmin(a, b), c);
    Vec3f mx = vmax(vmax(a, b), c);
    // Conservative pad, identical to accel/bvh.py:
    // pad = 1e-6f + 1e-5f * max(|fmin|, |fmax|) per component.
    Vec3f pad{1e-6f + 1e-5f * std::max(std::fabs(mn.x), std::fabs(mx.x)),
              1e-6f + 1e-5f * std::max(std::fabs(mn.y), std::fabs(mx.y)),
              1e-6f + 1e-5f * std::max(std::fabs(mn.z), std::fabs(mx.z))};
    fmin[i] = {mn.x - pad.x, mn.y - pad.y, mn.z - pad.z};
    fmax[i] = {mx.x + pad.x, mx.y + pad.y, mx.z + pad.z};
    cx[i] = (fmin[i].x + fmax[i].x) * 0.5f;
    cy[i] = (fmin[i].y + fmax[i].y) * 0.5f;
    cz[i] = (fmin[i].z + fmax[i].z) * 0.5f;
  }

  Builder b{fmin.data(), fmax.data(), cx.data(), cy.data(), cz.data(),
            std::max<int64_t>(1, max_faces), sah_limit, skip_cmp};
  b.pool.reserve((size_t)(2 * n_faces));
  std::vector<int64_t> all(n_faces);
  for (int64_t i = 0; i < n_faces; i++) all[i] = i;
  int32_t root = b.make_node(all);

  int64_t total = b.pool[root].esize;
  out->n_nodes = total;
  out->n_faces = n_faces;
  out->bb_min = (float*)malloc(sizeof(float) * 3 * total);
  out->bb_max = (float*)malloc(sizeof(float) * 3 * total);
  out->leaf_first = (int32_t*)malloc(sizeof(int32_t) * total);
  out->leaf_count = (int32_t*)malloc(sizeof(int32_t) * total);
  out->exit_idx = (int32_t*)malloc(sizeof(int32_t) * total);
  out->leaf_order = (int64_t*)malloc(sizeof(int64_t) * n_faces);

  // Preorder DFS with escape indices (matches accel/bvh.py: stack of
  // (node, escape, elide), left pushed last so it pops first). An elided
  // node emits no record — its children take its place.
  struct Item {
    int32_t ni;
    int32_t escape;
    bool elide;
  };
  std::vector<Item> stack;
  stack.push_back({root, (int32_t)total, false});
  int64_t i = 0, fpos = 0;
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    Node& nd = b.pool[it.ni];
    if (!it.elide) {
      out->bb_min[3 * i] = nd.bb_min.x;
      out->bb_min[3 * i + 1] = nd.bb_min.y;
      out->bb_min[3 * i + 2] = nd.bb_min.z;
      out->bb_max[3 * i] = nd.bb_max.x;
      out->bb_max[3 * i + 1] = nd.bb_max.y;
      out->bb_max[3 * i + 2] = nd.bb_max.z;
      out->exit_idx[i] = it.escape;
      if (nd.left < 0) {
        out->leaf_first[i] = (int32_t)fpos;
        out->leaf_count[i] = (int32_t)nd.faces.size();
        for (int64_t f : nd.faces) out->leaf_order[fpos++] = f;
        i++;
        continue;
      }
      out->leaf_first[i] = -1;
      out->leaf_count[i] = 0;
      i++;
    }
    Node& lc = b.pool[nd.left];
    int32_t right_start = (int32_t)(i + lc.esize - (lc.skip ? 1 : 0));
    stack.push_back({nd.right, it.escape, false});
    stack.push_back({nd.left, right_start, lc.skip});
  }
  return 0;
}

void pbr_free_bvh(PbrBvhResult* r) {
  free(r->bb_min);
  free(r->bb_max);
  free(r->leaf_first);
  free(r->leaf_count);
  free(r->exit_idx);
  free(r->leaf_order);
  std::memset(r, 0, sizeof(*r));
}

}  // extern "C"
