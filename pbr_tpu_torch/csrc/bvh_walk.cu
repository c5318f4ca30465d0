// Per-ray BVH walk for Hopper (sm_90a): kernel K8, nearest and any-hit.
//
// The H100 form of the JAX package's 'bvh' mode, which is no Pallas kernel
// but an XLA while_loop: pbr_tpu/ops/traverse.py::intersect_bvh (its body
// at :276, the NumPy step ::_bvh_step :85), and the reference renderer's
// own GPU design (pt_bvh.cl:82-123). walk_kernel<false> computes what it
// computes: for each ray, the stackless walk of bvh.cuh with the ray's own
// node cursor, i + 1 on a hit of node i (box, t_far > EPSILON5, the
// empty-box guard, t_best > t_near) and exit[i] on a miss; at a hit leaf
// its min(leaf_count, max_leaf) faces (leaf_count is the loop bound, not
// an unrolled max_leaf) with the classic Moller-Trumbore of mt.cuh, strict
// '<' in ascending face order. With counters it also writes the exact
// per-ray counts of traverse.py:302-314: visits, one per node step, and
// tests, min(leaf_count, max_leaf) per leaf the ray hits (the reference's
// two debug channels, pt_bvh.cl:89 and :23). A dead lane walks nothing and
// returns t = +inf, face -1 and zero counts.
//
// walk_kernel<true> is the 'bvh' mode's NEE shadow leg, the bit t_sh <
// t_light of pbr_tpu/models/integrator.py:352-353: the same walk with the
// gate t_limit > t_near (as K6's any-hit instance, bvh_packet.cu), ended at
// the first valid face with t < t_limit; it writes one bool a ray and, on
// request, the counters of the walk it ran: its node steps, and its face
// tests up to and including the occluding face.
//
// What bounds it on this card: per ray it reads 24-29 B and writes 1-16 B,
// and does ~25 float32 operations a node step and ~51 a face test over
// hundreds of steps: operations, with the node and face reads gathered per
// lane through the read-only cache (the tables, 145 KB of nodes and 4.8 MB
// of faces on soup:100000, stay in the 50 MB L2). What the design does
// about it (PERF.md's K8 design table has the steps that led here, and
// the two that lost: persistent warps and warp-wide leaf tests):
//   - packed records (ops/cuda_bvh.py::node_records, face_records): a node
//     is two 16-byte loads, {bmin, exit} and {bmax, leaf}, a face three,
//     {v0}, {e1}, {e2}; the same floats, so the same operations;
//   - a while-while loop (Aila and Laine, HPG 2009): a lane steps through
//     inner nodes until it stands at a hit leaf or has ended, then the
//     warp's lanes that stand at leaves test them together. No speculative
//     steps: each ray keeps its own order of nodes and faces, so its t,
//     face and counters are those of the walk above;
//   - the wrapper sorts the rays by (octant, Morton code of the origin),
//     so neighbouring lanes walk similar paths and diverge less.
//
// Numerics as K1-K4 (--fmad=false, IEEE division): bitwise equal to the
// plain version, ops/cuda_bvh.py::walk_plain.

#include <cuda_runtime.h>
#include <math.h>

#include "bvh.cuh"
#include "mt.cuh"

namespace {

constexpr int kThreads = 256;
// A leaf's record word: first face << kCountBits | (face count - 1); -1 for
// an inner node (ops/cuda_bvh.py::node_records).
constexpr int kCountBits = 8;

struct Params {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* order;            // (n,) launch order (null: identity)
  const unsigned char* alive;  // (n,) bool (null: all live)
  int n;
  const float4* nodes;  // (n_nodes, 2) node records
  int n_nodes;
  const float4* faces;  // (F, 3) face records
  int max_leaf;
  const float* t_limit;  // (n,) any-hit only
  float* t_out;          // nearest only
  int* f_out;
  unsigned char* occ_out;  // any-hit only
  int* tests_out;          // (n,) or null: no counters
  int* visits_out;
};

struct Node {
  float x0, y0, z0, x1, y1, z1;
  int exit, first, count;  // first -1: an inner node
};

__device__ __forceinline__ Node load_node(const float4* nodes, int i) {
  const float4 a = __ldg(nodes + 2 * i), b = __ldg(nodes + 2 * i + 1);
  const int leaf = __float_as_int(b.w);
  return Node{a.x, a.y, a.z, b.x, b.y, b.z, __float_as_int(a.w),
              leaf >= 0 ? leaf >> kCountBits : -1, (leaf & ((1 << kCountBits) - 1)) + 1};
}

__device__ __forceinline__ pbr::Face load_face(const float4* faces, int f) {
  const float4 a = __ldg(faces + 3 * f), b = __ldg(faces + 3 * f + 1),
               c = __ldg(faces + 3 * f + 2);
  return pbr::Face{a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kThreads) walk_kernel(const Params p) {
  // Ray g of the launch order; no ray (-1) past n, in the last block. The
  // kernel has no early return, so a copy can read each warp's clock at
  // its end (tools/k8_walk.py).
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int ray = g >= p.n ? -1 : p.order != nullptr ? p.order[g] : g;
  const bool live = ray >= 0 && (p.alive == nullptr || p.alive[ray] != 0);
  float t_best = INFINITY;
  int f_best = -1;
  int tests = 0, visits = 0;
  bool occluded = false;
  pbr::Ray r{};
  float t_limit = 0.0f;
  if (live) {
    r = pbr::make_ray(p.ox[ray], p.oy[ray], p.oz[ray], p.dx[ray], p.dy[ray], p.dz[ray]);
    if (ANY_HIT) t_limit = p.t_limit[ray];
  }
  int i = live ? 0 : p.n_nodes;
  while (i < p.n_nodes) {
    // Node steps up to the next hit leaf, or to the end of the walk.
    int first = -1, count = 0;
    while (i < p.n_nodes) {
      ++visits;
      const Node nd = load_node(p.nodes, i);
      float t_near;
      const bool hit = pbr::box_hit(nd.x0, nd.y0, nd.z0, nd.x1, nd.y1, nd.z1, r, &t_near) &&
                       (ANY_HIT ? t_limit : t_best) > t_near;
      if (hit && nd.first >= 0) {
        first = nd.first;
        count = nd.count;
        break;
      }
      i = hit ? i + 1 : nd.exit;
    }
    if (first < 0) break;  // the walk has ended
    // The leaf's faces. A face counts below the gate tm (nearest: t_best,
    // then the least t so far; any-hit: t_limit); the first face of the
    // least t wins, and any-hit stops at the first that counts.
    const int cnt = min(count, p.max_leaf);
    float tm = ANY_HIT ? t_limit : t_best;
    int km = -1;
    for (int k = 0; k < cnt; ++k) {
      float t;
      if (pbr::moller_trumbore(load_face(p.faces, first + k), r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                               &t) &&
          t < tm) {
        km = k;
        if (ANY_HIT) break;
        tm = t;
      }
    }
    tests += (ANY_HIT && km >= 0) ? km + 1 : cnt;
    if (km >= 0) {
      if (ANY_HIT) {
        occluded = true;
        break;
      }
      t_best = tm;
      f_best = first + km;
    }
    ++i;
  }
  if (ray >= 0) {
    if (ANY_HIT) {
      p.occ_out[ray] = occluded;
    } else {
      p.t_out[ray] = t_best;
      p.f_out[ray] = f_best;
    }
    if (p.tests_out != nullptr) {
      p.tests_out[ray] = tests;
      p.visits_out[ray] = visits;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_bvh.py). Pointers are device
// pointers; nodes and face_records are the (n_nodes, 8) and (F, 12) float32
// records. t_limit null: the nearest walk into t_out and f_out; set: the
// any-hit walk into occ_out. tests and visits are both null (no counters)
// or both set. Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments it
// does not take).
extern "C" int pbr_bvh_walk(const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const int* order, const unsigned char* alive, int n,
                            const float* nodes, int n_nodes, const float* face_records,
                            int max_leaf, const float* t_limit, float* t_out, int* f_out,
                            unsigned char* occ_out, int* tests, int* visits, void* stream) {
  const bool any_hit = t_limit != nullptr;
  if (max_leaf < 1 || (tests == nullptr) != (visits == nullptr) ||
      (any_hit ? occ_out == nullptr : (t_out == nullptr || f_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Params p{ox,      oy,      oz,
                 dx,      dy,      dz,
                 order,   alive,   n,
                 reinterpret_cast<const float4*>(nodes),
                 n_nodes, reinterpret_cast<const float4*>(face_records),
                 max_leaf, t_limit, t_out,
                 f_out,   occ_out, tests,
                 visits};
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    walk_kernel<true><<<blocks, kThreads, 0, s>>>(p);
  } else {
    walk_kernel<false><<<blocks, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
