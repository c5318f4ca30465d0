// Per-ray Phong BVH walk for Hopper (sm_90a): kernel K9.
//
// The H100 form of the JAX package's Phong walk, which is no Pallas kernel
// but an XLA while_loop: pbr_tpu/ops/phongtess.py::intersect_bvh_phongtess
// (the loop at :458 over the step at :414-452). For each ray, the
// stackless walk of bvh.cuh over a tree built on the curved-patch-inflated
// face bounds, with the ray's own node cursor: i + 1 on a hit of node i
// (slab test, t_far > EPSILON5, the empty-box guard, t_best > t_near) and
// exit[i] on a miss; at a hit leaf its min(leaf_count, max_leaf) faces in
// ascending order, each by phong.cuh's phong_face_hit (Moller-Trumbore for
// a flat face, the patch test bounded by the running best for a curved
// one, t >= EPSILON5), kept on a strict '<' against the running best. A
// dead lane walks nothing and returns t = +inf, face -1, u = v = 0.
//
// What bounds it on this card: operations. A ray reads 25 B and writes
// 16 B; a node step is ~25 float32 operations, a flat face test 51, a
// curved one several hundred with a square root, two divisions and, on the
// cubic's three-root branch, an acosf, a powf and three cosf. What the
// design does about it:
//   - K8's while-while loop (Aila and Laine, HPG 2009): a lane steps
//     through inner nodes until it stands at a hit leaf or has ended, then
//     the warp's lanes at leaves test them together;
//   - the wrapper sorts the rays by (octant, Morton code of the origin), as
//     K8's does, so neighbouring lanes walk similar paths;
//   - the ray's two planes and dominant axis are computed once a ray, not
//     once a face; each solve evaluates the branch it takes, not all three;
//   - a face is five 16-byte loads through the read-only cache (the Phong
//     scenes' tables stay in the 50 MB L2).
//
// Numerics as K1-K8 (--fmad=false, IEEE division and sqrt): bitwise equal
// to the plain version, ops/phongtess.py::intersect_bvh_phongtess (which
// tests a leaf's faces against the best t at the leaf's start: a root
// beyond the running best cannot win either way).

#include <cuda_runtime.h>
#include <math.h>

#include "bvh.cuh"
#include "phong.cuh"

namespace {

constexpr int kThreads = 128;
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
  const float4* faces;  // (F, 5) Phong face records
  int max_leaf;
  float alpha, oma;  // float32(alpha), float32(1 - alpha)
  float *t_out, *u_out, *v_out;
  int* f_out;
};

__device__ __forceinline__ pbr::PhongFace load_face(const float4* faces, int f) {
  const float4* rec = faces + pbr::kPhongWords * f;
  return pbr::phong_face(__ldg(rec), __ldg(rec + 1), __ldg(rec + 2), __ldg(rec + 3),
                         __ldg(rec + 4));
}

__global__ void __launch_bounds__(kThreads) phong_walk_kernel(const Params p) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int ray = g >= p.n ? -1 : p.order != nullptr ? p.order[g] : g;
  const bool live = ray >= 0 && (p.alive == nullptr || p.alive[ray] != 0);
  float t_best = INFINITY, u_best = 0.0f, v_best = 0.0f;
  int f_best = -1;
  pbr::Ray r{};
  pbr::PhongRay pr{};
  if (live) {
    r = pbr::make_ray(p.ox[ray], p.oy[ray], p.oz[ray], p.dx[ray], p.dy[ray], p.dz[ray]);
    pr = pbr::phong_ray(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  }
  int i = live ? 0 : p.n_nodes;
  while (i < p.n_nodes) {
    // Node steps up to the next hit leaf, or to the end of the walk.
    int first = -1, count = 0;
    while (i < p.n_nodes) {
      const float4 a = __ldg(p.nodes + 2 * i), b = __ldg(p.nodes + 2 * i + 1);
      float t_near;
      const bool hit = pbr::box_hit(a.x, a.y, a.z, b.x, b.y, b.z, r, &t_near) &&
                       t_best > t_near;
      const int leaf = __float_as_int(b.w);
      if (hit && leaf >= 0) {
        first = leaf >> kCountBits;
        count = (leaf & ((1 << kCountBits) - 1)) + 1;
        break;
      }
      i = hit ? i + 1 : __float_as_int(a.w);
    }
    if (first < 0) break;  // the walk has ended
    const int cnt = min(count, p.max_leaf);
    for (int k = 0; k < cnt; ++k) {
      const pbr::PatchHit h =
          pbr::phong_face_hit(load_face(p.faces, first + k), pr, p.alpha, p.oma, t_best);
      if (h.t < t_best) {
        t_best = h.t;
        f_best = first + k;
        u_best = h.u;
        v_best = h.v;
      }
    }
    ++i;
  }
  if (ray >= 0) {
    p.t_out[ray] = t_best;
    p.f_out[ray] = f_best;
    p.u_out[ray] = u_best;
    p.v_out[ray] = v_best;
  }
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_phong.py). Pointers are device
// pointers; nodes and faces are the (n_nodes, 8) node records and the
// (F, 20) Phong face records. Launches on `stream` without synchronising
// and returns cudaGetLastError() of the launch (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int pbr_phong_walk(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const int* order, const unsigned char* alive, int n,
                              const float* nodes, int n_nodes, const float* faces, int max_leaf,
                              float alpha, float one_minus_alpha, float* t_out, int* f_out,
                              float* u_out, float* v_out, void* stream) {
  if (max_leaf < 1 || n < 0 || t_out == nullptr || f_out == nullptr || u_out == nullptr ||
      v_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Params p{ox,      oy,      oz, dx, dy, dz, order, alive, n,
           reinterpret_cast<const float4*>(nodes), n_nodes,
           reinterpret_cast<const float4*>(faces), max_leaf, alpha, one_minus_alpha,
           t_out,   u_out,   v_out, f_out};
  const int blocks = (n + kThreads - 1) / kThreads;
  phong_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
