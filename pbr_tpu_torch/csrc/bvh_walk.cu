// Per-ray BVH walk for Hopper (sm_90a): kernel K8.
//
// The H100 form of the JAX package's 'bvh' mode, which is no Pallas kernel
// but an XLA while_loop: pbr_tpu/ops/traverse.py::intersect_bvh (its body
// at :276, the NumPy step ::_bvh_step :85), and the reference renderer's
// own GPU design (pt_bvh.cl:82-123). walk_kernel computes what it
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
// What bounds it on this card: per ray it reads 24 B and writes 8-16 B,
// and does ~25 float32 operations a node step and ~51 a face test over
// hundreds of steps: operations, with the node and face reads gathered
// per lane through the read-only cache (the tables, 163 KB of nodes and
// 3.6 MB of faces on soup:100000, stay in the 50 MB L2). One thread per
// ray, its state in registers; the wrapper sorts the rays by (octant,
// Morton code of the origin), so neighbouring lanes walk similar paths and
// diverge less.
//
// Numerics as K1-K4 (--fmad=false, IEEE division): bitwise equal to the
// plain version, ops/cuda_bvh.py::walk_plain.

#include <cuda_runtime.h>
#include <math.h>

#include "bvh.cuh"
#include "mt.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* order;            // (n,) launch order (null: identity)
  const unsigned char* alive;  // (n,) bool (null: all live)
  int n;
  pbr::Tree tree;
  const float* faces;  // (9, stride) table
  int stride;
  int max_leaf;
  float* t_out;
  int* f_out;
  int* tests_out;   // (n,) or null: no counters
  int* visits_out;
};

__global__ void __launch_bounds__(kThreads) walk_kernel(const Params p) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= p.n) return;
  const int ray = p.order != nullptr ? p.order[g] : g;
  float t_best = INFINITY;
  int f_best = -1;
  int tests = 0, visits = 0;
  if (p.alive == nullptr || p.alive[ray] != 0) {
    const pbr::Ray r = pbr::make_ray(p.ox[ray], p.oy[ray], p.oz[ray], p.dx[ray], p.dy[ray],
                                     p.dz[ray]);
    int i = 0;
    while (i < p.tree.n) {
      ++visits;
      float t_near;
      const bool hit = pbr::box_hit(p.tree, i, r, &t_near) && t_best > t_near;
      if (hit) {
        const int lf = __ldg(p.tree.leaf_first + i);
        if (lf >= 0) {
          const int cnt = min(__ldg(p.tree.leaf_count + i), p.max_leaf);
          tests += cnt;
          for (int k = 0; k < cnt; ++k) {
            float t;
            const bool valid = pbr::moller_trumbore(pbr::load_face(p.faces, p.stride, lf + k),
                                                    r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &t);
            if (valid && t < t_best) {
              t_best = t;
              f_best = lf + k;
            }
          }
        }
      }
      i = hit ? i + 1 : __ldg(p.tree.exit + i);
    }
  }
  p.t_out[ray] = t_best;
  p.f_out[ray] = f_best;
  if (p.tests_out != nullptr) {
    p.tests_out[ray] = tests;
    p.visits_out[ray] = visits;
  }
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_bvh.py). Pointers are device
// pointers; tests and visits are both null (no counters) or both set.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments it
// does not take).
extern "C" int pbr_bvh_walk(const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const int* order, const unsigned char* alive, int n,
                            const float* bmin, const float* bmax, const int* leaf_first,
                            const int* leaf_count, const int* exit_, int n_nodes,
                            const float* faces, int stride, int max_leaf, float* t_out,
                            int* f_out, int* tests, int* visits, void* stream) {
  if (max_leaf < 1 || (tests == nullptr) != (visits == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Params p{ox,    oy,     oz,       dx,    dy,    dz,
                 order, alive,  n,        {bmin, bmax, leaf_first, leaf_count, exit_, n_nodes},
                 faces, stride, max_leaf, t_out, f_out, tests, visits};
  const dim3 grid((n + kThreads - 1) / kThreads);
  walk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
