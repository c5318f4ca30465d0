// The node step shared by the tree walks K6, K7 (bvh_packet.cu) and K8
// (bvh_walk.cu): a stackless linear BVH on the device and the slab test of
// one ray against one node's box.
//
// The tree (scene/device.py::BVHTables; pbr_tpu/scene/types.py::LinearBVH):
// nodes in preorder; a hit of node i goes on to i + 1, a miss to exit[i];
// a leaf (leaf_first >= 0) holds faces leaf_first .. leaf_first +
// leaf_count - 1 of the face table; the walk ends at n.
//
// The slab test is pbr_tpu/ops/intersect.py::slab_box, NaN-conservative: a
// ray in a slab plane with a zero direction component gives 0 * inf = NaN,
// and a NaN bound means "no constraint from this slab". fminf/fmaxf drop a
// NaN operand where NumPy, XLA and torch propagate it (and the reference
// then turns it into the unconstrained bound), so the NaN is tested
// explicitly; between two numbers fminf/fmaxf are the exact minimum and
// maximum. The gates are the reference's: t_near <= t_far and t_far >
// EPSILON5 (pt_bvh.cl:107-110), and the empty-box guard bb_min.x <=
// bb_max.x of pallas_bvh.py:110-116, which turns the forest's inverted
// padding boxes into misses. Every node the builders make bounds at least
// one face, so there the guard never fires. The caller adds the t_best (or
// t_limit) gate against t_near.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pbr {

constexpr float kBoxEps5 = 1.0e-5f;

// A ray with its reciprocal direction (1 / d, IEEE-rounded).
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
}

__device__ __forceinline__ float slab_lo(float a, float b) {
  return (a != a || b != b) ? -INFINITY : fminf(a, b);
}

__device__ __forceinline__ float slab_hi(float a, float b) {
  return (a != a || b != b) ? INFINITY : fmaxf(a, b);
}

// The box (x0, y0, z0)-(x1, y1, z1) against ray r: true on a hit (without
// the caller's gate); t_near is the entry distance the caller gates.
__device__ __forceinline__ bool box_hit(float x0, float y0, float z0, float x1, float y1,
                                        float z1, const Ray& r, float* t_near) {
  const float ax = (x0 - r.ox) * r.ix, bx = (x1 - r.ox) * r.ix;
  const float ay = (y0 - r.oy) * r.iy, by = (y1 - r.oy) * r.iy;
  const float az = (z0 - r.oz) * r.iz, bz = (z1 - r.oz) * r.iz;
  const float lo = fmaxf(fmaxf(slab_lo(ax, bx), slab_lo(ay, by)), slab_lo(az, bz));
  const float hi = fminf(fminf(slab_hi(ax, bx), slab_hi(ay, by)), slab_hi(az, bz));
  *t_near = lo;
  return (lo <= hi) && (hi > kBoxEps5) && (x0 <= x1);
}

}  // namespace pbr
