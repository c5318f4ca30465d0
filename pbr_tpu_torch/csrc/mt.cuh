// Classic Moller-Trumbore, the per-face test shared by kernel K1
// (brute_intersect.cu: mt_t and mt_uv) and the tree walks K6, K7
// (bvh_packet.cu) and K8 (bvh_walk.cu: moller_trumbore).
//
// The operation order is the one of pbr_tpu/ops/intersect.py::
// moller_trumbore and of the plain torch versions
// (ops/intersect.py::moller_trumbore); built with --fmad=false and the
// default IEEE division, each operation rounds as theirs does, so the
// kernels and their plain versions agree bitwise. A face is valid when
// t >= EPSILON5, u >= 0, v >= 0 and u + v <= 1.

#pragma once

#include <cuda_runtime.h>

namespace pbr {

constexpr float kMtEps5 = 1.0e-5f;

struct Face {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ bool moller_trumbore(const Face& f, float ox, float oy, float oz,
                                                float dx, float dy, float dz, float* t_out) {
  const float px = dy * f.e2z - dz * f.e2y;
  const float py = dz * f.e2x - dx * f.e2z;
  const float pz = dx * f.e2y - dy * f.e2x;
  const float det = f.e1x * px + f.e1y * py + f.e1z * pz;
  const float inv_det = 1.0f / det;
  const float tx = ox - f.v0x;
  const float ty = oy - f.v0y;
  const float tz = oz - f.v0z;
  const float qx = ty * f.e1z - tz * f.e1y;
  const float qy = tz * f.e1x - tx * f.e1z;
  const float qz = tx * f.e1y - ty * f.e1x;
  const float t = (f.e2x * qx + f.e2y * qy + f.e2z * qz) * inv_det;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  *t_out = t;
  return (t >= kMtEps5) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
}

// The same test in parts, which a caller may gate on t before it computes
// u and v: mt_t gives det, t's numerator and what u and v reuse (t = tnum
// * (1 / det)); mt_uv tells whether u >= 0, v >= 0 and u + v <= 1. Each
// operation is moller_trumbore's, in its order.
struct MtParts {
  float px, py, pz, det, tx, ty, tz, qx, qy, qz, tnum;
};

__device__ __forceinline__ MtParts mt_t(const Face& f, float ox, float oy, float oz, float dx,
                                        float dy, float dz) {
  MtParts m;
  m.px = dy * f.e2z - dz * f.e2y;
  m.py = dz * f.e2x - dx * f.e2z;
  m.pz = dx * f.e2y - dy * f.e2x;
  m.det = f.e1x * m.px + f.e1y * m.py + f.e1z * m.pz;
  m.tx = ox - f.v0x;
  m.ty = oy - f.v0y;
  m.tz = oz - f.v0z;
  m.qx = m.ty * f.e1z - m.tz * f.e1y;
  m.qy = m.tz * f.e1x - m.tx * f.e1z;
  m.qz = m.tx * f.e1y - m.ty * f.e1x;
  m.tnum = f.e2x * m.qx + f.e2y * m.qy + f.e2z * m.qz;
  return m;
}

__device__ __forceinline__ bool mt_uv(const MtParts& m, float dx, float dy, float dz, float inv) {
  const float u = (m.tx * m.px + m.ty * m.py + m.tz * m.pz) * inv;
  const float v = (dx * m.qx + dy * m.qy + dz * m.qz) * inv;
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
}

}  // namespace pbr
