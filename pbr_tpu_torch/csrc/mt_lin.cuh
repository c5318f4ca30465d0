// Linear-form Moller-Trumbore, the per-face test shared by kernel K2
// (brute_intersect.cu, LIN instances), kernel K3 (gated_intersect.cu) and
// kernels K5 and K5m (row_sweep.cu).
//
// Ports pbr_tpu/ops/pallas_gated.py::_mt_lin_update, which is term for
// term the face loop of pbr_tpu/ops/pallas_intersect.py::_sweep_lin and
// pbr_tpu/ops/pallas_sweep.py::_section. Each
// MT quantity is a scalar triple product, (bi)linear in the ray, so with
// per-face constants hoisted into a 16-float table (_lin_table: m = e2 x e1,
// km = v0 . m, w = e2 x v0, q = v0 x e1, e1, e2) and one c = o x d per ray:
//   det = d . m          t = (km - o . m) / det
//   u = (e2 . c - d . w) / det      v = (-(e1 . c) - d . q) / det
// (the divisions are multiplications by inv = 1 / det). The operation
// order below is the reference's and the plain torch version's
// (ops/cuda_intersect.py::mt_lin); built with --fmad=false, each
// operation rounds as theirs does.

#pragma once

#include <cuda_runtime.h>

namespace pbr {

constexpr int kLinRows = 16;
constexpr float kLinEps5 = 1.0e-5f;

struct LinFace {
  float m0, m1, m2, km, w0, w1, w2, q0, q1, q2, e1x, e1y, e1z, e2x, e2y, e2z;
};

// c = o x d, once per ray.
__device__ __forceinline__ void cross_od(float ox, float oy, float oz, float dx, float dy,
                                         float dz, float* cx, float* cy, float* cz) {
  *cx = oy * dz - oz * dy;
  *cy = oz * dx - ox * dz;
  *cz = ox * dy - oy * dx;
}

// The face test in parts, which a caller may gate on t before it computes
// u and v: lin_det and lin_tnum return det and t's numerator, t = tnum *
// (1 / det); lin_uv tells whether u >= 0, v >= 0 and u + v <= 1.
__device__ __forceinline__ float lin_det(const LinFace& f, float dx, float dy, float dz) {
  return dx * f.m0 + dy * f.m1 + dz * f.m2;
}

__device__ __forceinline__ float lin_tnum(const LinFace& f, float ox, float oy, float oz) {
  return f.km - (ox * f.m0 + oy * f.m1 + oz * f.m2);
}

__device__ __forceinline__ bool lin_uv(const LinFace& f, float dx, float dy, float dz, float cx,
                                       float cy, float cz, float inv) {
  const float u = ((f.e2x * cx + f.e2y * cy + f.e2z * cz) - (dx * f.w0 + dy * f.w1 + dz * f.w2)) * inv;
  const float v = (-(f.e1x * cx + f.e1y * cy + f.e1z * cz) - (dx * f.q0 + dy * f.q1 + dz * f.q2)) * inv;
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
}

__device__ __forceinline__ bool mt_lin(const LinFace& f, float ox, float oy, float oz,
                                       float dx, float dy, float dz, float cx, float cy,
                                       float cz, float* t_out) {
  const float inv = 1.0f / lin_det(f, dx, dy, dz);
  const float t = lin_tnum(f, ox, oy, oz) * inv;
  const bool uv = lin_uv(f, dx, dy, dz, cx, cy, cz, inv);
  *t_out = t;
  return (t >= kLinEps5) && uv;
}

}  // namespace pbr
