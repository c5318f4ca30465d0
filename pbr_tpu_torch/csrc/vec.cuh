// 3-vector math of ops/vec.py and ops/intersect.py as device functions, for
// the shading kernels K11 and K12 (shade.cu).
//
// Each function keeps the plain version's operation order, so that a kernel
// built with --fmad=false and IEEE division and sqrtf rounds every step as
// torch's elementwise ops do: dot sums x, y, z in that order, normalized is
// v * (1 / sqrt(len2)), and the NaN rules are torch's (torch.maximum,
// torch.minimum and clamp_min return a NaN operand; CUDA's fmaxf and fminf
// drop it).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pbr {
namespace shade {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 adds(V3 a, float s) { return V3{a.x + s, a.y + s, a.z + s}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 rsubs(float s, V3 a) { return V3{s - a.x, s - a.y, s - a.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 yzx(V3 a) { return V3{a.y, a.z, a.x}; }

__device__ __forceinline__ V3 where3(bool m, V3 a, V3 b) { return m ? a : b; }

// torch's elementwise rules.
__device__ __forceinline__ float tmax(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {  // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min0(float v) {  // clamp_min(v, 0)
  return v != v ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float max_component(V3 a) { return tmax(tmax(a.x, a.y), a.z); }

// Vec3.normalized: v * (1 / sqrt(v . v)).
__device__ __forceinline__ V3 normalized(V3 v) { return scale(v, 1.0f / sqrtf(dot(v, v))); }

// safe_normalized: the zero vector where v . v <= 1e-20.
__device__ __forceinline__ V3 safe_normalized(V3 v) {
  const float l2 = dot(v, v);
  const float inv = l2 > 1.0e-20f ? 1.0f / sqrtf(l2) : 0.0f;
  return scale(v, inv);
}

__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

__device__ __forceinline__ float safe_pow(float x, float e) { return x > 0.0f ? powf(x, e) : 0.0f; }

// safe_div(num, den): 0 where |den| <= 1e-12.
__device__ __forceinline__ float safe_div(float num, float den) {
  return fabsf(den) > 1.0e-12f ? num / den : 0.0f;
}

// brdf.py::_guarded_div: 0 where zero_if.
__device__ __forceinline__ float guarded_div(float num, float den, bool zero_if) {
  return zero_if ? 0.0f : num / den;
}

constexpr float kPi = 3.14159274f;          // float32(pi)
constexpr float kTwoPi = 6.28318548f;       // float32(2 pi)
constexpr float kHalfPi = 1.57079637f;      // float32(pi / 2)
constexpr float kInvPi = 0.318309873f;      // float32(1 / pi)

// safe_arccos: arccos inside (-1, 1), 0 at x >= 1, pi below -1 (and NaN).
__device__ __forceinline__ float safe_arccos(float x) {
  const bool inside = fabsf(x) < 1.0f;
  const float core = acosf(inside ? x : 0.0f);
  const float ends = x >= 1.0f ? 0.0f : kPi;
  return inside ? core : ends;
}

// reflect(d, n) = d - n * (2 (n . d)).
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return sub(d, scale(n, 2.0f * dot(n, d))); }

// orthonormal(n) and jitter(nl, phi, sina, cosa) (pt_utils.cl:306-318).
__device__ __forceinline__ V3 jitter(V3 nl, float phi, float sina, float cosa) {
  const V3 u = safe_normalized(cross(yzx(nl), nl));
  const V3 v = safe_normalized(cross(nl, u));
  const V3 azim = normalized(add(scale(u, cosf(phi)), scale(v, sinf(phi))));
  return normalized(add(scale(azim, sina), scale(nl, cosa)));
}

// intersect.py::sphere's hit bit (intersectSphere, pt_intersect.cl:37-77);
// r_sq plays the reference's radius-squared role.
__device__ __forceinline__ bool sphere_hit(V3 o, V3 d, V3 center, float r_sq) {
  const V3 L = sub(center, o);
  const float tca = dot(L, d);
  const float d2 = dot(L, L) - tca * tca;
  const float thc = sqrtf(clamp_min0(r_sq - d2));
  const float t0 = tca - thc;
  const float t1 = tca + thc;
  const float t_near = t0 < 0.0f ? t1 : t0;
  return (tca >= 0.0f) && (d2 <= r_sq) && (t_near >= 0.0f);
}

}  // namespace shade
}  // namespace pbr
