// The BRDF library of ops/brdf.py as device functions, for the shading
// kernels K12 (shade.cu) and K12 bwd (shade_bwd.cu): Schlick and
// Shirley-Ashikhmin eval and sample, Fresnel and refraction, the shade's
// colour helpers and the Phong shading normal.
//
// Op for op the plain version's: the same guards, the same operation order
// (left to right, as the Python expressions evaluate), and the library
// functions that torch's CUDA kernels call for its ops (sinf, cosf, tanf,
// atanf, acosf, powf, sqrtf, floorf; each bitwise torch's on the H100 when
// built with --fmad=false). Where the plain version evaluates two branches
// and selects, these evaluate the branch they select: the value is the same.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "vec.cuh"

namespace pbr {
namespace shade {

constexpr float kNiAir = 1.00028f;           // float32(NI_AIR)
constexpr float kSaPd = 0.387507677f;        // float32(28 / (23 pi)), pt_brdf.cl:256

// fresnel(u, c) = c + (1 - c) (1 - u)^5, per channel for a V3 c.
__device__ __forceinline__ float fresnel(float u, float c) {
  const float v = 1.0f - u;
  const float v5 = v * v * v * v * v;
  return c + (1.0f - c) * v5;
}
__device__ __forceinline__ V3 fresnel3(float u, V3 c) {
  return V3{fresnel(u, c.x), fresnel(u, c.y), fresnel(u, c.z)};
}

// ---------------------------------------------------------------- Schlick --

__device__ __forceinline__ float schlick_Z(float t, float r) {
  const float x = 1.0f + r * t * t - t * t;
  return guarded_div(r, x * x, x == 0.0f);
}

__device__ __forceinline__ float schlick_A(float w, float p) {
  const float p2 = p * p;
  const float w2 = w * w;
  const float x = p2 - p2 * w2 + w2;
  return safe_sqrt(guarded_div(p, x, x == 0.0f));
}

__device__ __forceinline__ float schlick_G(float v, float r) {
  const float x = r - r * v + v;
  return guarded_div(v, x, x == 0.0f);
}

__device__ __forceinline__ float schlick_D(float t, float v_out, float v_in, float w, float r,
                                           float p) {
  const float b = 4.0f * r * (1.0f - r);
  const bool r_lt = r < 0.5f;
  const float a = r_lt ? 0.0f : 1.0f - b;
  const float c = r_lt ? 1.0f - b : 0.0f;
  const float d = 4.0f * kPi * v_out * v_in;  // 4 * pi is exact: one rounding a product
  const float gp = schlick_G(v_out, r) * schlick_G(v_in, r);
  const float b2 = gp * schlick_Z(t, r) * schlick_A(w, p) + (1.0f - gp);
  const float lam = a * kInvPi;
  const float ani = guarded_div(b, d, (b == 0.0f) || (d == 0.0f)) * b2;
  const float fres = guarded_div(c, v_in, v_in == 0.0f);
  return lam + ani + fres;
}

struct SchlickEval {
  float brdf, u, pdf;
};

// schlick_eval (pt_brdf.cl:125-149).
__device__ __forceinline__ SchlickEval schlick_eval(V3 normal, V3 d_out, V3 d_in, float rough,
                                                    float p) {
  const V3 v_out_dir = neg(d_out);
  const V3 un = safe_normalized(cross(yzx(normal), normal));
  const V3 h = safe_normalized(add(v_out_dir, d_in));
  const float t = dot(h, normal);
  const float v_in = dot(d_in, normal);
  const float v_out = dot(v_out_dir, normal);
  const V3 hp = safe_normalized(cross(cross(h, normal), normal));
  const float w = dot(un, hp);
  const float u = dot(h, v_out_dir);
  const float pdf = safe_div(t, 4.0f * kPi * dot(h, v_out_dir));
  return SchlickEval{schlick_D(t, v_out, v_in, w, rough, p), u, pdf};
}

// _quadrant_phi (pt_brdf.cl:172-194).
__device__ __forceinline__ float quadrant_phi(float b, float iso2) {
  const float quad = floorf(b * 4.0f);
  const float b_loc = 1.0f - 4.0f * ((quad + 1.0f) * 0.25f - b);
  const float b2 = b_loc * b_loc;
  const float den = 1.0f - b2 + b2 * iso2;
  const float phi_base = kHalfPi * safe_sqrt(guarded_div(iso2 * b2, den, den == 0.0f));
  if (quad == 0.0f) return phi_base;
  if (quad == 1.0f) return kPi - phi_base;
  if (quad == 2.0f) return kPi + phi_base;
  return kTwoPi - phi_base;
}

// schlick_sample (newRaySchlick, pt_brdf.cl:159-208).
__device__ __forceinline__ V3 schlick_sample(V3 d, V3 normal, float rough, float p, float ra,
                                             float rb, float rc) {
  if (rough == 0.0f) return reflect(d, normal);
  const float iso2 = p * p;
  const float denom = rough - ra * rough + ra;
  const float alpha = safe_arccos(safe_sqrt(guarded_div(ra, denom, denom == 0.0f)));
  float phi = quadrant_phi(rb, iso2);
  phi = p < 1.0f ? phi + kHalfPi : phi;
  const V3 h = jitter(normal, phi, sinf(alpha), cosf(alpha));
  const V3 new_dir = reflect(d, h);
  if (dot(new_dir, normal) <= 0.0f) {
    return jitter(normal, kTwoPi * rc, sqrtf(ra), sqrtf(1.0f - ra));
  }
  return new_dir;
}

// ------------------------------------------------------ Shirley-Ashikhmin --

struct SaEval {
  float spec, diff, hk1, pdf;
};

// sa_eval (pt_brdf.cl:228-268).
__device__ __forceinline__ SaEval sa_eval(V3 normal, V3 d_out, V3 d_in, float nu, float nv) {
  const V3 un = safe_normalized(cross(yzx(normal), normal));
  const V3 vn = safe_normalized(cross(normal, un));
  const V3 k1 = d_in;
  const V3 k2 = neg(d_out);
  const V3 h = safe_normalized(add(k1, k2));
  const float dot_hu = dot(h, un);
  const float dot_hv = dot(h, vn);
  const float dot_hn = dot(h, normal);
  const float dot_nk1 = dot(normal, k1);
  const float dot_nk2 = dot(normal, k2);
  const float dot_hk1 = dot(h, k1);
  const float ps_e_num = nu * dot_hu * dot_hu + nv * dot_hv * dot_hv;
  const float ps_e = guarded_div(ps_e_num, 1.0f - dot_hn * dot_hn, dot_hn == 1.0f);
  const float ps0 = sqrtf((nu + 1.0f) * (nv + 1.0f)) * 0.125f * kInvPi;
  const float ps1_num = safe_pow(dot_hn, ps_e);
  const float ps1 = safe_div(ps1_num, dot_hk1 * tmax(dot_nk1, dot_nk2));
  const float a = 1.0f - dot_nk1 * 0.5f;
  const float b = 1.0f - dot_nk2 * 0.5f;
  float pd = kSaPd * (1.0f - a * a * a * a * a);
  pd = pd * (1.0f - b * b * b * b * b);
  return SaEval{ps0 * ps1, pd, dot_hk1, safe_div(ps0 * ps1_num, dot_hk1)};
}

// sa_sample (newRayShirleyAshikhmin, pt_brdf.cl:278-330).
__device__ __forceinline__ V3 sa_sample(V3 d, V3 normal, float mtl_d, float nu, float nv,
                                        float ra, float rb, float rc) {
  const float quad = floorf(ra * 4.0f);
  const float a_loc = 1.0f - 4.0f * ((quad + 1.0f) * 0.25f - ra);
  const float phi_flip = quad == 0.0f ? 0.0f : (quad == 3.0f ? kTwoPi : kPi);
  const float phi_flipf = (quad == 1.0f || quad == 3.0f) ? -1.0f : 1.0f;
  const float phi = atanf(sqrtf((nu + 1.0f) / (nv + 1.0f)) * tanf(kHalfPi * a_loc));
  const float phi_full = phi_flip + phi_flipf * phi;
  const float cosphi = cosf(phi);
  const float sinphi = sinf(phi);
  const float theta_e = 1.0f / (nu * cosphi * cosphi + nv * sinphi * sinphi + 1.0f);
  const float theta = safe_arccos(safe_pow(1.0f - rb, theta_e));
  const V3 n_eff = (mtl_d < 1.0f || dot(normal, neg(d)) >= 0.0f) ? normal : neg(normal);
  const V3 h = jitter(n_eff, phi_full, sinf(theta), cosf(theta));
  const V3 spec = reflect(d, h);
  if (dot(spec, n_eff) <= 0.0f) {
    return jitter(n_eff, kTwoPi * rc, sqrtf(rb), sqrtf(1.0f - rb));
  }
  return spec;
}

// ------------------------------------------------------------- Refraction --

// refract_dir (pt_utils.cl:436-465); normal is the unflipped geometric one.
__device__ __forceinline__ V3 refract_dir(V3 d, V3 normal, float ni, float rand_choice) {
  const bool into = dot(normal, neg(d)) > 0.0f;
  const V3 nl = into ? normal : neg(normal);
  const float m1 = into ? kNiAir : ni;
  const float m2 = into ? ni : kNiAir;
  const float m = m1 / m2;
  const float cos_i = -dot(nl, d);
  const float sin_t2 = m * m * (1.0f - cos_i * cos_i);
  const V3 refl_dir = reflect(d, nl);
  if (sin_t2 >= 1.0f) return refl_dir;  // total internal reflection
  const float sqrt_cos_t = safe_sqrt(1.0f - sin_t2);
  const float r0 = (m1 - m2) / (m1 + m2);
  const float c = m1 > m2 ? sqrt_cos_t : cos_i;
  const float reflectance = fresnel(c, r0 * r0);
  if (reflectance < rand_choice) {
    return add(scale(d, m), scale(nl, m * cos_i - sqrt_cos_t));
  }
  return refl_dir;
}

// ------------------------------------------------ the shade's colours --

// _sanitize3: non-finite components to 0.
__device__ __forceinline__ float fin(float c) { return isfinite(c) ? c : 0.0f; }
__device__ __forceinline__ V3 sanitize3(V3 v) { return V3{fin(v.x), fin(v.y), fin(v.z)}; }

// _clip01(_norm_rgb(bc)): bc / max(1, max component), clipped to [0, 1].
__device__ __forceinline__ V3 norm_clip(V3 bc) {
  const float m = tmax(1.0f, max_component(bc));
  const V3 q{bc.x / m, bc.y / m, bc.z / m};
  return V3{tmin(tmax(q.x, 0.0f), 1.0f), tmin(tmax(q.y, 0.0f), 1.0f), tmin(tmax(q.z, 0.0f), 1.0f)};
}

// A lane's material, as the shade kernels gather it.
struct Mat {
  float d, ni, rough, p, nu, nv, rs, rd;
  V3 kd, ks;
};

// ----------------------------------------------------- the Phong normal --

// ops/phongtess.py::patch_constants and phongtess_normal (getPhongTessNormal,
// pt_utils.cl:282-294): the shading normal of a curved face (corner P1,
// edges e1 and e2, vertex normals N1-N3, tessellation alpha) at the
// winner's (u, v), seen along d. K12 bwd reads it as a constant: the face
// and (u, v) carry no gradient, and d only picks one of two normals.
__device__ __forceinline__ V3 phong_normal(V3 P1, V3 e1, V3 e2, V3 N1, V3 N2, V3 N3,
                                           float alpha, V3 d, float u, float v) {
  const V3 P2 = add(P1, e1);
  const V3 P3 = add(P1, e2);
  const V3 E01 = sub(P2, P1);
  const V3 E12 = sub(P3, P2);
  const V3 E20 = sub(P1, P3);
  const V3 C1 = scale(sub(scale(N2, dot(N2, E01)), scale(N1, dot(N1, E01))), alpha);
  const V3 C2 = scale(sub(scale(N3, dot(N3, E12)), scale(N2, dot(N2, E12))), alpha);
  const V3 C3 = scale(sub(scale(N1, dot(N1, E20)), scale(N3, dot(N3, E20))), alpha);
  const float w = 1.0f - u - v;
  const V3 du = add(add(scale(C3, w - u), scale(sub(C1, C2), v)), E20);
  const V3 dv = sub(add(scale(C2, w - v), scale(sub(C1, C3), u)), E12);
  const V3 ns = safe_normalized(cross(du, dv));
  const V3 npn = safe_normalized(add(add(scale(N1, u), scale(N2, v)), scale(N3, w)));
  const V3 r = sub(d, scale(npn, 2.0f * dot(npn, d)));
  return dot(ns, r) < 0.0f ? ns : npn;
}

}  // namespace shade
}  // namespace pbr
