// The Phong-patch test shared by kernels K9 (phong_walk.cu) and K10
// (phong_clusters.cu): a ray against one Phong-tessellated triangle, the
// reference's phongTessTriAndRayIntersect (pt_phongtess.cl:56-212) as the
// JAX package writes it (pbr_tpu/ops/phongtess.py::
// phongtess_patch_intersect), and the face record both kernels read.
//
// The translation is op for op the plain torch version's
// (pbr_tpu_torch/ops/phongtess.py): the same operation order, the same
// guarded divisions (_guard_div: 0 where the divisor is 0), torch's NaN
// rules for minimum, maximum and clamp (a NaN operand is the result; CUDA's
// fminf and fmaxf drop it), and the same library functions torch's CUDA
// kernels call for the plain version's ops: acosf, cosf and powf for acos,
// cos and pow(x, 1/6), and the cube root as the float64 pow(|x|, 1/3)
// rounded once to float32, with x's sign. Built with --fmad=false and IEEE
// division and sqrtf, each operation rounds as the unfused plain version's,
// so the kernels and their plain versions agree bitwise. Where the plain
// version evaluates every branch of a solve and selects, the kernel
// evaluates the branch it selects: the selected value is the same.
//
// Face record (pbr_tpu_torch/ops/phongtess.py::phong_records): 20 floats, five
// 16-byte words {v0, e1.x} {e1.y, e1.z, e2.x, e2.y} {e2.z, n0} {n1, n2.x}
// {n2.y, n2.z, flat, 0}; flat 1.0 where the three vertex normals are equal
// (Moller-Trumbore, mt.cuh), 0.0 for a curved patch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "mt.cuh"

namespace pbr {

constexpr float kPhongEps5 = 1.0e-5f;
constexpr float kThird = 0.333333343f;      // float32(1 / 3)
constexpr float kSixth = 0.166666672f;      // float32(1 / 6)
constexpr float kTwoPi = 6.28318548f;       // float32(2 pi)
constexpr float kFourPi = 12.566371f;       // float32(4 pi)
constexpr float kSafeNormEps = 1.0e-20f;    // ops/vec.py::safe_normalized
constexpr int kPhongWords = 5;              // float4 words a face record

struct PhongFace {
  Face mt;  // v0, e1, e2
  float n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z;
  bool flat;
};

__device__ __forceinline__ PhongFace phong_face(float4 a, float4 b, float4 c, float4 d,
                                                float4 e) {
  PhongFace f;
  f.mt = Face{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
  f.n0x = c.y; f.n0y = c.z; f.n0z = c.w;
  f.n1x = d.x; f.n1y = d.y; f.n1z = d.z;
  f.n2x = d.w; f.n2y = e.x; f.n2z = e.y;
  f.flat = e.z > 0.5f;
  return f;
}

// torch's elementwise rules on the card.
__device__ __forceinline__ float gdiv(float num, float den) {  // _guard_div
  return den != 0.0f ? num / den : 0.0f;
}
__device__ __forceinline__ float tmin(float a, float b) {  // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min0(float v) {  // torch.clamp_min(v, 0)
  return v != v ? v : fmaxf(v, 0.0f);
}
__device__ __forceinline__ float clamp_unit(float v) {  // torch.clamp(v, -1, 1)
  return v != v ? v : fminf(fmaxf(v, -1.0f), 1.0f);
}
// ops/phongtess.py::cbrt: the float64 power of |x| rounded once, x's sign.
__device__ __forceinline__ float cbrt_f64(float x) {
  return copysignf(static_cast<float>(pow(static_cast<double>(fabsf(x)), 1.0 / 3.0)), x);
}

struct Roots {
  float x0, x1, x2;
  int count;
};

// solve_quadratic(a1, a2, a3): roots of a1 x^2 + a2 x + a3 with Newton
// polish; x1 -1 unless there are two.
__device__ __forceinline__ float newton2(float a1, float a2, float a3, float x) {
  const float num = a3 + x * (a2 + x * a1);
  const float den = a2 + x * 2.0f * a1;
  return x - gdiv(num, den);
}

__device__ __forceinline__ Roots solve_quadratic(float a1, float a2, float a3) {
  Roots r{0.0f, -1.0f, -1.0f, 0};
  if (fabsf(a1) > 0.0f) {
    const float pq = 0.5f * gdiv(a2, a1);
    const float qdis = pq * pq - gdiv(a3, a1);
    if (qdis >= 0.0f) {
      const float qs = sqrtf(clamp_min0(qdis));
      r.x0 = newton2(a1, a2, a3, -pq - qs);
      r.x1 = newton2(a1, a2, a3, -pq + qs);
      r.count = 2;
      return r;
    }
  }
  // No two real roots: the linear root (counted only when a2 != 0 and
  // there is no quadratic term).
  r.x0 = gdiv(-a3, a2);
  r.count = (!(fabsf(a1) > 0.0f) && fabsf(a2) > 0.0f) ? 1 : 0;
  return r;
}

__device__ __forceinline__ float newton3(float a0, float a1, float a2, float a3, float x) {
  const float num = a3 + x * (a2 + x * (a1 + x * a0));
  const float den = a2 + x * (2.0f * a1 + x * 3.0f * a0);
  return x - gdiv(num, den);
}

// solve_cubic(a0, a1, a2, a3): roots of a0 x^3 + a1 x^2 + a2 x + a3.
__device__ __forceinline__ Roots solve_cubic(float a0, float a1, float a2, float a3) {
  if (!(fabsf(a0) > 0.0f)) return solve_quadratic(a1, a2, a3);
  const float w = gdiv(a1, a0) * kThird;
  const float p_lin = gdiv(a2, a0) * kThird - w * w;
  const float p = p_lin * p_lin * p_lin;
  const float q = 0.5f * gdiv(a2 * w - a3, a0) - w * w * w;
  const float dis = q * q + p;
  Roots r{0.0f, -1.0f, -1.0f, 0};
  if (dis < 0.0f) {  // three real roots
    const float neg_p = clamp_min0(-p);
    const float phi = acosf(clamp_unit(gdiv(q, sqrtf(neg_p))));
    const float pp = 2.0f * powf(neg_p, kSixth);
    const float u0 = pp * cosf(phi * kThird) - w;
    const float u1 = pp * cosf((phi + kTwoPi) * kThird) - w;
    const float u2 = pp * cosf((phi + kFourPi) * kThird) - w;
    const float c0 = tmin(u0, tmin(u1, u2));
    const float c2 = tmax(u0, tmax(u1, u2));
    const float c1 = tmax(tmin(u0, u1), tmax(tmin(u0, u2), tmin(u1, u2)));
    r.x0 = newton3(a0, a1, a2, a3, c0);
    r.x1 = newton3(a0, a1, a2, a3, c1);
    r.x2 = newton3(a0, a1, a2, a3, c2);
    r.count = 3;
  } else {  // one real root
    const float sq = sqrtf(clamp_min0(dis));
    r.x0 = newton3(a0, a1, a2, a3, cbrt_f64(q + sq) + cbrt_f64(q - sq) - w);
    r.count = 1;
  }
  return r;
}

// A ray's two planes (getPlanesFromRay, pt_utils.cl:208-218) and the axis
// of its direction's largest component (getBestRayDomain).
struct PhongRay {
  float ox, oy, oz, dx, dy, dz;
  float n1x, n1y, n1z, n2x, n2y, n2z, o1, o2;
  int domain;
};
constexpr int kPhongRayWords = 15;  // PhongRay's words, domain last

__device__ __forceinline__ PhongRay phong_ray(float ox, float oy, float oz, float dx, float dy,
                                              float dz) {
  PhongRay r;
  r.ox = ox; r.oy = oy; r.oz = oz; r.dx = dx; r.dy = dy; r.dz = dz;
  // n1 = safe_normalized(o x d)
  float cx = oy * dz - oz * dy, cy = oz * dx - ox * dz, cz = ox * dy - oy * dx;
  float l2 = cx * cx + cy * cy + cz * cz;
  float inv = l2 > kSafeNormEps ? 1.0f / sqrtf(l2) : 0.0f;
  r.n1x = cx * inv; r.n1y = cy * inv; r.n1z = cz * inv;
  // n2 = safe_normalized(n1 x d)
  cx = r.n1y * dz - r.n1z * dy;
  cy = r.n1z * dx - r.n1x * dz;
  cz = r.n1x * dy - r.n1y * dx;
  l2 = cx * cx + cy * cy + cz * cz;
  inv = l2 > kSafeNormEps ? 1.0f / sqrtf(l2) : 0.0f;
  r.n2x = cx * inv; r.n2y = cy * inv; r.n2z = cz * inv;
  r.o1 = r.n1x * ox + r.n1y * oy + r.n1z * oz;
  r.o2 = r.n2x * ox + r.n2y * oy + r.n2z * oz;
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  r.domain = ax > ay ? (ax > az ? 0 : 2) : (ay > az ? 1 : 2);
  return r;
}

struct PatchHit {
  float t, u, v;  // t +inf where no root is acceptable
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return ax * bx + ay * by + az * bz;
}

// q - n * ((q - p) . n), one component at a time (ops/vec.py::project_on_plane).
#define PBR_PROJECT(qx, qy, qz, px, py, pz, nx, ny, nz, outx, outy, outz)      \
  do {                                                                          \
    const float s_ = dot3((qx) - (px), (qy) - (py), (qz) - (pz), nx, ny, nz);   \
    outx = (qx) - (nx) * s_;                                                    \
    outy = (qy) - (ny) * s_;                                                    \
    outz = (qz) - (nz) * s_;                                                    \
  } while (0)

// The nearest acceptable root of the patch with 0 <= t <= t_best
// (phongtess_patch_intersect with t_near 0 and no t_far). alpha is
// float32(alpha), oma float32(1 - alpha).
__device__ __forceinline__ PatchHit patch_intersect(const PhongFace& fc, const PhongRay& r,
                                                    float alpha, float oma, float t_best) {
  const Face& f = fc.mt;
  const float P1x = f.v0x, P1y = f.v0y, P1z = f.v0z;
  const float P2x = P1x + f.e1x, P2y = P1y + f.e1y, P2z = P1z + f.e1z;
  const float P3x = P1x + f.e2x, P3y = P1y + f.e2y, P3z = P1z + f.e2z;
  const float N1x = fc.n0x, N1y = fc.n0y, N1z = fc.n0z;
  const float N2x = fc.n1x, N2y = fc.n1y, N2z = fc.n1z;
  const float N3x = fc.n2x, N3y = fc.n2y, N3z = fc.n2z;
  const float E01x = P2x - P1x, E01y = P2y - P1y, E01z = P2z - P1z;
  const float E12x = P3x - P2x, E12y = P3y - P2y, E12z = P3z - P2z;
  const float E20x = P1x - P3x, E20y = P1y - P3y, E20z = P1z - P3z;
  float s2 = dot3(N2x, N2y, N2z, E01x, E01y, E01z);
  float s1 = dot3(N1x, N1y, N1z, E01x, E01y, E01z);
  const float C1x = (N2x * s2 - N1x * s1) * alpha, C1y = (N2y * s2 - N1y * s1) * alpha,
              C1z = (N2z * s2 - N1z * s1) * alpha;
  s2 = dot3(N3x, N3y, N3z, E12x, E12y, E12z);
  s1 = dot3(N2x, N2y, N2z, E12x, E12y, E12z);
  const float C2x = (N3x * s2 - N2x * s1) * alpha, C2y = (N3y * s2 - N2y * s1) * alpha,
              C2z = (N3z * s2 - N2z * s1) * alpha;
  s2 = dot3(N1x, N1y, N1z, E20x, E20y, E20z);
  s1 = dot3(N3x, N3y, N3z, E20x, E20y, E20z);
  const float C3x = (N1x * s2 - N3x * s1) * alpha, C3y = (N1y * s2 - N3y * s1) * alpha,
              C3z = (N1z * s2 - N3z * s1) * alpha;

  const float Dx = C1x - C2x - C3x, Dy = C1y - C2y - C3y, Dz = C1z - C2z - C3z;
  const float Ex = C3x + E20x, Ey = C3y + E20y, Ez = C3z + E20z;
  const float Fx = C2x - E12x, Fy = C2y - E12y, Fz = C2z - E12z;
  const float a = dot3(-r.n1x, -r.n1y, -r.n1z, C3x, C3y, C3z);
  const float b = dot3(-r.n1x, -r.n1y, -r.n1z, C2x, C2y, C2z);
  const float c = dot3(r.n1x, r.n1y, r.n1z, P3x, P3y, P3z) - r.o1;
  const float dd = dot3(r.n1x, r.n1y, r.n1z, Dx, Dy, Dz) * 0.5f;
  const float e = dot3(r.n1x, r.n1y, r.n1z, Ex, Ey, Ez) * 0.5f;
  const float ff = dot3(r.n1x, r.n1y, r.n1z, Fx, Fy, Fz) * 0.5f;
  const float l = dot3(-r.n2x, -r.n2y, -r.n2z, C3x, C3y, C3z);
  const float m = dot3(-r.n2x, -r.n2y, -r.n2z, C2x, C2y, C2z);
  const float n_ = dot3(r.n2x, r.n2y, r.n2z, P3x, P3y, P3z) - r.o2;
  const float o_ = dot3(r.n2x, r.n2y, r.n2z, Dx, Dy, Dz) * 0.5f;
  const float p = dot3(r.n2x, r.n2y, r.n2z, Ex, Ey, Ez) * 0.5f;
  const float q = dot3(r.n2x, r.n2y, r.n2z, Fx, Fy, Fz) * 0.5f;

  const float a3c = (l * m * n_ + 2.0f * o_ * p * q) - (l * q * q + m * p * p + n_ * o_ * o_);
  const float a2c =
      (a * m * n_ + l * b * n_ + l * m * c + 2.0f * (dd * p * q + o_ * e * q + o_ * p * ff)) -
      (a * q * q + b * p * p + c * o_ * o_ + 2.0f * (l * ff * q + m * e * p + n_ * dd * o_));
  const float a1c =
      (a * b * n_ + a * m * c + l * b * c + 2.0f * (o_ * e * ff + dd * e * q + dd * p * ff)) -
      (l * ff * ff + m * e * e + n_ * dd * dd + 2.0f * (a * ff * q + b * e * p + c * dd * o_));
  const float a0c = (a * b * c + 2.0f * dd * e * ff) - (a * ff * ff + b * e * e + c * dd * dd);

  // The reference's "a0" is the x^3 coefficient (pt_phongtess.cl:99-106).
  const Roots cr = solve_cubic(a0c, a1c, a2c, a3c);
  // The root minimising mD^2 - mA mB (strict-greater update).
  float x = 0.0f, det = INFINITY;
  const float xs[3] = {cr.x0, cr.x1, cr.x2};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float mA = a * xs[i] + l, mB = b * xs[i] + m, mD = dd * xs[i] + o_;
    const float tmp = mD * mD - mA * mB;
    if (i < cr.count && det > tmp) {
      x = xs[i];
      det = tmp;
    }
  }
  const bool ok = cr.count > 0 && det > 0.0f;

  float mA = a * x + l, mB = b * x + m, mC = c * x + n_;
  float mD = dd * x + o_, mE = e * x + p, mF = ff * x + q;
  const bool a_less_b = fabsf(mA) < fabsf(mB);
  const float inv = gdiv(1.0f, a_less_b ? mB : mA);
  mA = mA * inv; mB = mB * inv; mC = mC * inv; mD = mD * inv; mE = mE * inv; mF = mF * inv;
  const float mAorB = a_less_b ? mA : mB;
  const float mEorF = a_less_b ? 2.0f * mE : 2.0f * mF;
  const float mForE = a_less_b ? mF : mE;
  const float ab = a_less_b ? a : b, ba = a_less_b ? b : a;
  const float ef = a_less_b ? e : ff, fe = a_less_b ? ff : e;
  const float sqrtAorB = sqrtf(clamp_min0(mD * mD - mAorB));
  const float sqrtC = sqrtf(clamp_min0(mForE * mForE - mC));
  const float lab1 = mD + sqrtAorB, lab2 = mD - sqrtAorB;
  float lc1 = mForE + sqrtC, lc2 = mForE - sqrtC;
  // The factored product's u-coefficient is the cross pairing; swap the
  // lc labels where the same-index pairing matches better
  // (pt_phongtess.cl:166-168).
  if (fabsf(mEorF - lab1 * lc1 - lab2 * lc2) < fabsf(mEorF - lab1 * lc2 - lab2 * lc1)) {
    const float tmp = lc1;
    lc1 = lc2;
    lc2 = tmp;
  }

  PatchHit out{INFINITY, 0.0f, 0.0f};
  const float dax = r.domain == 0 ? r.dx : (r.domain == 1 ? r.dy : r.dz);
#pragma unroll
  for (int loop = 0; loop < 2; ++loop) {
    const float g = loop == 0 ? -lab1 : -lab2;
    const float h = loop == 0 ? -lc1 : -lc2;
    const float c0 = ab + g * (2.0f * dd + ba * g);
    const float c1 = 2.0f * (h * (dd + ba * g) + ef + fe * g);
    const float c2 = h * (ba * h + 2.0f * fe) + c;
    const Roots qr = solve_quadratic(c0, c1, c2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float u = i == 0 ? qr.x0 : qr.x1;
      const float v = g * u + h;
      const float wbar = 1.0f - u - v;
      if (!(ok && i < qr.count && u >= 0.0f && v >= 0.0f && wbar >= 0.0f)) continue;
      const float uu = a_less_b ? u : v, vv = a_less_b ? v : u;
      // The tessellated point (phongTessellation, pt_phongtess.cl:14-26).
      const float ww = 1.0f - uu - vv;
      const float bx = P1x * uu + P2x * vv + P3x * ww;
      const float by = P1y * uu + P2y * vv + P3y * ww;
      const float bz = P1z * uu + P2z * vv + P3z * ww;
      float q1x, q1y, q1z, q2x, q2y, q2z, q3x, q3y, q3z;
      PBR_PROJECT(bx, by, bz, P1x, P1y, P1z, N1x, N1y, N1z, q1x, q1y, q1z);
      PBR_PROJECT(bx, by, bz, P2x, P2y, P2z, N2x, N2y, N2z, q2x, q2y, q2z);
      PBR_PROJECT(bx, by, bz, P3x, P3y, P3z, N3x, N3y, N3z, q3x, q3y, q3z);
      const float tx = q1x * uu + q2x * vv + q3x * ww;
      const float ty = q1y * uu + q2y * vv + q3y * ww;
      const float tz = q1z * uu + q2z * vv + q3z * ww;
      const float ptx = bx * oma + tx * alpha - r.ox;
      const float pty = by * oma + ty * alpha - r.oy;
      const float ptz = bz * oma + tz * alpha - r.oz;
      const float pax = r.domain == 0 ? ptx : (r.domain == 1 ? pty : ptz);
      const float t_param = gdiv(pax, dax);
      if (t_param >= 0.0f && t_param <= tmin(out.t, t_best)) {
        out.t = t_param;
        out.u = uu;
        out.v = vv;
      }
    }
  }
  return out;
}

#undef PBR_PROJECT

// One face of a Phong search against ray (r, pr): Moller-Trumbore for a
// flat face, the patch test with bound t_best (t at least EPSILON5) for a
// curved one. Returns t, +inf where the face is not hit; u and v 0 on a
// flat face.
__device__ __forceinline__ PatchHit phong_face_hit(const PhongFace& fc, const PhongRay& pr,
                                                   float alpha, float oma, float t_best) {
  if (fc.flat) {
    float t;
    const bool valid = moller_trumbore(fc.mt, pr.ox, pr.oy, pr.oz, pr.dx, pr.dy, pr.dz, &t);
    return PatchHit{valid ? t : INFINITY, 0.0f, 0.0f};
  }
  PatchHit h = patch_intersect(fc, pr, alpha, oma, t_best);
  if (!(h.t < INFINITY && h.t >= kPhongEps5)) h.t = INFINITY;
  return h;
}

// phong_face_hit for a caller that keeps only t <= t_best (a face beyond
// the bound cannot win, a face at it can on a lower id): a flat face
// computes t first, as K1 does (mt.cuh's mt_t and mt_uv), and its u and v
// only where t lies in [EPSILON5, t_best]. Where it reports a hit, t is
// phong_face_hit's; elsewhere +inf.
__device__ __forceinline__ PatchHit phong_face_hit_within(const PhongFace& fc,
                                                          const PhongRay& pr, float alpha,
                                                          float oma, float t_best) {
  if (fc.flat) {
    const MtParts m = mt_t(fc.mt, pr.ox, pr.oy, pr.oz, pr.dx, pr.dy, pr.dz);
    const float inv = 1.0f / m.det;
    const float t = m.tnum * inv;
    const bool valid = t >= kMtEps5 && t <= t_best && mt_uv(m, pr.dx, pr.dy, pr.dz, inv);
    return PatchHit{valid ? t : INFINITY, 0.0f, 0.0f};
  }
  return phong_face_hit(fc, pr, alpha, oma, t_best);
}

}  // namespace pbr
