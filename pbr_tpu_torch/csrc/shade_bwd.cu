// The backward of the frame's shading for Hopper (sm_90a): kernels K12 bwd
// (a bounce's shade) and K11 bwd (camera rays).
//
// They replace no Pallas kernel. The JAX package differentiates its frame
// with jax.grad of one XLA program, and XLA fuses the shade's backward as
// it fuses the forward: K12 bwd is the port's counterpart of that fusion
// for pbr_tpu/models/integrator.py:579-833 (with _orb_pass at :324), K11
// bwd for _gen_rays (:287). Without them autograd ran the plain shade's
// some 1,300 ATen ops a bounce and their backward, each a pass over the
// lanes.
//
// K12 bwd (shade_bwd_kernel<BRDF, NEE, TRANS, PHONG>; one instance serves
// the fused and the post forward alike, the occluded bit given): one thread
// a lane recomputes the bounce from the forward's inputs (the miss and its
// orb, the material, the geometric or Phong shading normal, the last-bounce
// break, the hit point, the sampled direction, which is detached, the
// shadow ray and the two BRDF evaluations) and applies the adjoint in
// reverse, as ops/cuda_shade.py::shade_vjp_terms does with torch ops: the
// gradients of o, d, colour, light value and t a lane, bitwise the plain
// adjoint's on the card (the final colour's is the upstream gradient
// itself, which the wrapper returns). The shading normal is a constant of
// what the step differentiates: the triangles and the winner's (u, v) are
// detached, and d only selects between the patch's normal and the
// interpolated one, so a Phong bounce adds no adjoint, only its normal.
//
// The table gradients (materials M x 14, lights' position and colour L x
// 6) are sums over the lanes. Each warp sums its lanes' terms a material
// at a time (a butterfly of shuffles, the same order on every run) into
// its own row, in shared memory where a block's eight rows fit (up to
// about 500 materials) and else in a global scratch the wrapper gives; a
// block adds its chunks in order and at the end its warps' rows in warp
// order into its partial row; the last block to finish (a counter of
// finished blocks) sums the partial rows in block order. The grid is fixed
// by the lane count and the table's size, so replays of a captured step
// repeat every bit; atomic sums would not.
//
// K11 bwd (gen_rays_bwd_kernel): each lane's adjoint of the pinhole, the
// AA jitter and the thin-lens DoF with respect to the camera's 15 scalars
// (ops/cuda_shade.py::gen_rays_vjp_terms), summed the same two-pass way.
//
// What bounds them on this card: bytes. K12 bwd reads what the forward read
// of a lane (o, d, colour: 36 B; alive, budget, t, face, occluded, key: 22
// B) and the outputs' gradients (60 B) and writes the inputs' gradients
// (52 B): about 170 B a lane, 0.053 ms at 1M lanes over 3.35 TB/s. The
// arithmetic is a few thousand float32 operations a live lane (the forward
// again, two BRDF adjoints), which at the 33.5 T op/s that --fmad=false
// leaves is of the same order: the first design keeps it simple, one
// thread a lane, 256 lanes a block.
//
// Numerics as the other kernels (--fmad=false, IEEE division and sqrtf,
// vec.cuh, brdf.cuh, rng.cuh), the adjoint's formulas and their order those
// of ops/vec.py, ops/brdf.py and ops/cuda_shade.py's plain adjoints.

#include <cuda_runtime.h>
#include <math.h>

#include "brdf.cuh"
#include "rng.cuh"
#include "vec.cuh"

namespace {

using namespace pbr::shade;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSchlick = 0;  // utils/config.py::BRDF_SCHLICK
constexpr float kFourPi = 4.0f * kPi;  // exact
constexpr int kSmemDefault = 48 * 1024;

// ------------------------------------------------------------- adjoints --

__device__ __forceinline__ float sum3(V3 v) { return v.x + v.y + v.z; }

// d maximum(a, b) / d a as autograd takes it (minimum(a, b)'s: mxw(b, a)).
__device__ __forceinline__ float mxw(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

__device__ __forceinline__ V3 normalized_vjp(V3 v, V3 g) {
  const float inv = 1.0f / sqrtf(dot(v, v));
  const V3 n = scale(v, inv);
  return scale(sub(g, scale(n, dot(g, n))), inv);
}

__device__ __forceinline__ V3 safe_normalized_vjp(V3 v, V3 g) {
  const float l2 = dot(v, v);
  const float inv = l2 > 1.0e-20f ? 1.0f / sqrtf(l2) : 0.0f;
  const V3 n = scale(v, inv);
  return scale(sub(g, scale(n, dot(g, n))), inv);
}

// jitter's adjoint with respect to nl.
__device__ __forceinline__ V3 jitter_vjp(V3 nl, float phi, float sina, float cosa, V3 g) {
  const V3 y = yzx(nl);
  const V3 a = cross(y, nl);
  const V3 u = safe_normalized(a);
  const V3 b = cross(nl, u);
  const V3 v = safe_normalized(b);
  const float cp = cosf(phi), sp = sinf(phi);
  const V3 az0 = add(scale(u, cp), scale(v, sp));
  const V3 az = normalized(az0);
  const V3 r0 = add(scale(az, sina), scale(nl, cosa));
  const V3 g_r0 = normalized_vjp(r0, g);
  const V3 g_az0 = normalized_vjp(az0, scale(g_r0, sina));
  V3 g_nl = scale(g_r0, cosa);
  const V3 g_b = safe_normalized_vjp(b, scale(g_az0, sp));
  const V3 g_u = add(scale(g_az0, cp), cross(g_b, nl));
  g_nl = add(g_nl, cross(u, g_b));
  const V3 g_a = safe_normalized_vjp(a, g_u);
  const V3 g_y = cross(nl, g_a);
  g_nl = add(g_nl, cross(g_a, y));
  return V3{g_nl.x + g_y.z, g_nl.y + g_y.x, g_nl.z + g_y.y};
}

// fresnel(u, c)'s adjoint: returns g_u, sets g_c.
__device__ __forceinline__ float fresnel_vjp(float u, float c, float g, float& g_c) {
  const float v = 1.0f - u;
  const float v4 = v * v * v * v;
  g_c = g * (1.0f - v * v * v * v * v);
  const float g_v5 = g * (1.0f - c);
  return -(g_v5 * (5.0f * v4));
}
__device__ __forceinline__ float fresnel3_vjp(float u, V3 c, V3 g, V3& g_c) {
  const float v = 1.0f - u;
  const float v4 = v * v * v * v;
  g_c = scale(g, 1.0f - v * v * v * v * v);
  const float g_v5 = sum3(mul(g, rsubs(1.0f, c)));
  return -(g_v5 * (5.0f * v4));
}

// q = guarded_div(num, den, zero_if): (g_num, g_den), zero where guarded.
struct G2 {
  float num, den;
};
__device__ __forceinline__ G2 guarded_vjp(float den, bool zero_if, float q, float g) {
  return G2{zero_if ? 0.0f : g / den, zero_if ? 0.0f : -(g * q) / den};
}

__device__ __forceinline__ void schlick_G_vjp(float v, float r, float g, float& g_v,
                                              float& g_r) {
  const float x = r - r * v + v;
  const bool zero = x == 0.0f;
  const G2 gx = guarded_vjp(x, zero, guarded_div(v, x, zero), g);
  g_v = gx.num + gx.den * (1.0f - r);
  g_r = gx.den * (1.0f - v);
}

struct DGrad {
  float t, v_out, v_in, w, r, p;
};

__device__ __forceinline__ DGrad schlick_D_vjp(float t, float v_out, float v_in, float w,
                                               float r, float p, float g) {
  const float b = 4.0f * r * (1.0f - r);
  const bool r_lt = r < 0.5f;
  const float one_b = 1.0f - b;
  const float dd = kFourPi * v_out * v_in;
  const float gv1 = schlick_G(v_out, r), gv2 = schlick_G(v_in, r);
  const float gp = gv1 * gv2;
  const float z = schlick_Z(t, r);
  const float a_ = schlick_A(w, p);
  const float m1 = gp * z;
  const float b2 = m1 * a_ + (1.0f - gp);
  const bool q_zero = (b == 0.0f) || (dd == 0.0f);
  const float q = guarded_div(b, dd, q_zero);
  const bool f_zero = v_in == 0.0f;
  const float fres = guarded_div(r_lt ? one_b : 0.0f, v_in, f_zero);
  // D = a / pi + q * b2 + c / v_in
  const float g_a = g * kInvPi;
  const float g_q = g * b2;
  const float g_b2 = g * q;
  const G2 gc = guarded_vjp(v_in, f_zero, fres, g);
  const G2 gb = guarded_vjp(dd, q_zero, q, g_q);
  const float g_b = gb.num - (r_lt ? gc.num : g_a);
  const float g_m1 = g_b2 * a_;
  const float g_a_ = g_b2 * m1;
  const float g_gp = g_m1 * z - g_b2;
  const float g_z = g_m1 * gp;
  const float g_vo = gb.den * v_in * kFourPi;
  const float g_vi = gc.den + gb.den * (kFourPi * v_out);
  float g_r = g_b * (1.0f - r) * 4.0f - g_b * (4.0f * r);
  // Z(t, r) = r / x^2, x = 1 + r t t - t t
  const float x = 1.0f + r * t * t - t * t;
  const G2 gz = guarded_vjp(x * x, x == 0.0f, z, g_z);
  const float g_x = gz.den * x * 2.0f;
  g_r = g_r + gz.num + g_x * (t * t);
  const float g_t = g_x * (r * t * 2.0f - t * 2.0f);
  // A(w, p) = safe_sqrt(p / x), x = p2 - p2 w2 + w2
  const float p2 = p * p, w2 = w * w;
  const float xa = p2 - p2 * w2 + w2;
  const bool za = xa == 0.0f;
  const float y = guarded_div(p, xa, za);
  const float g_y = y > 0.0f ? g_a_ / (2.0f * a_) : 0.0f;
  const G2 gpx = guarded_vjp(xa, za, y, g_y);
  const float g_p = gpx.num + gpx.den * (1.0f - w2) * p * 2.0f;
  const float g_w = gpx.den * (1.0f - p2) * w * 2.0f;
  float g_vo1, g_r1, g_vi2, g_r2;
  schlick_G_vjp(v_out, r, g_gp * gv2, g_vo1, g_r1);
  schlick_G_vjp(v_in, r, g_gp * gv1, g_vi2, g_r2);
  return DGrad{g_t, g_vo + g_vo1, g_vi + g_vi2, g_w, g_r + g_r1 + g_r2, g_p};
}

// An evaluation's adjoint: the directions' gradients and the two material
// parameters' (rough and p; nu and nv).
struct EvalGrad {
  V3 d_out, d_in;
  float a, b;
};

__device__ __forceinline__ EvalGrad schlick_eval_vjp(V3 normal, V3 d_out, V3 d_in, float rough,
                                                     float p, float g_brdf, float g_u,
                                                     float g_pdf) {
  const V3 vo = neg(d_out);
  const V3 un = safe_normalized(cross(yzx(normal), normal));
  const V3 hs = add(vo, d_in);
  const V3 h = safe_normalized(hs);
  const float t = dot(h, normal);
  const float v_in = dot(d_in, normal);
  const float v_out = dot(vo, normal);
  const V3 c1 = cross(h, normal);
  const V3 c2 = cross(c1, normal);
  const V3 hp = safe_normalized(c2);
  const float w = dot(un, hp);
  const float den = kFourPi * dot(h, vo);
  const bool pok = fabsf(den) > 1.0e-12f;
  const float pdf = pok ? t / den : 0.0f;
  const DGrad gd = schlick_D_vjp(t, v_out, v_in, w, rough, p, g_brdf);
  const G2 gp = guarded_vjp(den, !pok, pdf, g_pdf);
  const float g_t = gd.t + gp.num;
  const float g_hvo = g_u + gp.den * kFourPi;  // u and the pdf's denominator are h . vo
  const V3 g_c2 = safe_normalized_vjp(c2, scale(un, gd.w));
  const V3 g_c1 = cross(normal, g_c2);
  const V3 g_h = add(add(cross(normal, g_c1), scale(normal, g_t)), scale(vo, g_hvo));
  const V3 g_hs = safe_normalized_vjp(hs, g_h);
  const V3 g_vo = add(add(scale(h, g_hvo), scale(normal, gd.v_out)), g_hs);
  const V3 g_din = add(g_hs, scale(normal, gd.v_in));
  return EvalGrad{neg(g_vo), g_din, gd.r, gd.p};
}

__device__ __forceinline__ EvalGrad sa_eval_vjp(V3 normal, V3 d_out, V3 d_in, float nu, float nv,
                                                float g_spec, float g_diff, float g_hk1,
                                                float g_pdf) {
  const V3 un = safe_normalized(cross(yzx(normal), normal));
  const V3 vn = safe_normalized(cross(normal, un));
  const V3 k1 = d_in;
  const V3 k2 = neg(d_out);
  const V3 hs = add(k1, k2);
  const V3 h = safe_normalized(hs);
  const float dot_hu = dot(h, un);
  const float dot_hv = dot(h, vn);
  const float dot_hn = dot(h, normal);
  const float dot_nk1 = dot(normal, k1);
  const float dot_nk2 = dot(normal, k2);
  const float dot_hk1 = dot(h, k1);
  const float ps_e_num = nu * dot_hu * dot_hu + nv * dot_hv * dot_hv;
  const bool e_zero = dot_hn == 1.0f;
  const float den_e = 1.0f - dot_hn * dot_hn;
  const float ps_e = guarded_div(ps_e_num, den_e, e_zero);
  const float sq = sqrtf((nu + 1.0f) * (nv + 1.0f));
  const float ps0 = sq * 0.125f * kInvPi;
  const bool pos = dot_hn > 0.0f;
  const float hn_s = pos ? dot_hn : 1.0f;
  const float ps1_num = pos ? powf(hn_s, ps_e) : 0.0f;
  const float mx = tmax(dot_nk1, dot_nk2);
  const float den1 = dot_hk1 * mx;
  const bool ok1 = fabsf(den1) > 1.0e-12f;
  const float ps1 = ok1 ? ps1_num / den1 : 0.0f;
  const float a = 1.0f - dot_nk1 * 0.5f;
  const float b = 1.0f - dot_nk2 * 0.5f;
  const float pd1 = kSaPd * (1.0f - a * a * a * a * a);
  const bool okh = fabsf(dot_hk1) > 1.0e-12f;
  const float pdf = okh ? ps0 * ps1_num / dot_hk1 : 0.0f;
  // spec = ps0 ps1, pdf = safe_div(ps0 ps1_num, hk1), diff = pd1 (1 - b^5)
  const G2 gq = guarded_vjp(dot_hk1, !okh, pdf, g_pdf);
  float ghk = g_hk1 + gq.den;
  const float g_ps0 = g_spec * ps1 + gq.num * ps1_num;
  const float g_ps1 = g_spec * ps0;
  float g_p = gq.num * ps0;
  const float g_pd1 = g_diff * (1.0f - b * b * b * b * b);
  const float g_b = -(g_diff * pd1) * (5.0f * (b * b * b * b));
  const float g_a = -(g_pd1 * kSaPd) * (5.0f * (a * a * a * a));
  const G2 gp1 = guarded_vjp(den1, !ok1, ps1, g_ps1);
  g_p = g_p + gp1.num;
  ghk = ghk + gp1.den * mx;
  const float g_mx = gp1.den * dot_hk1;
  const float g_nk1 = g_mx * mxw(dot_nk1, dot_nk2) - g_a * 0.5f;
  const float g_nk2 = g_mx * mxw(dot_nk2, dot_nk1) - g_b * 0.5f;
  // ps1_num = safe_pow(hn, e): e hn^(e - 1) and hn^e ln hn
  float g_hn = pos ? g_p * (ps_e * powf(hn_s, ps_e - 1.0f)) : 0.0f;
  const float g_e = pos ? g_p * (ps1_num * logf(hn_s)) : 0.0f;
  const float g_s0 = g_ps0 * kInvPi * 0.125f / (2.0f * sq);
  const G2 gn = guarded_vjp(den_e, e_zero, ps_e, g_e);
  g_hn = g_hn - gn.den * dot_hn * 2.0f;
  const float g_nu = g_s0 * (nv + 1.0f) + gn.num * dot_hu * dot_hu;
  const float g_nv = g_s0 * (nu + 1.0f) + gn.num * dot_hv * dot_hv;
  const float g_hu = gn.num * nu * dot_hu * 2.0f;
  const float g_hv = gn.num * nv * dot_hv * 2.0f;
  const V3 g_h = add(add(add(scale(un, g_hu), scale(vn, g_hv)), scale(normal, g_hn)),
                     scale(k1, ghk));
  const V3 g_hs = safe_normalized_vjp(hs, g_h);
  const V3 g_k1 = add(add(scale(normal, g_nk1), scale(h, ghk)), g_hs);
  const V3 g_k2 = add(scale(normal, g_nk2), g_hs);
  return EvalGrad{neg(g_k2), g_k1, g_nu, g_nv};
}

// _sanitize3's adjoint: g where v is finite.
__device__ __forceinline__ V3 finite_g(V3 v, V3 g) {
  return V3{isfinite(v.x) ? g.x : 0.0f, isfinite(v.y) ? g.y : 0.0f,
            isfinite(v.z) ? g.z : 0.0f};
}

// inner = fresnel(u, ks) w m_d + (1 - m_d): returns g_u, sets g_ks, g_w, g_md.
__device__ __forceinline__ float schlick_inner_vjp(float u, V3 ks, float w, float m_d, V3 g,
                                                   V3& g_ks, float& g_w, float& g_md) {
  const V3 f = fresnel3(u, ks);
  const V3 fw = scale(f, w);
  const V3 g_fw = scale(g, m_d);
  g_md = sum3(mul(g, fw)) - sum3(g);
  g_w = sum3(mul(g_fw, f));
  return fresnel3_vjp(u, ks, scale(g_fw, w), g_ks);
}

// clip01(norm_rgb(bc))'s adjoint, bc = (ks b_s + kd b_d) m_d + (1 - m_d),
// b_s = spec / pdf fresnel(hk1, Rs), b_d = diff Rd / pdf (1 - Rs).
struct SaBcGrad {
  float spec, diff, hk1, pdf, md, rs, rd;
  V3 kd, ks;
};

__device__ __forceinline__ SaBcGrad sa_bc_vjp(float spec, float diff, float hk1, float pdf,
                                              const Mat& m, V3 g) {
  const float sp = spec / pdf;
  const float fs = fresnel(hk1, m.rs);
  const float b_s = sp * fs;
  const float q = diff * m.rd / pdf;
  const float omr = 1.0f - m.rs;
  const float b_d = q * omr;
  const V3 s_ = add(scale(m.ks, b_s), scale(m.kd, b_d));
  const V3 bc = adds(scale(s_, m.d), 1.0f - m.d);
  const float mc = max_component(bc);
  const float den = tmax(1.0f, mc);
  const V3 bcn{bc.x / den, bc.y / den, bc.z / den};
  const V3 g_mx{g.x * mxw(1.0f, tmax(bcn.x, 0.0f)), g.y * mxw(1.0f, tmax(bcn.y, 0.0f)),
                g.z * mxw(1.0f, tmax(bcn.z, 0.0f))};
  const V3 g_bcn{g_mx.x * mxw(bcn.x, 0.0f), g_mx.y * mxw(bcn.y, 0.0f),
                 g_mx.z * mxw(bcn.z, 0.0f)};
  const float g_mc = -sum3(mul(g_bcn, bcn)) / den * mxw(mc, 1.0f);
  const float m1 = tmax(bc.x, bc.y);
  const float g_m1 = g_mc * mxw(m1, bc.z);
  const V3 g_q{g_bcn.x / den, g_bcn.y / den, g_bcn.z / den};
  const V3 g_bc{g_q.x + g_m1 * mxw(bc.x, bc.y), g_q.y + g_m1 * mxw(bc.y, bc.x),
                g_q.z + g_mc * mxw(bc.z, m1)};
  const V3 g_s = scale(g_bc, m.d);
  const float g_md = sum3(mul(g_bc, s_)) - sum3(g_bc);
  const float g_bs = sum3(mul(g_s, m.ks));
  const float g_bd = sum3(mul(g_s, m.kd));
  const float g_qd = g_bd * omr;
  const float g_sp = g_bs * fs;
  float g_rs;
  const float g_hk1 = fresnel_vjp(hk1, m.rs, g_bs * sp, g_rs);
  const float g_dr = g_qd / pdf;
  const float g_pdf = -(g_sp * sp) / pdf - (g_qd * q) / pdf;
  return SaBcGrad{g_sp / pdf, g_dr * m.rd, g_hk1, g_pdf, g_md,
                  g_rs - g_bd * q, g_dr * diff, scale(g_s, b_d), scale(g_s, b_s)};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The block's partial row ``part`` + blockIdx.x * rows is written (by
// every thread): the last block to finish sums the grid's rows in block
// order into ``out``, a fixed order whichever block it is. ``done`` counts
// the finished blocks (zeroed by the wrapper).
__device__ __forceinline__ void sum_rows(const float* part, float* out, int* done, int rows) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) s += __ldcg(part + b * rows + e);
    out[e] = s;
  }
}

// ------------------------------------------------------------- K12 bwd --

// K12 bwd's pointer slots, in the order of ops/cuda_shade.py::SHADE_BWD_PTRS.
enum BwdPtr {
  // what the forward read of a lane
  I_OX, I_OY, I_OZ, I_DX, I_DY, I_DZ, I_CX, I_CY, I_CZ,
  I_ALIVE, I_ADDED, I_T, I_FACE, I_U, I_V, I_OCC, I_KEY,
  // faces (the corner, the vertex normals and the flat flags: Phong), materials, lights
  F_MTL, F_E1X, F_E1Y, F_E1Z, F_E2X, F_E2Y, F_E2Z, F_V0X, F_V0Y, F_V0Z,
  F_N0X, F_N0Y, F_N0Z, F_N1X, F_N1Y, F_N1Z, F_N2X, F_N2Y, F_N2Z, F_FLAT,
  M_D, M_NI, M_ROUGH, M_P, M_NU, M_NV, M_RS, M_RD, M_KDX, M_KDY, M_KDZ, M_KSX, M_KSY, M_KSZ,
  L_PX, L_PY, L_PZ, L_RX, L_RY, L_RZ, L_RAD, L_TYPE,
  // the outputs' gradients
  G_OX, G_OY, G_OZ, G_DX, G_DY, G_DZ, G_CX, G_CY, G_CZ, G_LX, G_LY, G_LZ, G_FX, G_FY, G_FZ,
  // the inputs' gradients written
  D_OX, D_OY, D_OZ, D_DX, D_DY, D_DZ, D_CX, D_CY, D_CZ, D_LX, D_LY, D_LZ, D_T,
  // the warps' rows where they do not fit in shared memory (else null), the
  // blocks' partial table rows, the table gradient, the finished blocks
  W_TABLE, P_TABLE, O_TABLE, C_DONE,
  kBwdPtrs
};

// K12 bwd's int arguments, in the order of ops/cuda_shade.py.
enum BwdInt { A_N, A_SAMPLE, A_DEPTH, A_MAX_DEPTH, A_MAX_ADDED, A_LIGHTS, A_MATS, A_BLOCKS,
              kBwdInts };

struct BwdArgs {
  const void* p[kBwdPtrs];
  int i[kBwdInts];
  float alpha;  // the Phong tessellation
};

template <typename T>
__device__ __forceinline__ T ld(const BwdArgs& a, int slot, int k) {
  return static_cast<const T*>(a.p[slot])[k];
}
__device__ __forceinline__ V3 ld3(const BwdArgs& a, int slot, int k) {
  return V3{ld<float>(a, slot, k), ld<float>(a, slot + 1, k), ld<float>(a, slot + 2, k)};
}
__device__ __forceinline__ void st(const BwdArgs& a, int slot, int k, float v) {
  static_cast<float*>(const_cast<void*>(a.p[slot]))[k] = v;
}
__device__ __forceinline__ void st3(const BwdArgs& a, int slot, int k, V3 v) {
  st(a, slot, k, v.x);
  st(a, slot + 1, k, v.y);
  st(a, slot + 2, k, v.z);
}

// A lane's terms of the table gradients (shade_vjp_terms' TableTerms).
struct Terms {
  float mat[14];  // the material's fields, SHADE_TABLE order
  int midx;
  bool live;
  bool lit;    // NEE lit the lane: light 0's position has a term
  V3 pos;      // light 0's position
  V3 rgb;      // light rgb_light's colour
  int rgb_light;
};

template <int BRDF, bool NEE, bool TRANS, bool PHONG>
__device__ __forceinline__ void lane_bwd(const BwdArgs& a, int k, Terms& tm) {
  const int depth = a.i[A_DEPTH];
  const V3 o = ld3(a, I_OX, k);
  const V3 d = ld3(a, I_DX, k);
  bool alive = ld<bool>(a, I_ALIVE, k);
  const float t = ld<float>(a, I_T, k);
  const bool finite = isfinite(t);
  const bool hit = finite && alive;
  const bool miss = alive && !finite;
  alive = alive && !miss;
  const int added = ld<int>(a, I_ADDED, k);
  const V3 go = ld3(a, G_OX, k), gd = ld3(a, G_DX, k), gc = ld3(a, G_CX, k);
  const V3 gl = ld3(a, G_LX, k);

  // ---- miss: the light value goes to the orb's colour -------------------
  if (miss) {
    int orb = -1;  // _orb_pass: the last orb hit in light order wins
    for (int i = 0; i < a.i[A_LIGHTS]; ++i) {
      if (ld<int>(a, L_TYPE, i) == 2 &&
          sphere_hit(o, d, ld3(a, L_PX, i), ld<float>(a, L_RAD, i))) {
        orb = i;
      }
    }
    if (orb >= 0) {
      tm.rgb = gl;
      tm.rgb_light = orb;
    }
  }

  // ---- material, extension decision, last-bounce break ----------------
  const int face = max(ld<int>(a, I_FACE, k), 0);
  const BounceRng rb(ld<long long>(a, I_KEY, k), a.i[A_SAMPLE], depth);
  Mat m{};
  bool live = false;
  int mi = 0;
  if (hit) {
    mi = ld<int>(a, F_MTL, face);
    m.d = ld<float>(a, M_D, mi);
    m.ni = ld<float>(a, M_NI, mi);
    m.rough = ld<float>(a, M_ROUGH, mi);
    m.p = ld<float>(a, M_P, mi);
    m.nu = ld<float>(a, M_NU, mi);
    m.nv = ld<float>(a, M_NV, mi);
    m.rs = ld<float>(a, M_RS, mi);
    m.rd = ld<float>(a, M_RD, mi);
    m.kd = ld3(a, M_KDX, mi);
    m.ks = ld3(a, M_KSX, mi);
    const bool extend = BRDF == kSchlick ? m.rough < rb.u(kExtend) : tmax(m.nu, m.nv) >= 50.0f;
    const bool is_last = depth == a.i[A_MAX_DEPTH] + added - 1;
    live = alive && !(m.d == 1.0f && !extend && is_last);
  }

  V3 d_o = go, d_d = gd, d_c = gc;
  float d_t = 0.0f;
  if (live) {
    const V3 color = ld3(a, I_CX, k);
    const V3 hit_p = add(o, scale(d, t));
    const V3 e1 = ld3(a, F_E1X, face), e2 = ld3(a, F_E2X, face);
    V3 normal = normalized(cross(e1, e2));
    if (PHONG && !ld<bool>(a, F_FLAT, face)) {
      normal = phong_normal(ld3(a, F_V0X, face), e1, e2, ld3(a, F_N0X, face),
                            ld3(a, F_N1X, face), ld3(a, F_N2X, face), a.alpha, d,
                            ld<float>(a, I_U, k), ld<float>(a, I_V, k));
    }
    const V3 n_sh = dot(normal, neg(d)) <= 0.0f ? neg(normal) : normal;
    const float ra = rb.u(kBrdfA), rbb = rb.u(kBrdfB), rc = rb.u(kBrdfC);
    V3 new_d = BRDF == kSchlick ? schlick_sample(d, normal, m.rough, m.p, ra, rbb, rc)
                                : sa_sample(d, normal, m.d, m.nu, m.nv, ra, rbb, rc);
    if (TRANS && m.d < 1.0f && m.d <= rb.u(kTrans)) {
      new_d = refract_dir(d, normal, m.ni, rb.u(kRefr));
    }

    // ---- throughput: color' = color * mult ------------------------------
    float mt[14] = {};
    V3 g_color, g_d;
    if (BRDF == kSchlick) {
      const SchlickEval e = schlick_eval(n_sh, d, new_d, m.rough, m.p);
      const bool pok = fabsf(e.pdf) > 1.0e-7f;
      const float pdf_bs = pok ? e.pdf : 1.0f;
      const float cl_b = clamp_min0(dot(n_sh, new_d));
      const float w_b = e.brdf * cl_b / pdf_bs;
      const V3 inner = adds(scale(scale(fresnel3(e.u, m.ks), w_b), m.d), 1.0f - m.d);
      const V3 mult0 = mul(m.kd, inner);
      const V3 g_m0 = finite_g(mult0, mul(gc, color));
      V3 g_ks;
      float g_w, g_md;
      const float g_ub = schlick_inner_vjp(e.u, m.ks, w_b, m.d, mul(g_m0, m.kd), g_ks, g_w, g_md);
      const float g_pdf = pok ? -(g_w * w_b) / pdf_bs : 0.0f;
      const EvalGrad ge = schlick_eval_vjp(n_sh, d, new_d, m.rough, m.p, g_w / pdf_bs * cl_b,
                                           g_ub, g_pdf);
      const V3 g_kd = mul(g_m0, inner);
      mt[0] = g_md, mt[2] = ge.a, mt[3] = ge.b;
      mt[8] = g_kd.x, mt[9] = g_kd.y, mt[10] = g_kd.z;
      mt[11] = g_ks.x, mt[12] = g_ks.y, mt[13] = g_ks.z;
      g_color = mul(gc, sanitize3(mult0));
      g_d = ge.d_out;
    } else {
      const SaEval e = sa_eval(n_sh, d, new_d, m.nu, m.nv);
      const bool pok = fabsf(e.pdf) > 1.0e-7f;
      const float pdf_bs = pok ? e.pdf : 1.0f;
      const float b_s = (e.spec / pdf_bs) * fresnel(e.hk1, m.rs);
      const float b_d = (e.diff * m.rd / pdf_bs) * (1.0f - m.rs);
      const V3 bcc = norm_clip(adds(scale(add(scale(m.ks, b_s), scale(m.kd, b_d)), m.d),
                                    1.0f - m.d));
      const SaBcGrad gb = sa_bc_vjp(e.spec, e.diff, e.hk1, pdf_bs, m,
                                    finite_g(bcc, mul(gc, color)));
      const EvalGrad ge = sa_eval_vjp(n_sh, d, new_d, m.nu, m.nv, gb.spec, gb.diff, gb.hk1,
                                      pok ? gb.pdf : 0.0f);
      mt[0] = gb.md, mt[4] = ge.a, mt[5] = ge.b, mt[6] = gb.rs, mt[7] = gb.rd;
      mt[8] = gb.kd.x, mt[9] = gb.kd.y, mt[10] = gb.kd.z;
      mt[11] = gb.ks.x, mt[12] = gb.ks.y, mt[13] = gb.ks.z;
      g_color = mul(gc, sanitize3(bcc));
      g_d = ge.d_out;
    }
    V3 g_hp = go;

    // ---- NEE: final' = final + sanitize(contrib) on the lanes it lights --
    if (NEE) {
      const V3 l_vec = sub(ld3(a, L_PX, 0), hit_p);
      const float l2 = dot(l_vec, l_vec);
      const float t_light = safe_sqrt(l2);
      const float inv = fabsf(t_light) > 1.0e-12f ? 1.0f / t_light : 0.0f;  // safe_div(1, t)
      const V3 l_dir = scale(l_vec, inv);
      const V3 l_rgb = ld3(a, L_RX, 0);
      const V3 gf = ld3(a, G_FX, k);
      float nt[14] = {};
      bool ok = false;
      V3 g_dn{0.0f, 0.0f, 0.0f}, g_ldir{0.0f, 0.0f, 0.0f}, g_cn{0.0f, 0.0f, 0.0f};
      V3 g_lrgb{0.0f, 0.0f, 0.0f};
      if (m.d > 0.0f && !ld<bool>(a, I_OCC, k)) {
        if (BRDF == kSchlick) {
          const SchlickEval e = schlick_eval(n_sh, d, l_dir, m.rough, m.p);
          ok = fabsf(e.pdf) > 1.0e-5f;
          if (ok) {
            const float x_l = dot(n_sh, l_dir);
            const float w_l = e.brdf * clamp_min0(x_l) / e.pdf;
            const V3 inner = adds(scale(scale(fresnel3(e.u, m.ks), w_l), m.d), 1.0f - m.d);
            const V3 c1 = mul(color, l_rgb);
            const V3 c2 = mul(c1, m.kd);
            const V3 g_c = finite_g(mul(c2, inner), gf);
            const V3 g_c2 = mul(g_c, inner);
            const V3 g_c1 = mul(g_c2, m.kd);
            V3 g_ks;
            float g_w, g_md;
            const float g_ul = schlick_inner_vjp(e.u, m.ks, w_l, m.d, mul(g_c, c2), g_ks, g_w,
                                                 g_md);
            const float g_bc = g_w / e.pdf;
            const EvalGrad ge = schlick_eval_vjp(n_sh, d, l_dir, m.rough, m.p,
                                                 g_bc * clamp_min0(x_l), g_ul,
                                                 -(g_w * w_l) / e.pdf);
            g_ldir = add(ge.d_in, scale(n_sh, x_l >= 0.0f ? g_bc * e.brdf : 0.0f));
            g_dn = ge.d_out;
            g_cn = mul(g_c1, l_rgb);
            g_lrgb = mul(g_c1, color);
            const V3 g_kd = mul(g_c2, c1);
            nt[0] = g_md, nt[2] = ge.a, nt[3] = ge.b;
            nt[8] = g_kd.x, nt[9] = g_kd.y, nt[10] = g_kd.z;
            nt[11] = g_ks.x, nt[12] = g_ks.y, nt[13] = g_ks.z;
          }
        } else {
          const SaEval e = sa_eval(n_sh, d, l_dir, m.nu, m.nv);
          ok = fabsf(e.pdf) > 1.0e-5f;
          if (ok) {
            const float b_s = (e.spec / e.pdf) * fresnel(e.hk1, m.rs);
            const float b_d = (e.diff * m.rd / e.pdf) * (1.0f - m.rs);
            const V3 bcc = norm_clip(adds(scale(add(scale(m.ks, b_s), scale(m.kd, b_d)), m.d),
                                          1.0f - m.d));
            const V3 bl = mul(bcc, l_rgb);
            const V3 g_c = finite_g(adds(scale(bl, m.d), 1.0f - m.d), gf);
            const V3 g_bl = scale(g_c, m.d);
            const SaBcGrad gb = sa_bc_vjp(e.spec, e.diff, e.hk1, e.pdf, m, mul(g_bl, l_rgb));
            const EvalGrad ge = sa_eval_vjp(n_sh, d, l_dir, m.nu, m.nv, gb.spec, gb.diff,
                                            gb.hk1, gb.pdf);
            g_ldir = ge.d_in;
            g_dn = ge.d_out;
            g_lrgb = mul(g_bl, bcc);
            nt[0] = gb.md + (sum3(mul(g_c, bl)) - sum3(g_c));
            nt[4] = ge.a, nt[5] = ge.b, nt[6] = gb.rs, nt[7] = gb.rd;
            nt[8] = gb.kd.x, nt[9] = gb.kd.y, nt[10] = gb.kd.z;
            nt[11] = gb.ks.x, nt[12] = gb.ks.y, nt[13] = gb.ks.z;
          }
        }
      }
      // l_dir = l_vec * safe_div(1, t_light), t_light = safe_sqrt(l_vec . l_vec)
      V3 g_lvec{0.0f, 0.0f, 0.0f};
      if (ok) {
        const float g_tl = fabsf(t_light) > 1.0e-12f ? dot(g_ldir, l_vec) * -(inv * inv) : 0.0f;
        const float g_l2 = l2 > 0.0f ? g_tl / (2.0f * t_light) : 0.0f;
        g_lvec = add(scale(g_ldir, inv), scale(l_vec, g_l2 * 2.0f));
        tm.lit = true;
        tm.rgb = g_lrgb;
        tm.rgb_light = 0;
      }
      if (BRDF == kSchlick) g_color = add(g_color, g_cn);
      g_d = add(g_d, g_dn);
      g_hp = sub(g_hp, g_lvec);
#pragma unroll
      for (int f = 0; f < 14; ++f) mt[f] = mt[f] + nt[f];
      tm.pos = g_lvec;
    }

    // ---- the hit point o + d t ------------------------------------------
    g_d = add(g_d, scale(g_hp, t));
    d_t = dot(g_hp, d);
    d_o = g_hp;
    d_d = g_d;
    d_c = g_color;
    tm.live = true;
    tm.midx = mi;
#pragma unroll
    for (int f = 0; f < 14; ++f) tm.mat[f] = mt[f];
  }
  st3(a, D_OX, k, d_o);
  st3(a, D_DX, k, d_d);
  st3(a, D_CX, k, d_c);
  st3(a, D_LX, k, miss ? V3{0.0f, 0.0f, 0.0f} : gl);
  st(a, D_T, k, d_t);
}

// A warp's lanes' terms added into its row ``mine`` of shared memory (the
// table's layout: 14 rows of nm, then 6 of nl): a material, then a light,
// at a time, each a butterfly of shuffles.
template <bool NEE>
__device__ __forceinline__ void warp_add(float* mine, const Terms& tm, int nm, int nl) {
  const bool lead = (threadIdx.x & 31) == 0;
  unsigned todo = __ballot_sync(kFull, tm.live);
  while (todo) {
    const int j = __shfl_sync(kFull, tm.midx, __ffs(todo) - 1);
    const bool take = tm.live && tm.midx == j;
#pragma unroll
    for (int f = 0; f < 14; ++f) {
      const float v = warp_sum(take ? tm.mat[f] : 0.0f);
      if (lead) mine[f * nm + j] += v;
    }
    todo &= ~__ballot_sync(kFull, take);
  }
  if (NEE && __any_sync(kFull, tm.lit)) {
    const float p[3] = {tm.pos.x, tm.pos.y, tm.pos.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = warp_sum(tm.lit ? p[c] : 0.0f);
      if (lead) mine[14 * nm + c * nl] += v;
    }
  }
  todo = __ballot_sync(kFull, tm.rgb_light >= 0);
  while (todo) {
    const int j = __shfl_sync(kFull, tm.rgb_light, __ffs(todo) - 1);
    const bool take = tm.rgb_light == j;
    const float c3[3] = {tm.rgb.x, tm.rgb.y, tm.rgb.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = warp_sum(take ? c3[c] : 0.0f);
      if (lead) mine[14 * nm + (3 + c) * nl + j] += v;
    }
    todo &= ~__ballot_sync(kFull, take);
  }
}

template <int BRDF, bool NEE, bool TRANS, bool PHONG>
__global__ void __launch_bounds__(kThreads) shade_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem_rows[];  // [kWarps][rows], where they fit
  const int n = a.i[A_N], nm = a.i[A_MATS], nl = a.i[A_LIGHTS];
  const int rows = 14 * nm + 6 * nl;
  float* wpart = a.p[W_TABLE] == nullptr
                     ? smem_rows
                     : static_cast<float*>(const_cast<void*>(a.p[W_TABLE])) +
                           static_cast<size_t>(blockIdx.x) * kWarps * rows;
  float* mine = wpart + (threadIdx.x >> 5) * rows;
  for (int e = threadIdx.x & 31; e < rows; e += 32) mine[e] = 0.0f;
  __syncwarp();
  for (int base = blockIdx.x * kThreads; base < n; base += gridDim.x * kThreads) {
    const int k = base + threadIdx.x;
    Terms tm{};
    tm.rgb_light = -1;
    if (k < n) lane_bwd<BRDF, NEE, TRANS, PHONG>(a, k, tm);
    warp_add<NEE>(mine, tm, nm, nl);
  }
  __syncthreads();
  float* part = static_cast<float*>(const_cast<void*>(a.p[P_TABLE]));
  for (int e = threadIdx.x; e < rows; e += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += wpart[w * rows + e];
    part[blockIdx.x * rows + e] = s;
  }
  sum_rows(part, static_cast<float*>(const_cast<void*>(a.p[O_TABLE])),
           static_cast<int*>(const_cast<void*>(a.p[C_DONE])), rows);
}

template <int BRDF, bool NEE, bool TRANS, bool PHONG>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int rows = 14 * a.i[A_MATS] + 6 * a.i[A_LIGHTS];
  const int smem =
      a.p[W_TABLE] == nullptr ? kWarps * rows * static_cast<int>(sizeof(float)) : 0;
  // The dynamic shared memory the instance is allowed so far, per device
  // (the attribute is a device's); above kMaxDevices it is set every time.
  constexpr int kMaxDevices = 16;
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev < kMaxDevices;
  if (smem > kSmemDefault && (!known || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(shade_bwd_kernel<BRDF, NEE, TRANS, PHONG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (known) smem_set[dev] = smem;
  }
  shade_bwd_kernel<BRDF, NEE, TRANS, PHONG><<<a.i[A_BLOCKS], kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BRDF, bool NEE, bool TRANS>
cudaError_t bwd_by_phong(bool phong, const BwdArgs& a, cudaStream_t s) {
  return phong ? launch_bwd<BRDF, NEE, TRANS, true>(a, s)
               : launch_bwd<BRDF, NEE, TRANS, false>(a, s);
}

template <int BRDF, bool NEE>
cudaError_t bwd_by_trans(bool trans, bool phong, const BwdArgs& a, cudaStream_t s) {
  return trans ? bwd_by_phong<BRDF, NEE, true>(phong, a, s)
               : bwd_by_phong<BRDF, NEE, false>(phong, a, s);
}

template <int BRDF>
cudaError_t bwd_by_nee(bool nee, bool trans, bool phong, const BwdArgs& a, cudaStream_t s) {
  return nee ? bwd_by_trans<BRDF, true>(trans, phong, a, s)
             : bwd_by_trans<BRDF, false>(trans, phong, a, s);
}

// ------------------------------------------------------------- K11 bwd --

// K11 bwd's pointer slots, in the order of ops/cuda_shade.py::GEN_BWD_PTRS.
enum GenBwdPtr {
  G_PX, G_PY, G_KEY, G_PREV_T,
  G_EYEX, G_EYEY, G_EYEZ, G_WX, G_WY, G_WZ, G_UX, G_UY, G_UZ, G_VX, G_VY, G_VZ,
  G_FOCAL, G_APERTURE, G_FOCUS,
  G_GOX, G_GOY, G_GOZ, G_GDX, G_GDY, G_GDZ,
  P_CAMERA, O_CAMERA, C_CAMERA_DONE,
  kGenBwdPtrs
};
enum GenFloat { C_FX, C_FY, C_HALF_PX, C_AA, kGenFloats };
constexpr int kCamera = 15;

struct GenBwdArgs {
  const void* p[kGenBwdPtrs];
  int n, sample;
  float f[kGenFloats];
};

__device__ __forceinline__ float gf(const GenBwdArgs& a, int slot, int k) {
  return static_cast<const float*>(a.p[slot])[k];
}
__device__ __forceinline__ V3 gv(const GenBwdArgs& a, int slot, int k) {
  return V3{gf(a, slot, k), gf(a, slot + 1, k), gf(a, slot + 2, k)};
}

// One lane's 15 camera terms (gen_rays_vjp_terms), in CAMERA_FIELDS order.
__device__ __forceinline__ void gen_lane_bwd(const GenBwdArgs& a, int k, float* tm) {
  const V3 eye = gv(a, G_EYEX, 0), cw = gv(a, G_WX, 0), cu = gv(a, G_UX, 0),
           cv = gv(a, G_VX, 0);
  const float half_px = a.f[C_HALF_PX];
  const float fx = a.f[C_FX] + 2.0f * gf(a, G_PX, k);
  const float fy = a.f[C_FY] + 2.0f * gf(a, G_PY, k);
  const V3 q = add(cw, scale(add(scale(cu, fx), scale(cv, fy)), half_px));
  const V3 d0 = normalized(q);
  const BounceRng r0(static_cast<const long long*>(a.p[G_KEY])[k], a.sample, 0);
  const float rnd = r0.u(kAaR);
  const float phi = kTwoPi * r0.u(kAaPhi);
  const float sina = sqrtf(rnd), cosa = sqrtf(1.0f - rnd);
  const V3 q1 = add(d0, scale(jitter(d0, phi, sina, cosa), a.f[C_AA]));
  const V3 d1 = normalized(q1);
  const float prev_t = gf(a, G_PREV_T, k);
  const float t_obj = isfinite(prev_t) ? prev_t : 1000.0f;
  const float focus = gf(a, G_FOCUS, 0);
  const bool fin = isfinite(focus);
  const float t_foc = fin ? focus : 1000.0f;
  const float aperture = gf(a, G_APERTURE, 0);
  const float lens = gf(a, G_FOCAL, 0) / aperture;
  const float u_r = r0.u(kDofR);
  const float radius = u_r * lens * 0.5f;
  const float angle = kTwoPi * r0.u(kDofPhi);
  const float ca = cosf(angle), sa = sinf(angle);
  const V3 o_dof = add(add(eye, scale(cu, radius * ca)), scale(cv, radius * sa));
  const V3 q2 = sub(add(eye, scale(d1, t_foc)), o_dof);
  const bool use = focus >= 0.0f && t_obj > 0.0f;
  const V3 zero{0.0f, 0.0f, 0.0f};
  const V3 go = gv(a, G_GOX, k), gd = gv(a, G_GDX, k);
  // The lens: o' = o_dof, d' = normalized(eye + d1 t_foc - o_dof).
  const V3 g_q2 = normalized_vjp(q2, use ? gd : zero);
  const V3 g_od = sub(use ? go : zero, g_q2);
  const V3 g_eye = use ? add(g_q2, g_od) : go;
  const V3 g_d1 = use ? scale(g_q2, t_foc) : gd;
  const float g_rad = dot(g_od, cu) * ca + dot(g_od, cv) * sa;
  const float g_lens = g_rad * 0.5f * u_r;
  const float g_focus = use && fin ? dot(g_q2, d1) : 0.0f;
  const float g_focal = use ? g_lens / aperture : 0.0f;
  const float g_aperture = use ? -(g_lens * lens) / aperture : 0.0f;
  // The jitter and the pinhole.
  const V3 g_q1 = normalized_vjp(q1, g_d1);
  const V3 g_q = normalized_vjp(q, add(g_q1, jitter_vjp(d0, phi, sina, cosa,
                                                        scale(g_q1, a.f[C_AA]))));
  const V3 g_t3 = scale(g_q, half_px);
  const V3 g_u = add(scale(g_t3, fx), scale(g_od, radius * ca));
  const V3 g_v = add(scale(g_t3, fy), scale(g_od, radius * sa));
  const float out[kCamera] = {g_eye.x, g_eye.y, g_eye.z, g_q.x, g_q.y, g_q.z, g_u.x, g_u.y,
                              g_u.z, g_v.x, g_v.y, g_v.z, g_focal, g_aperture, g_focus};
#pragma unroll
  for (int f = 0; f < kCamera; ++f) tm[f] = out[f];
}

__global__ void __launch_bounds__(kThreads) gen_rays_bwd_kernel(const GenBwdArgs a) {
  __shared__ float wpart[kWarps][kCamera];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) < kCamera) wpart[warp][threadIdx.x & 31] = 0.0f;
  __syncwarp();
  for (int base = blockIdx.x * kThreads; base < a.n; base += gridDim.x * kThreads) {
    const int k = base + threadIdx.x;
    float tm[kCamera] = {};
    if (k < a.n) gen_lane_bwd(a, k, tm);
#pragma unroll
    for (int f = 0; f < kCamera; ++f) {
      const float v = warp_sum(tm[f]);
      if ((threadIdx.x & 31) == 0) wpart[warp][f] += v;
    }
  }
  __syncthreads();
  float* part = static_cast<float*>(const_cast<void*>(a.p[P_CAMERA]));
  if (threadIdx.x < kCamera) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += wpart[w][threadIdx.x];
    part[blockIdx.x * kCamera + threadIdx.x] = s;
  }
  sum_rows(part, static_cast<float*>(const_cast<void*>(a.p[O_CAMERA])),
           static_cast<int*>(const_cast<void*>(a.p[C_CAMERA_DONE])), kCamera);
}

}  // namespace

extern "C" {

// K12 bwd over n lanes: ptrs and ints in the orders of BwdPtr and BwdInt
// (A_BLOCKS: the grid, the partial rows P_TABLE holds; W_TABLE null, or
// A_BLOCKS x 8 rows of scratch where a block's rows do not fit in shared
// memory; C_DONE an int zeroed); brdf 0 Schlick, 1 Shirley-Ashikhmin;
// alpha the Phong tessellation where phong. Returns the launch's cudaError.
int pbr_shade_bwd(const void* const* ptrs, const int* ints, float alpha, int brdf, int nee,
                  int trans, int phong, void* stream) {
  BwdArgs a;
  for (int i = 0; i < kBwdPtrs; ++i) a.p[i] = ptrs[i];
  for (int i = 0; i < kBwdInts; ++i) a.i[i] = ints[i];
  a.alpha = alpha;
  if (a.i[A_BLOCKS] < 1 || a.i[A_MATS] < 1 || (nee && a.i[A_LIGHTS] < 1)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ne = nee != 0, tr = trans != 0, ph = phong != 0;
  return static_cast<int>(brdf == kSchlick ? bwd_by_nee<kSchlick>(ne, tr, ph, a, s)
                                           : bwd_by_nee<1>(ne, tr, ph, a, s));
}

// K11 bwd over n lanes: ptrs and floats in the orders of GenBwdPtr and
// GenFloat (C_CAMERA_DONE an int zeroed); blocks partial rows of the 15
// camera terms, then their sum.
int pbr_gen_rays_bwd(const void* const* ptrs, int n, int sample, int blocks, const float* floats,
                     void* stream) {
  GenBwdArgs a;
  for (int i = 0; i < kGenBwdPtrs; ++i) a.p[i] = ptrs[i];
  a.n = n;
  a.sample = sample;
  for (int i = 0; i < kGenFloats; ++i) a.f[i] = floats[i];
  if (blocks < 1) return cudaErrorInvalidValue;
  gen_rays_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
