// The frame's elementwise shading for Hopper (sm_90a): kernels K11 (camera
// rays) and K12 (shade), forward only.
//
// They replace no Pallas kernel. The JAX package runs the whole frame as one
// XLA program, and XLA fuses the elementwise work of trace_rays into a few
// loops: K11 is the port of XLA's fusion of
// pbr_tpu/models/integrator.py::_gen_rays (:287), K12 of the bounce's shade
// (:579-833, with _orb_pass at :324). Without them the port ran that work as
// some 1,300 ATen launches a bounce, each one pass over 1M-lane tensors.
//
// K11 (gen_rays_kernel): pinhole, AA jitter and thin-lens DoF, one launch
// a sample, as ops/cuda_shade.py::gen_rays_plain.
//
// K12 (shade_kernel<BRDF, NEE, TRANS, PHONG, MODE>): everything of a
// bounce after the search (ops/cuda_shade.py::shade_plain): the orb pass,
// miss with sky and orb emission, the material gather by index (the plain
// version's select chain picks the same table entries), the geometric or
// Phong shading normal, the extension decision, the last-bounce break and
// the hit point, NEE's shadow ray and contribution given the occluded bit,
// the BRDF sample with the refraction branch, the throughput, the depth
// budget, Russian roulette and the advance. One template over BRDF x NEE x
// transparency x Phong; MODE picks the instance:
//   - kFused ("K12"): one launch a bounce; the occluded bit comes from the
//     search (K1, K6 NEE, K7 NEE), or there is no NEE;
//   - kPre ("K12 pre"): writes the shadow ray (hit point, direction, light
//     distance, the casting lanes) for a shadow leg that is a walk of its
//     own (K3 any-hit, K8 any-hit, K9 any-hit);
//   - kPost ("K12 post"): the fused code over the walk's occluded bit: it
//     recomputes what kPre computed, bitwise the same.
//
// What bounds them on this card: bytes. A bounce reads a lane's state once
// (o, d, colour, light value, final colour: 60 B; alive, found, depth
// budget, secondary count: 10 B; t, face, the occluded bit: 9 B; the
// 8-byte RNG key) and writes it once (70 B and the casting bit): about 160
// B a lane, 0.05 ms at 1M lanes over 3.35 TB/s; the face, material and
// light tables are gathered through the cache. The arithmetic is a few
// hundred float32 operations a hit lane, below the byte bound even at the
// 33.5 T op/s that --fmad=false leaves. The design: one thread a lane,
// 256 lanes a block; what the plain version computes for every lane and
// then discards by a select, a lane computes only where its select keeps
// it (a missed lane runs the orb pass and nothing of the hit; a lane that
// casts no shadow ray evaluates no light). K11 reads 20 B and writes 24 B
// a lane.
//
// Numerics as the other kernels (--fmad=false, IEEE division and sqrtf,
// vec.cuh, brdf.cuh, rng.cuh): every operation rounds as torch's op does,
// so both kernels are bitwise their plain versions on the card.

#include <cuda_runtime.h>
#include <math.h>

#include "brdf.cuh"
#include "rng.cuh"
#include "vec.cuh"

namespace {

using namespace pbr::shade;

constexpr int kThreads = 256;
constexpr int kSchlick = 0;  // utils/config.py::BRDF_SCHLICK; 1 is Shirley-Ashikhmin
constexpr int kFused = 0, kPre = 1, kPost = 2;

// K12's pointer slots, in the order of ops/cuda_shade.py::SHADE_PTRS.
enum ShadePtr {
  // the lane state read (o, d, colour, light value, final colour; flags)
  I_OX, I_OY, I_OZ, I_DX, I_DY, I_DZ, I_CX, I_CY, I_CZ, I_LX, I_LY, I_LZ, I_FX, I_FY, I_FZ,
  I_ALIVE, I_FOUND, I_ADDED, I_SECONDARY,
  // the search's result and the RNG key
  I_T, I_FACE, I_U, I_V, I_OCC, I_KEY,
  // faces
  F_MTL, F_E1X, F_E1Y, F_E1Z, F_E2X, F_E2Y, F_E2Z, F_V0X, F_V0Y, F_V0Z,
  F_N0X, F_N0Y, F_N0Z, F_N1X, F_N1Y, F_N1Z, F_N2X, F_N2Y, F_N2Z, F_FLAT,
  // materials
  M_D, M_NI, M_ROUGH, M_P, M_NU, M_NV, M_RS, M_RD, M_KDX, M_KDY, M_KDZ, M_KSX, M_KSY, M_KSZ,
  // lights
  L_PX, L_PY, L_PZ, L_RX, L_RY, L_RZ, L_RAD, L_TYPE,
  // the lane state written, the casting lanes, the shadow ray
  O_OX, O_OY, O_OZ, O_DX, O_DY, O_DZ, O_CX, O_CY, O_CZ, O_LX, O_LY, O_LZ, O_FX, O_FY, O_FZ,
  O_ALIVE, O_FOUND, O_ADDED, O_SECONDARY, O_CASTS,
  O_HPX, O_HPY, O_HPZ, O_LDX, O_LDY, O_LDZ, O_TLIGHT,
  kShadePtrs
};

// K12's int and float arguments, in the order of ops/cuda_shade.py.
enum ShadeInt { A_N, A_SAMPLE, A_DEPTH, A_MAX_DEPTH, A_MAX_ADDED, A_LIGHTS, kShadeInts };
enum ShadeFloat { A_SKYX, A_SKYY, A_SKYZ, A_ALPHA, kShadeFloats };

struct ShadeArgs {
  const void* p[kShadePtrs];
  int i[kShadeInts];
  float f[kShadeFloats];
};

template <typename T>
__device__ __forceinline__ T ld(const ShadeArgs& a, int slot, int k) {
  return static_cast<const T*>(a.p[slot])[k];
}
template <typename T>
__device__ __forceinline__ void st(const ShadeArgs& a, int slot, int k, T v) {
  static_cast<T*>(const_cast<void*>(a.p[slot]))[k] = v;
}
__device__ __forceinline__ V3 ld3(const ShadeArgs& a, int slot, int k) {
  return V3{ld<float>(a, slot, k), ld<float>(a, slot + 1, k), ld<float>(a, slot + 2, k)};
}
__device__ __forceinline__ void st3(const ShadeArgs& a, int slot, int k, V3 v) {
  st<float>(a, slot, k, v.x);
  st<float>(a, slot + 1, k, v.y);
  st<float>(a, slot + 2, k, v.z);
}

// The Phong shading normal (brdf.cuh) of face f at the winner's (u, v).
__device__ __forceinline__ V3 phong_normal(const ShadeArgs& a, int f, V3 e1, V3 e2, V3 d,
                                           float u, float v) {
  return pbr::shade::phong_normal(ld3(a, F_V0X, f), e1, e2, ld3(a, F_N0X, f),
                                  ld3(a, F_N1X, f), ld3(a, F_N2X, f), a.f[A_ALPHA], d, u, v);
}

template <int BRDF, bool NEE, bool TRANS, bool PHONG, int MODE>
__global__ void __launch_bounds__(kThreads) shade_kernel(const ShadeArgs a) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= a.i[A_N]) return;
  const int depth = a.i[A_DEPTH];
  const int max_depth = a.i[A_MAX_DEPTH];

  const V3 o = ld3(a, I_OX, k);
  const V3 d = ld3(a, I_DX, k);
  bool alive = ld<bool>(a, I_ALIVE, k);
  const float t = ld<float>(a, I_T, k);
  const bool finite = isfinite(t);
  const bool hit = finite && alive;
  const bool miss = alive && !finite;
  alive = alive && !miss;
  int added = ld<int>(a, I_ADDED, k);

  // ---- miss: sky or orb emission (pathtracing.cl:263-266) -------------
  V3 light_val = ld3(a, I_LX, k);
  if (MODE != kPre && miss) {
    int orb = -1;  // _orb_pass: the last orb hit in light order wins
    for (int i = 0; i < a.i[A_LIGHTS]; ++i) {
      if (ld<int>(a, L_TYPE, i) == 2 &&
          sphere_hit(o, d, ld3(a, L_PX, i), ld<float>(a, L_RAD, i))) {
        orb = i;
      }
    }
    light_val = orb >= 0 ? ld3(a, L_RX, orb) : V3{a.f[A_SKYX], a.f[A_SKYY], a.f[A_SKYZ]};
  }

  // ---- material, extension decision, last-bounce break ----------------
  const int face = max(ld<int>(a, I_FACE, k), 0);
  const BounceRng rb(ld<long long>(a, I_KEY, k), a.i[A_SAMPLE], depth);
  Mat m{};
  bool extend = false, live = false;
  if (hit) {
    const int mi = ld<int>(a, F_MTL, face);
    m.d = ld<float>(a, M_D, mi);
    if (BRDF == kSchlick) {
      m.rough = ld<float>(a, M_ROUGH, mi);
      extend = m.rough < rb.u(kExtend);
    } else {
      m.nu = ld<float>(a, M_NU, mi);
      m.nv = ld<float>(a, M_NV, mi);
      extend = tmax(m.nu, m.nv) >= 50.0f;
    }
    const bool is_last = depth == max_depth + added - 1;
    alive = alive && !(m.d == 1.0f && !extend && is_last);
    live = alive;  // hit && alive
    if (MODE != kPre) {
      m.ni = ld<float>(a, M_NI, mi);
      m.p = ld<float>(a, M_P, mi);
      m.rs = ld<float>(a, M_RS, mi);
      m.rd = ld<float>(a, M_RD, mi);
      m.kd = ld3(a, M_KDX, mi);
      m.ks = ld3(a, M_KSX, mi);
    }
  }

  // ---- hit point and the NEE shadow ray (shadowRayTest) ----------------
  const V3 hit_p = add(o, scale(d, hit ? t : 1.0f));
  if (MODE == kPre) {
    const V3 l_vec = sub(ld3(a, L_PX, 0), hit_p);
    const float t_light = safe_sqrt(dot(l_vec, l_vec));
    const float inv = fabsf(t_light) > 1.0e-12f ? 1.0f / t_light : 0.0f;  // safe_div(1, t)
    st3(a, O_HPX, k, hit_p);
    st3(a, O_LDX, k, scale(l_vec, inv));
    st<float>(a, O_TLIGHT, k, t_light);
    st<bool>(a, O_CASTS, k, live && m.d > 0.0f);
    return;
  }
  bool casts = false;
  if (NEE) {
    casts = live && m.d > 0.0f;
    st<bool>(a, O_CASTS, k, casts);
  }

  V3 color = ld3(a, I_CX, k);
  V3 final_color = ld3(a, I_FX, k);
  int secondary = ld<int>(a, I_SECONDARY, k);
  V3 out_o = o, out_d = d;
  if (live) {
    // ---- the shading normal -------------------------------------------
    const V3 e1 = ld3(a, F_E1X, face);
    const V3 e2 = ld3(a, F_E2X, face);
    V3 normal = normalized(cross(e1, e2));
    if (PHONG && !ld<bool>(a, F_FLAT, face)) {
      normal = phong_normal(a, face, e1, e2, d, ld<float>(a, I_U, k), ld<float>(a, I_V, k));
    }
    const V3 n_sh = dot(normal, neg(d)) <= 0.0f ? neg(normal) : normal;

    // ---- NEE contribution (updateColor) ----------------------------------
    if (NEE && casts && !ld<bool>(a, I_OCC, k)) {
      const V3 l_vec = sub(ld3(a, L_PX, 0), hit_p);
      const float t_light = safe_sqrt(dot(l_vec, l_vec));
      const float inv = fabsf(t_light) > 1.0e-12f ? 1.0f / t_light : 0.0f;
      const V3 l_dir = scale(l_vec, inv);
      const V3 l_rgb = ld3(a, L_RX, 0);
      if (BRDF == kSchlick) {
        const SchlickEval e = schlick_eval(n_sh, d, l_dir, m.rough, m.p);
        if (fabsf(e.pdf) > 1.0e-5f) {
          const float w_l = e.brdf * clamp_min0(dot(n_sh, l_dir)) / e.pdf;
          const V3 c = mul(mul(color, l_rgb), m.kd);
          const V3 f = adds(scale(scale(fresnel3(e.u, m.ks), w_l), m.d), 1.0f - m.d);
          final_color = add(final_color, sanitize3(mul(c, f)));
          secondary += 1;
        } else {
          final_color = adds(final_color, 0.0f);
        }
      } else {
        const SaEval e = sa_eval(n_sh, d, l_dir, m.nu, m.nv);
        if (fabsf(e.pdf) > 1.0e-5f) {
          const float b_s = (e.spec / e.pdf) * fresnel(e.hk1, m.rs);
          const float b_d = (e.diff * m.rd / e.pdf) * (1.0f - m.rs);
          const V3 bc = norm_clip(adds(scale(add(scale(m.ks, b_s), scale(m.kd, b_d)), m.d),
                                       1.0f - m.d));
          const V3 contrib = adds(scale(mul(bc, l_rgb), m.d), 1.0f - m.d);
          final_color = add(final_color, sanitize3(contrib));
          secondary += 1;
        } else {
          final_color = adds(final_color, 0.0f);
        }
      }
    } else if (NEE) {
      final_color = adds(final_color, 0.0f);
    }

    // ---- new direction (getNewRay) ---------------------------------------
    const float ra = rb.u(kBrdfA), rbb = rb.u(kBrdfB), rc = rb.u(kBrdfC);
    V3 new_d = BRDF == kSchlick ? schlick_sample(d, normal, m.rough, m.p, ra, rbb, rc)
                                : sa_sample(d, normal, m.d, m.nu, m.nv, ra, rbb, rc);
    bool add_depth = extend;
    if (TRANS) {
      const bool do_trans = m.d < 1.0f && m.d <= rb.u(kTrans);
      add_depth = extend || do_trans;
      if (do_trans) new_d = refract_dir(d, normal, m.ni, rb.u(kRefr));
    }

    // ---- throughput (updateColor) ------------------------------------------
    if (BRDF == kSchlick) {
      const SchlickEval e = schlick_eval(n_sh, d, new_d, m.rough, m.p);
      const float pdf_bs = fabsf(e.pdf) > 1.0e-7f ? e.pdf : 1.0f;
      const float w_b = e.brdf * clamp_min0(dot(n_sh, new_d)) / pdf_bs;
      const V3 mult = sanitize3(mul(m.kd, adds(scale(scale(fresnel3(e.u, m.ks), w_b), m.d),
                                               1.0f - m.d)));
      color = mul(color, mult);
    } else {
      const SaEval e = sa_eval(n_sh, d, new_d, m.nu, m.nv);
      const float pdf_bs = fabsf(e.pdf) > 1.0e-7f ? e.pdf : 1.0f;
      const float b_s = (e.spec / pdf_bs) * fresnel(e.hk1, m.rs);
      const float b_d = (e.diff * m.rd / pdf_bs) * (1.0f - m.rs);
      const V3 bc = sanitize3(norm_clip(adds(scale(add(scale(m.ks, b_s), scale(m.kd, b_d)),
                                                   m.d), 1.0f - m.d)));
      color = mul(color, bc);
    }

    // ---- depth budget, loop bound, Russian roulette ---------------------
    added += (add_depth && added < a.i[A_MAX_ADDED]) ? 1 : 0;
    alive = depth + 1 < max_depth + added;
    alive = alive && !(depth > 2 + added && max_component(color) < rb.u(kRr));
    out_o = hit_p;
    out_d = new_d;
  } else if (NEE) {
    final_color = adds(final_color, 0.0f);
  }

  st3(a, O_OX, k, out_o);
  st3(a, O_DX, k, out_d);
  st3(a, O_CX, k, color);
  st3(a, O_LX, k, light_val);
  st3(a, O_FX, k, final_color);
  st<bool>(a, O_ALIVE, k, alive);
  st<bool>(a, O_FOUND, k, ld<bool>(a, I_FOUND, k) || miss);
  st<int>(a, O_ADDED, k, added);
  st<int>(a, O_SECONDARY, k, secondary);
}

// K11's pointer slots, in the order of ops/cuda_shade.py::GEN_PTRS.
enum GenPtr {
  G_PX, G_PY, G_KEY, G_PREV_T,
  G_EYEX, G_EYEY, G_EYEZ, G_WX, G_WY, G_WZ, G_UX, G_UY, G_UZ, G_VX, G_VY, G_VZ,
  G_FOCAL, G_APERTURE, G_FOCUS,
  G_OX, G_OY, G_OZ, G_DX, G_DY, G_DZ,
  kGenPtrs
};
enum GenFloat { C_FX, C_FY, C_HALF_PX, C_AA, kGenFloats };

struct GenArgs {
  const void* p[kGenPtrs];
  int n, sample;
  float f[kGenFloats];
};

__device__ __forceinline__ float gf(const GenArgs& a, int slot, int k) {
  return static_cast<const float*>(a.p[slot])[k];
}
__device__ __forceinline__ V3 gv(const GenArgs& a, int slot) {
  return V3{gf(a, slot, 0), gf(a, slot + 1, 0), gf(a, slot + 2, 0)};
}

__global__ void __launch_bounds__(kThreads) gen_rays_kernel(const GenArgs a) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= a.n) return;
  const V3 eye = gv(a, G_EYEX), cw = gv(a, G_WX), cu = gv(a, G_UX), cv = gv(a, G_VX);
  const float fx = a.f[C_FX] + 2.0f * gf(a, G_PX, k);
  const float fy = a.f[C_FY] + 2.0f * gf(a, G_PY, k);
  V3 d = normalized(add(cw, scale(add(scale(cu, fx), scale(cv, fy)), a.f[C_HALF_PX])));

  const BounceRng r0(static_cast<const long long*>(a.p[G_KEY])[k], a.sample, 0);
  const float rnd = r0.u(kAaR);
  const float phi = kTwoPi * r0.u(kAaPhi);
  const V3 aa = jitter(d, phi, sqrtf(rnd), sqrtf(1.0f - rnd));
  d = normalized(add(d, scale(aa, a.f[C_AA])));

  V3 o = eye;
  const float prev_t = gf(a, G_PREV_T, k);
  const float focus = gf(a, G_FOCUS, 0);
  const float t_obj = isfinite(prev_t) ? prev_t : 1000.0f;
  if (focus >= 0.0f && t_obj > 0.0f) {  // thin-lens depth of field
    const float t_foc = isfinite(focus) ? focus : 1000.0f;
    const float lens = gf(a, G_FOCAL, 0) / gf(a, G_APERTURE, 0);
    const float radius = r0.u(kDofR) * lens * 0.5f;
    const float angle = kTwoPi * r0.u(kDofPhi);
    o = add(add(eye, scale(cu, radius * cosf(angle))), scale(cv, radius * sinf(angle)));
    d = normalized(sub(add(eye, scale(d, t_foc)), o));
  }
  const float out[6] = {o.x, o.y, o.z, d.x, d.y, d.z};
#pragma unroll
  for (int j = 0; j < 6; ++j) static_cast<float*>(const_cast<void*>(a.p[G_OX + j]))[k] = out[j];
}

template <int BRDF, bool NEE, bool TRANS, bool PHONG, int MODE>
cudaError_t launch_shade(const ShadeArgs& a, cudaStream_t stream) {
  const int blocks = (a.i[A_N] + kThreads - 1) / kThreads;
  shade_kernel<BRDF, NEE, TRANS, PHONG, MODE><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int BRDF, bool NEE, bool TRANS, bool PHONG>
cudaError_t by_mode(int mode, const ShadeArgs& a, cudaStream_t s) {
  if constexpr (NEE) {  // kPre and kPost exist only with NEE
    if (mode == kPre) return launch_shade<BRDF, NEE, TRANS, PHONG, kPre>(a, s);
    if (mode == kPost) return launch_shade<BRDF, NEE, TRANS, PHONG, kPost>(a, s);
  }
  return launch_shade<BRDF, NEE, TRANS, PHONG, kFused>(a, s);
}

template <int BRDF, bool NEE, bool TRANS>
cudaError_t by_phong(bool phong, int mode, const ShadeArgs& a, cudaStream_t s) {
  return phong ? by_mode<BRDF, NEE, TRANS, true>(mode, a, s)
               : by_mode<BRDF, NEE, TRANS, false>(mode, a, s);
}

template <int BRDF, bool NEE>
cudaError_t by_trans(bool trans, bool phong, int mode, const ShadeArgs& a, cudaStream_t s) {
  return trans ? by_phong<BRDF, NEE, true>(phong, mode, a, s)
               : by_phong<BRDF, NEE, false>(phong, mode, a, s);
}

template <int BRDF>
cudaError_t by_nee(bool nee, bool trans, bool phong, int mode, const ShadeArgs& a,
                   cudaStream_t s) {
  return nee ? by_trans<BRDF, true>(trans, phong, mode, a, s)
             : by_trans<BRDF, false>(trans, phong, mode, a, s);
}

}  // namespace

extern "C" {

// K12 over n lanes: ptrs, ints and floats in the orders of ShadePtr,
// ShadeInt and ShadeFloat; brdf 0 Schlick, 1 Shirley-Ashikhmin; mode 0
// fused, 1 pre, 2 post. Returns the launch's cudaError (0 for n = 0).
int pbr_shade(const void* const* ptrs, const int* ints, const float* floats, int brdf, int nee,
              int trans, int phong, int mode, void* stream) {
  ShadeArgs a;
  for (int i = 0; i < kShadePtrs; ++i) a.p[i] = ptrs[i];
  for (int i = 0; i < kShadeInts; ++i) a.i[i] = ints[i];
  for (int i = 0; i < kShadeFloats; ++i) a.f[i] = floats[i];
  if (a.i[A_N] == 0) return 0;
  if (mode < kFused || mode > kPost || (mode != kFused && !nee)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(brdf == kSchlick
                              ? by_nee<kSchlick>(nee != 0, trans != 0, phong != 0, mode, a, s)
                              : by_nee<1>(nee != 0, trans != 0, phong != 0, mode, a, s));
}

// K11 over n lanes: ptrs and floats in the orders of GenPtr and GenFloat.
int pbr_gen_rays(const void* const* ptrs, int n, int sample, const float* floats, void* stream) {
  GenArgs a;
  for (int i = 0; i < kGenPtrs; ++i) a.p[i] = ptrs[i];
  a.n = n;
  a.sample = sample;
  for (int i = 0; i < kGenFloats; ++i) a.f[i] = floats[i];
  if (n == 0) return 0;
  gen_rays_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
