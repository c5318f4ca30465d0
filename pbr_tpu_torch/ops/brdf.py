"""BRDF library on torch tensors: Schlick and Shirley-Ashikhmin eval and
sample, Fresnel and refraction.

The counterpart of ``pbr_tpu/ops/brdf.py`` (itself a vectorized
re-derivation of the reference's ``pt_brdf.cl`` and ``pt_utils.cl``), with
the same guards and operation order. Transcendentals (``acos``, ``pow``,
``cos``, ``sin``, ``atan``, ``tan``) differ by a few ULPs between torch and
NumPy, so parity is held to a tolerance, never bitwise. Random inputs are
passed in explicitly (detached sampling: gradients flow through the
weights, not through the sample positions).
"""

from __future__ import annotations

import numpy as np
import torch

from pbr_tpu_torch.utils.config import NI_AIR
from pbr_tpu_torch.ops.vec import (
    Vec3,
    bisect,
    f32,
    jitter,
    max_weight,
    reflect,
    safe_arccos,
    safe_div,
    safe_normalized,
    safe_normalized_vjp,
    safe_pow,
    safe_sqrt,
    sum3,
    where3,
)

PI = f32(np.pi)
PI_X2 = f32(2.0 * np.pi)
M_1_PI = f32(1.0 / np.pi)
M_PI_2 = f32(np.pi / 2.0)
_NI_AIR = f32(NI_AIR)
_SA_PD = f32(0.38750768752)  # 28/(23π), pt_brdf.cl:256


def _guarded_div(num, den, zero_if):
    """num / den, but 0 where ``zero_if`` (the reference's x==0 guards)."""
    safe = torch.where(zero_if, 1.0, den)
    return torch.where(zero_if, 0.0, num / safe)


def fresnel(u, c):
    """Schlick Fresnel approximation (pt_utils.cl:53-56); ``c`` a tensor or
    a Vec3 (per-channel, pt_utils.cl:65-68)."""
    v = 1.0 - u
    v5 = v * v * v * v * v
    return c + (1.0 - c) * v5


# ---------------------------------------------------------------------------
# Schlick BRDF (reference BRDF == 0)
# ---------------------------------------------------------------------------


def _schlick_Z(t, r):
    x = 1.0 + r * t * t - t * t
    return _guarded_div(r, x * x, x == 0.0)


def _schlick_A(w, p):
    p2 = p * p
    w2 = w * w
    x = p2 - p2 * w2 + w2
    return safe_sqrt(_guarded_div(p, x, x == 0.0))


def _schlick_G(v, r):
    x = r - r * v + v
    return _guarded_div(v, x, x == 0.0)


def _schlick_D(t, v_out, v_in, w, r, p):
    b = 4.0 * r * (1.0 - r)
    r_lt = r < 0.5
    a = torch.where(r_lt, 0.0, 1.0 - b)
    c = torch.where(r_lt, 1.0 - b, 0.0)
    d = 4.0 * PI * v_out * v_in

    gp = _schlick_G(v_out, r) * _schlick_G(v_in, r)
    b2 = gp * _schlick_Z(t, r) * _schlick_A(w, p) + (1.0 - gp)

    lam = a * M_1_PI
    ani = _guarded_div(b, d, (b == 0.0) | (d == 0.0)) * b2
    fres = _guarded_div(c, v_in, v_in == 0.0)
    return lam + ani + fres


def schlick_eval(normal: Vec3, d_out: Vec3, d_in: Vec3, rough, p):
    """Evaluate the Schlick BRDF (pt_brdf.cl:125-149). Returns
    ``(brdf, u, pdf)``."""
    v_out_dir = -d_out
    un = safe_normalized(normal.yzx().cross(normal))
    h = bisect(v_out_dir, d_in)
    t = h.dot(normal)
    v_in = d_in.dot(normal)
    v_out = v_out_dir.dot(normal)
    hp = safe_normalized(h.cross(normal).cross(normal))
    w = un.dot(hp)
    u = h.dot(v_out_dir)
    pdf = safe_div(t, 4.0 * PI * h.dot(v_out_dir))
    return _schlick_D(t, v_out, v_in, w, rough, p), u, pdf


def _quadrant_phi(b, iso2):
    """4-quadrant azimuth warp of the Schlick sampler (pt_brdf.cl:172-194)."""
    quad = torch.floor(b * 4.0)
    b_loc = 1.0 - 4.0 * ((quad + 1.0) * 0.25 - b)
    b2 = b_loc * b_loc
    den = 1.0 - b2 + b2 * iso2
    phi_base = M_PI_2 * safe_sqrt(_guarded_div(iso2 * b2, den, den == 0.0))
    return torch.where(
        quad == 0.0,
        phi_base,
        torch.where(
            quad == 1.0,
            PI - phi_base,
            torch.where(quad == 2.0, PI + phi_base, PI_X2 - phi_base),
        ),
    )


def schlick_sample(d: Vec3, normal: Vec3, rough, p, ra, rb, rc) -> Vec3:
    """Importance-sample a new direction for the Schlick BRDF
    (newRaySchlick, pt_brdf.cl:159-208)."""
    iso2 = p * p
    denom = rough - ra * rough + ra
    alpha = safe_arccos(safe_sqrt(_guarded_div(ra, denom, denom == 0.0)))
    phi = _quadrant_phi(rb, iso2)
    phi = torch.where(p < 1.0, phi + M_PI_2, phi)

    h = jitter(normal, phi, torch.sin(alpha), torch.cos(alpha))
    new_dir = reflect(d, h)
    fallback = jitter(normal, PI_X2 * rc, torch.sqrt(ra), torch.sqrt(1.0 - ra))
    new_dir = where3(new_dir.dot(normal) <= 0.0, fallback, new_dir)
    return where3(rough == 0.0, reflect(d, normal), new_dir)


# ---------------------------------------------------------------------------
# Shirley-Ashikhmin BRDF (reference BRDF == 1)
# ---------------------------------------------------------------------------


def sa_eval(normal: Vec3, d_out: Vec3, d_in: Vec3, nu, nv):
    """Evaluate the Shirley-Ashikhmin BRDF (pt_brdf.cl:228-268). Returns
    ``(spec, diff_unit, dotHK1, pdf)``; see ``pbr_tpu.ops.brdf.sa_eval``
    for the clamped ``pow`` base."""
    un = safe_normalized(normal.yzx().cross(normal))
    vn = safe_normalized(normal.cross(un))

    k1 = d_in
    k2 = -d_out
    h = bisect(k1, k2)

    dot_hu = h.dot(un)
    dot_hv = h.dot(vn)
    dot_hn = h.dot(normal)
    dot_nk1 = normal.dot(k1)
    dot_nk2 = normal.dot(k2)
    dot_hk1 = h.dot(k1)

    ps_e_num = nu * dot_hu * dot_hu + nv * dot_hv * dot_hv
    ps_e = _guarded_div(ps_e_num, 1.0 - dot_hn * dot_hn, dot_hn == 1.0)
    ps0 = torch.sqrt((nu + 1.0) * (nv + 1.0)) * 0.125 * M_1_PI
    ps1_num = safe_pow(dot_hn, ps_e)
    ps1 = safe_div(ps1_num, dot_hk1 * torch.maximum(dot_nk1, dot_nk2))

    a = 1.0 - dot_nk1 * 0.5
    b = 1.0 - dot_nk2 * 0.5
    pd = _SA_PD * (1.0 - a * a * a * a * a)
    pd = pd * (1.0 - b * b * b * b * b)

    spec = ps0 * ps1
    pdf = safe_div(ps0 * ps1_num, dot_hk1)
    return spec, pd, dot_hk1, pdf


def sa_sample(d: Vec3, normal: Vec3, mtl_d, nu, nv, ra, rb, rc) -> Vec3:
    """Sample the Shirley-Ashikhmin lobe (newRayShirleyAshikhmin,
    pt_brdf.cl:278-330)."""
    quad = torch.floor(ra * 4.0)
    a_loc = 1.0 - 4.0 * ((quad + 1.0) * 0.25 - ra)
    phi_flip = torch.where(quad == 0.0, 0.0, torch.where(quad == 3.0, PI_X2, PI))
    phi_flipf = torch.where((quad == 1.0) | (quad == 3.0), -1.0, 1.0)

    phi = torch.atan(torch.sqrt((nu + 1.0) / (nv + 1.0)) * torch.tan(M_PI_2 * a_loc))
    phi_full = phi_flip + phi_flipf * phi

    cosphi = torch.cos(phi)
    sinphi = torch.sin(phi)
    theta_e = 1.0 / (nu * cosphi * cosphi + nv * sinphi * sinphi + 1.0)
    theta = safe_arccos(safe_pow(1.0 - rb, theta_e))

    n_eff = where3((mtl_d < 1.0) | (normal.dot(-d) >= 0.0), normal, -normal)

    h = jitter(n_eff, phi_full, torch.sin(theta), torch.cos(theta))
    spec = reflect(d, h)
    diff = jitter(n_eff, PI_X2 * rc, torch.sqrt(rb), torch.sqrt(1.0 - rb))
    return where3(spec.dot(n_eff) <= 0.0, diff, spec)


# ---------------------------------------------------------------------------
# Refraction (reference pt_utils.cl:436-465)
# ---------------------------------------------------------------------------


def refract_dir(d: Vec3, normal: Vec3, ni, rand_choice) -> Vec3:
    """Fresnel-weighted refraction/reflection with total internal
    reflection; ``normal`` is the unflipped geometric normal."""
    into = normal.dot(-d) > 0.0
    nl = where3(into, normal, -normal)
    m1 = torch.where(into, _NI_AIR, ni)
    m2 = torch.where(into, ni, _NI_AIR)
    m = m1 / m2

    cos_i = -nl.dot(d)
    sin_t2 = m * m * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0

    sqrt_cos_t = safe_sqrt(1.0 - sin_t2)
    r0 = (m1 - m2) / (m1 + m2)
    c = torch.where(m1 > m2, sqrt_cos_t, cos_i)
    reflectance = fresnel(c, r0 * r0)

    transmit_dir = d * m + nl * (m * cos_i - sqrt_cos_t)
    refl_dir = reflect(d, nl)
    out = where3(reflectance < rand_choice, transmit_dir, refl_dir)
    return where3(tir, refl_dir, out)


# ---------------------------------------------------------------------------
# Adjoints of the evaluations (the sampling is detached: it has none), the
# plain versions of csrc/shade_bwd.cu's device functions, op for op
# (ops/vec.py's adjoint section says the conventions).
# ---------------------------------------------------------------------------

FOUR_PI = f32(4.0 * np.pi)  # 4 * PI, exact: the evaluations' 4.0 * PI * x


def fresnel_vjp(u, c, g):
    """``fresnel(u, c)``'s adjoint ``(g_u, g_c)``; for a Vec3 ``c`` and
    ``g`` the channels' terms of ``g_u`` summed x, y, z."""
    v = 1.0 - u
    v4 = v * v * v * v
    g_c = g * (1.0 - v * v * v * v * v)
    g_v5 = g * (1.0 - c)
    if isinstance(g_v5, Vec3):
        g_v5 = sum3(g_v5)
    return -(g_v5 * (5.0 * v4)), g_c


def _guarded_vjp(den, zero_if, q, g):
    """``q = _guarded_div(num, den, zero_if)``'s adjoint ``(g_num, g_den)``:
    zero where guarded."""
    safe = torch.where(zero_if, 1.0, den)
    return torch.where(zero_if, 0.0, g / safe), torch.where(zero_if, 0.0, -(g * q) / safe)


def _schlick_G_vjp(v, r, g):
    """(g_v, g_r) of ``_schlick_G``."""
    x = r - r * v + v
    zero = x == 0.0
    q = _guarded_div(v, x, zero)
    g_v, g_x = _guarded_vjp(x, zero, q, g)
    return g_v + g_x * (1.0 - r), g_x * (1.0 - v)


def _schlick_D_vjp(t, v_out, v_in, w, r, p, g):
    """(g_t, g_v_out, g_v_in, g_w, g_r, g_p) of ``_schlick_D``."""
    b = 4.0 * r * (1.0 - r)
    r_lt = r < 0.5
    one_b = 1.0 - b
    dd = 4.0 * PI * v_out * v_in
    gv1, gv2 = _schlick_G(v_out, r), _schlick_G(v_in, r)
    gp = gv1 * gv2
    z = _schlick_Z(t, r)
    a_ = _schlick_A(w, p)
    m1 = gp * z
    b2 = m1 * a_ + (1.0 - gp)
    q_zero = (b == 0.0) | (dd == 0.0)
    q = _guarded_div(b, dd, q_zero)
    f_zero = v_in == 0.0
    fres = _guarded_div(torch.where(r_lt, one_b, 0.0), v_in, f_zero)
    # D = a / pi + q * b2 + c / v_in
    g_a = g * M_1_PI
    g_q = g * b2
    g_b2 = g * q
    g_c, g_vi = _guarded_vjp(v_in, f_zero, fres, g)
    g_b, g_dd = _guarded_vjp(dd, q_zero, q, g_q)
    g_b = g_b - torch.where(r_lt, g_c, g_a)  # a and c are 1 - b on either side
    g_m1 = g_b2 * a_
    g_a_ = g_b2 * m1
    g_gp = g_m1 * z - g_b2
    g_z = g_m1 * gp
    g_vo = g_dd * v_in * FOUR_PI
    g_vi = g_vi + g_dd * (FOUR_PI * v_out)
    g_r = g_b * (1.0 - r) * 4.0 - g_b * (4.0 * r)
    # Z(t, r) = r / x^2, x = 1 + r t t - t t
    x = 1.0 + r * t * t - t * t
    xx = x * x
    zz = x == 0.0
    g_rz, g_xx = _guarded_vjp(xx, zz, z, g_z)
    g_x = g_xx * x * 2.0
    g_r = g_r + g_rz + g_x * (t * t)
    g_t = g_x * (r * t * 2.0 - t * 2.0)
    # A(w, p) = safe_sqrt(p / x), x = p2 - p2 w2 + w2
    p2, w2 = p * p, w * w
    xa = p2 - p2 * w2 + w2
    za = xa == 0.0
    y = _guarded_div(p, xa, za)
    g_y = torch.where(y > 0.0, g_a_ / (2.0 * a_), 0.0)
    g_p, g_xa = _guarded_vjp(xa, za, y, g_y)
    g_p = g_p + g_xa * (1.0 - w2) * p * 2.0
    g_w = g_xa * (1.0 - p2) * w * 2.0
    # G(v_out, r) G(v_in, r)
    g_vo1, g_r1 = _schlick_G_vjp(v_out, r, g_gp * gv2)
    g_vi2, g_r2 = _schlick_G_vjp(v_in, r, g_gp * gv1)
    return g_t, g_vo + g_vo1, g_vi + g_vi2, g_w, g_r + g_r1 + g_r2, g_p


def schlick_eval_vjp(normal: Vec3, d_out: Vec3, d_in: Vec3, rough, p, g_brdf, g_u, g_pdf):
    """``schlick_eval``'s adjoint: ``(g_d_out, g_d_in, g_rough, g_p)``
    (``normal`` is the detached geometry's)."""
    vo = -d_out
    un = safe_normalized(normal.yzx().cross(normal))
    hs = vo + d_in
    h = safe_normalized(hs)
    t = h.dot(normal)
    v_in = d_in.dot(normal)
    v_out = vo.dot(normal)
    c1 = h.cross(normal)
    c2 = c1.cross(normal)
    hp = safe_normalized(c2)
    w = un.dot(hp)
    den = FOUR_PI * h.dot(vo)
    pok = torch.abs(den) > 1e-12
    pdf = torch.where(pok, t / torch.where(pok, den, 1.0), 0.0)
    g_t, g_vo_s, g_vi_s, g_w, g_r, g_p = _schlick_D_vjp(t, v_out, v_in, w, rough, p, g_brdf)
    g_tp, g_den = _guarded_vjp(den, ~pok, pdf, g_pdf)
    g_t = g_t + g_tp
    g_hvo = g_u + g_den * FOUR_PI  # u and the pdf's denominator are h . vo
    g_c2 = safe_normalized_vjp(c2, un * g_w)
    g_c1 = normal.cross(g_c2)  # c2 = c1 x normal
    g_h = normal.cross(g_c1) + normal * g_t + vo * g_hvo  # c1 = h x normal
    g_hs = safe_normalized_vjp(hs, g_h)
    g_vo = h * g_hvo + normal * g_vo_s + g_hs
    g_din = g_hs + normal * g_vi_s
    return -g_vo, g_din, g_r, g_p


def sa_eval_vjp(normal: Vec3, d_out: Vec3, d_in: Vec3, nu, nv, g_spec, g_diff, g_hk1, g_pdf):
    """``sa_eval``'s adjoint: ``(g_d_out, g_d_in, g_nu, g_nv)``. The
    exponent's term of ``safe_pow`` is x^e ln x."""
    un = safe_normalized(normal.yzx().cross(normal))
    vn = safe_normalized(normal.cross(un))
    k1 = d_in
    k2 = -d_out
    hs = k1 + k2
    h = safe_normalized(hs)
    dot_hu = h.dot(un)
    dot_hv = h.dot(vn)
    dot_hn = h.dot(normal)
    dot_nk1 = normal.dot(k1)
    dot_nk2 = normal.dot(k2)
    dot_hk1 = h.dot(k1)
    ps_e_num = nu * dot_hu * dot_hu + nv * dot_hv * dot_hv
    e_zero = dot_hn == 1.0
    den_e = 1.0 - dot_hn * dot_hn
    ps_e = _guarded_div(ps_e_num, den_e, e_zero)
    s0 = (nu + 1.0) * (nv + 1.0)
    sq = torch.sqrt(s0)
    ps0 = sq * 0.125 * M_1_PI
    pos = dot_hn > 0.0
    hn_s = torch.where(pos, dot_hn, 1.0)
    ps1_num = torch.where(pos, torch.pow(hn_s, ps_e), 0.0)
    mx = torch.maximum(dot_nk1, dot_nk2)
    den1 = dot_hk1 * mx
    ok1 = torch.abs(den1) > 1e-12
    ps1 = torch.where(ok1, ps1_num / torch.where(ok1, den1, 1.0), 0.0)
    a = 1.0 - dot_nk1 * 0.5
    b = 1.0 - dot_nk2 * 0.5
    pd1 = _SA_PD * (1.0 - a * a * a * a * a)
    okh = torch.abs(dot_hk1) > 1e-12
    q = ps0 * ps1_num
    pdf = torch.where(okh, q / torch.where(okh, dot_hk1, 1.0), 0.0)
    # spec = ps0 ps1, pdf = safe_div(ps0 ps1_num, hk1), diff = pd1 (1 - b^5)
    g_q, g_h1 = _guarded_vjp(dot_hk1, ~okh, pdf, g_pdf)
    g_hk1 = g_hk1 + g_h1
    g_ps0 = g_spec * ps1 + g_q * ps1_num
    g_ps1 = g_spec * ps0
    g_p = g_q * ps0
    g_pd1 = g_diff * (1.0 - b * b * b * b * b)
    g_b = -(g_diff * pd1) * (5.0 * (b * b * b * b))
    g_a = -(g_pd1 * _SA_PD) * (5.0 * (a * a * a * a))
    g_p1, g_den1 = _guarded_vjp(den1, ~ok1, ps1, g_ps1)
    g_p = g_p + g_p1
    g_hk1 = g_hk1 + g_den1 * mx
    g_mx = g_den1 * dot_hk1
    g_nk1 = g_mx * max_weight(dot_nk1, dot_nk2) - g_a * 0.5
    g_nk2 = g_mx * max_weight(dot_nk2, dot_nk1) - g_b * 0.5
    # ps1_num = safe_pow(hn, e): e hn^(e - 1) and hn^e ln hn
    g_hn = torch.where(pos, g_p * (ps_e * torch.pow(hn_s, ps_e - 1.0)), 0.0)
    g_e = torch.where(pos, g_p * (ps1_num * torch.log(hn_s)), 0.0)
    g_s0 = g_ps0 * M_1_PI * 0.125 / (2.0 * sq)
    g_num, g_den_e = _guarded_vjp(den_e, e_zero, ps_e, g_e)
    g_hn = g_hn - g_den_e * dot_hn * 2.0
    g_nu = g_s0 * (nv + 1.0) + g_num * dot_hu * dot_hu
    g_nv = g_s0 * (nu + 1.0) + g_num * dot_hv * dot_hv
    g_hu = g_num * nu * dot_hu * 2.0
    g_hv = g_num * nv * dot_hv * 2.0
    g_h = un * g_hu + vn * g_hv + normal * g_hn + k1 * g_hk1
    g_hs = safe_normalized_vjp(hs, g_h)
    g_k1 = normal * g_nk1 + h * g_hk1 + g_hs
    g_k2 = normal * g_nk2 + g_hs
    return -g_k2, g_k1, g_nu, g_nv
