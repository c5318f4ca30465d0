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
    reflect,
    safe_arccos,
    safe_div,
    safe_normalized,
    safe_pow,
    safe_sqrt,
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
