"""Kernels K11 and K12: the frame's elementwise shading, CUDA for Hopper, and
their plain PyTorch versions.

The JAX package runs a frame as one XLA program, and XLA fuses the
elementwise work of ``trace_rays`` into a few loops. These kernels are the
port's counterpart of that fusion (``csrc/shade.cu``, whose header says what
bounds them and how the design answers it); they replace no Pallas kernel:

- **K11** (``gen_rays``): the camera rays of a sample, pinhole, AA jitter
  and thin-lens DoF (``pbr_tpu/models/integrator.py::_gen_rays``, :287);
- **K12** (``shade``): everything of a bounce after the search
  (``pbr_tpu/models/integrator.py:579-833``, with ``_orb_pass`` at :324),
  one template over BRDF x NEE x transparency x Phong with three instances:
  "K12" (fused: the occluded bit came with the search, or there is no NEE;
  one launch a bounce), "K12 pre" (writes the shadow ray for a shadow leg
  that is a walk of its own) and "K12 post" (finishes the bounce from that
  walk's occluded bit).

``gen_rays_plain`` and ``shade_plain`` are the integrator's torch ops, moved
here with the same operations in the same order: the CPU path, and the card's
path where autograd records the frame (``fit``, the bench's forward+backward
step), run them, and the kernels are held bitwise to them on the card.

Dispatch: a CPU tensor runs the plain version. On a CUDA tensor a wrapper
launches its kernel when ``torch.is_grad_enabled()`` is false or no input
requires grad, and raises when the kernel does not build or launch; where
autograd records the frame it runs the plain version, until K12 has a
backward. ``launches`` counts kernel launches ("K11", "K12", "K12 pre",
"K12 post"); a launch under capture counts at its graph's replays
(``ops.counts``). Nothing is built or imported for CUDA when this module is
imported.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pbr_tpu_torch.ops import count_launch
from pbr_tpu_torch.ops.brdf import (
    PI_X2,
    fresnel,
    refract_dir,
    sa_eval,
    sa_sample,
    schlick_eval,
    schlick_sample,
)
from pbr_tpu_torch.ops.cuda_intersect import load
from pbr_tpu_torch.ops.intersect import gather_vec3, geometric_normal, sphere
from pbr_tpu_torch.ops.phongtess import patch_constants, phongtess_normal
from pbr_tpu_torch.ops.rng import (
    S_AA_PHI,
    S_AA_R,
    S_BRDF_A,
    S_BRDF_B,
    S_BRDF_C,
    S_DOF_PHI,
    S_DOF_R,
    S_EXTEND,
    S_REFR,
    S_RR,
    S_TRANS,
    PixelRng,
)
from pbr_tpu_torch.ops.vec import Vec3, f32, jitter, safe_div, safe_sqrt, where3
from pbr_tpu_torch.scene.camera import pixel_dim
from pbr_tpu_torch.utils.config import BRDF_SCHLICK, RenderSettings

launches = {"K11": 0, "K12": 0, "K12 pre": 0, "K12 post": 0}

_I32 = torch.int32
_ZERO, _ONE = torch.tensor(0.0), torch.tensor(1.0)  # 0-d: broadcast on any device
_MODES = {"K12": 0, "K12 pre": 1, "K12 post": 2}

# K12's pointer slots (csrc/shade.cu's ShadePtr, in its order):
# tests/test_torch_shade.py holds the two lists equal.
SHADE_PTRS = (
    "I_OX", "I_OY", "I_OZ", "I_DX", "I_DY", "I_DZ", "I_CX", "I_CY", "I_CZ",
    "I_LX", "I_LY", "I_LZ", "I_FX", "I_FY", "I_FZ",
    "I_ALIVE", "I_FOUND", "I_ADDED", "I_SECONDARY",
    "I_T", "I_FACE", "I_U", "I_V", "I_OCC", "I_KEY",
    "F_MTL", "F_E1X", "F_E1Y", "F_E1Z", "F_E2X", "F_E2Y", "F_E2Z", "F_V0X", "F_V0Y", "F_V0Z",
    "F_N0X", "F_N0Y", "F_N0Z", "F_N1X", "F_N1Y", "F_N1Z", "F_N2X", "F_N2Y", "F_N2Z", "F_FLAT",
    "M_D", "M_NI", "M_ROUGH", "M_P", "M_NU", "M_NV", "M_RS", "M_RD",
    "M_KDX", "M_KDY", "M_KDZ", "M_KSX", "M_KSY", "M_KSZ",
    "L_PX", "L_PY", "L_PZ", "L_RX", "L_RY", "L_RZ", "L_RAD", "L_TYPE",
    "O_OX", "O_OY", "O_OZ", "O_DX", "O_DY", "O_DZ", "O_CX", "O_CY", "O_CZ",
    "O_LX", "O_LY", "O_LZ", "O_FX", "O_FY", "O_FZ",
    "O_ALIVE", "O_FOUND", "O_ADDED", "O_SECONDARY", "O_CASTS",
    "O_HPX", "O_HPY", "O_HPZ", "O_LDX", "O_LDY", "O_LDZ", "O_TLIGHT",
)
# K11's pointer slots (csrc/shade.cu's GenPtr).
GEN_PTRS = (
    "G_PX", "G_PY", "G_KEY", "G_PREV_T",
    "G_EYEX", "G_EYEY", "G_EYEZ", "G_WX", "G_WY", "G_WZ", "G_UX", "G_UY", "G_UZ",
    "G_VX", "G_VY", "G_VZ", "G_FOCAL", "G_APERTURE", "G_FOCUS",
    "G_OX", "G_OY", "G_OZ", "G_DX", "G_DY", "G_DZ",
)
_P, _I = ctypes.c_void_p, ctypes.c_int
# ptrs, ints, floats, brdf, nee, transparency, phong, mode, stream
_SHADE_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
# ptrs, n, sample, floats, stream
_GEN_ARGTYPES = [_P, _I, _I, _P, _P]


class Lanes(NamedTuple):
    """The per-lane state that a bounce advances: (B,) tensors."""

    o: Vec3
    d: Vec3
    color: Vec3
    alive: torch.Tensor  # bool
    light_found: torch.Tensor  # bool
    light_val: Vec3
    depth_added: torch.Tensor  # int32
    final_color: Vec3
    secondary: torch.Tensor  # int32


class Hit(NamedTuple):
    """A bounce's search: (B,) t and face; the curved winner's (u, v) with
    Phong tessellation, else None; the occluded bit where the search walked
    the shadow ray too, else None."""

    t: torch.Tensor
    face: torch.Tensor
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    occluded: Optional[torch.Tensor] = None


class ShadeScene(NamedTuple):
    """What the shade reads of the scene: the (detached) triangles, the
    materials and lights of ``SceneParams``, and with Phong tessellation
    the (F,) flat flags (``phongtess.face_is_flat``, else None)."""

    tris: object
    materials: object
    lights: object
    flat: Optional[torch.Tensor] = None


class ShadeConfig(NamedTuple):
    """What a frame's settings fix for every bounce (launch arguments)."""

    brdf: int
    nee: bool  # shadow rays on and a light to cast them to
    transparency: bool  # not settings.no_transparency
    max_depth: int
    max_added_depth: int
    sky: tuple  # three float32 values
    pt_alpha: float  # > 0: Phong tessellation

    @staticmethod
    def of(settings: RenderSettings, num_lights: int) -> "ShadeConfig":
        return ShadeConfig(
            brdf=int(settings.brdf), nee=bool(settings.shadow_rays) and num_lights > 0,
            transparency=not settings.no_transparency, max_depth=int(settings.max_depth),
            max_added_depth=int(settings.max_added_depth),
            sky=tuple(f32(c) for c in settings.sky_light),
            pt_alpha=float(settings.phong_tessellation))


# ---------------------------------------------------------------------------
# Plain versions: the integrator's torch ops
# ---------------------------------------------------------------------------


def _zeros3(like) -> Vec3:
    return Vec3(torch.zeros_like(like), torch.zeros_like(like), torch.zeros_like(like))


def _sanitize3(v: Vec3) -> Vec3:
    """Non-finite components -> 0: an impossible sample weighs nothing
    (pbr_tpu.models.integrator._sanitize3)."""
    f = lambda c: torch.where(torch.isfinite(c), c, 0.0)  # noqa: E731
    return Vec3(f(v.x), f(v.y), f(v.z))


def _clip01(v: Vec3) -> Vec3:
    """``jnp.clip(c, 0, 1)``, which is ``minimum(maximum(c, 0), 1)``: a
    component exactly at a bound gets half the gradient, as in JAX (``clamp``
    would pass all of it). A grey material's normalised colour sits exactly
    at 1 in every component."""
    f = lambda c: torch.minimum(torch.maximum(c, _ZERO), _ONE)  # noqa: E731
    return Vec3(f(v.x), f(v.y), f(v.z))


def _norm_rgb(bc: Vec3) -> Vec3:
    """``bc / maximum(1, max component)``, the tie splitting the gradient as
    ``jnp.maximum`` does."""
    return bc / torch.maximum(_ONE, bc.max_component())


SELECT_MAX_MATERIALS = 16  # a select chain up to this many materials, indexing above


def gather_materials(mats, midx):
    """All per-ray material fields; every value is a table entry verbatim.

    With at most ``SELECT_MAX_MATERIALS`` materials each field is the JAX
    default's select chain (``pbr_tpu/models/integrator.py:176-186``):
    ``f[0] * ones``, then one ``torch.where`` per material 1..M-1. Its
    backward is M elementwise selects and M small sums a field; plain
    indexing's backward sorts the B indices. Above that, plain indexing.
    K12 indexes: the same values."""
    fields = (mats.d, mats.Ni, mats.rough, mats.p, mats.nu, mats.nv, mats.Rs, mats.Rd,
              *mats.kd, *mats.ks)
    m = int(mats.d.shape[0])
    if m <= SELECT_MAX_MATERIALS:
        ones = torch.ones(midx.shape, dtype=torch.float32, device=midx.device)
        sels = [midx == i for i in range(1, m)]

        def pick(f):
            v = f[0] * ones
            for i, sel in enumerate(sels):
                v = torch.where(sel, f[i + 1], v)
            return v

        vals = [pick(f) for f in fields]
    else:
        vals = [f[midx] for f in fields]
    return (*vals[:8], Vec3(*vals[8:11]), Vec3(*vals[11:14]))


def _orb_pass(o, d, lights, t_geom):
    """Orb-light visibility on a geometry miss (traverseLights,
    pt_bvh.cl:54-74): the last orb hit in light order wins."""
    orb_idx = torch.full(o.x.shape, -1, dtype=_I32, device=o.x.device)
    for i in range(lights.count):
        center = Vec3(lights.pos.x[i], lights.pos.y[i], lights.pos.z[i])
        _, hit = sphere(o, d, center, lights.radius[i])
        orb_idx = torch.where((lights.type[i] == 2) & hit, i, orb_idx)
    return torch.where(torch.isfinite(t_geom), -1, orb_idx)


def _gen_consts(settings: RenderSettings) -> tuple:
    """K11's float arguments, as the plain version rounds them: f32(1 - w),
    f32(1 - h), the half pixel and the AA jitter's scale."""
    pxdim = np.float32(pixel_dim(settings.width, settings.height, settings.fov))
    return (f32(1.0 - settings.width), f32(1.0 - settings.height),
            f32(pxdim * np.float32(0.5)), f32(pxdim * np.float32(settings.anti_aliasing)))


def gen_rays_plain(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t):
    """Primary rays: pinhole + AA jitter + thin-lens DoF (initRay,
    pathtracing.cl:25-48; pt_utils.cl:327-373). Camera fields are 0-d
    tensors and broadcast against the (B,) batch."""
    c_fx, c_fy, half_px, aa_scale = _gen_consts(settings)
    eye, cw, cu, cv = cam.eye, cam.w, cam.u, cam.v

    fx = c_fx + 2.0 * px
    fy = c_fy + 2.0 * py
    d = (cw + (cu * fx + cv * fy) * half_px).normalized()

    r0 = rng.at(s, 0)
    rnd = r0.u(S_AA_R)
    phi = PI_X2 * r0.u(S_AA_PHI)
    aa = jitter(d, phi, torch.sqrt(rnd), torch.sqrt(1.0 - rnd))
    d = (d + aa * aa_scale).normalized()

    o = eye
    t_obj = torch.where(torch.isfinite(prev_t), prev_t, 1000.0)
    t_foc = torch.where(torch.isfinite(cam.focus), cam.focus, 1000.0)
    lens = cam.focal_length / cam.aperture
    radius = r0.u(S_DOF_R) * lens * 0.5
    angle = PI_X2 * r0.u(S_DOF_PHI)
    o_dof = o + cu * (radius * torch.cos(angle)) + cv * (radius * torch.sin(angle))
    hit_focal = eye + d * t_foc
    d_dof = (hit_focal - o_dof).normalized()
    use_dof = (cam.focus >= 0.0) & (t_obj > 0.0)
    return where3(use_dof, o_dof, o), where3(use_dof, d_dof, d)


def shade_plain(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
                scene: ShadeScene, occlude: Optional[Callable] = None) -> tuple:
    """One bounce's shade after the search (the integrator's ``bounce``
    below its intersect step). ``occlude(hit_p, l_dir, t_light, casts)``
    gives the occluded bit of the lanes that cast a shadow ray where
    ``hit.occluded`` is None and NEE is on. Returns ``(lanes, casts)``,
    ``casts`` None without NEE."""
    o, d, color, alive, light_found, light_val, depth_added, final_color, secondary = lanes
    t, face = hit.t, hit.face
    tris, mats, lights = scene.tris, scene.materials, scene.lights
    num_lights = lights.count
    dev = t.device
    if num_lights:
        orb_idx = _orb_pass(o, d, lights, t)
    else:
        orb_idx = torch.full(t.shape, -1, dtype=_I32, device=dev)

    finite = torch.isfinite(t)
    hit_m = finite & alive
    zero3 = _zeros3(t)
    # ---- miss: sky or orb emission (pathtracing.cl:263-266) ------------
    miss = alive & ~finite
    is_orb = miss & (orb_idx >= 0)
    orb_safe = orb_idx.clamp_min(0)
    orb_rgb = zero3
    for li in range(num_lights):
        orb_rgb = where3(
            orb_safe == li,
            Vec3(lights.rgb.x[li], lights.rgb.y[li], lights.rgb.z[li]),
            orb_rgb,
        )
    light_val = where3(miss, where3(is_orb, orb_rgb, Vec3(*cfg.sky)), light_val)
    light_found = light_found | miss
    alive = alive & ~miss

    # ---- material & geometric normal -----------------------------------
    face_safe = face.clamp_min(0)
    midx = tris.mtl[face_safe]
    m_d, m_ni, m_rough, m_p, m_nu, m_nv, m_rs, m_rd, m_kd, m_ks = gather_materials(mats, midx)
    e1 = gather_vec3(tris.e1, face_safe)
    e2 = gather_vec3(tris.e2, face_safe)
    normal = geometric_normal(e1, e2)
    if cfg.pt_alpha > 0.0:
        # A curved winner's shading normal (getPhongTessNormal,
        # pt_utils.cl:282-294).
        v0 = gather_vec3(tris.v0, face_safe)
        n1, n2, n3 = (gather_vec3(n, face_safe) for n in (tris.n0, tris.n1, tris.n2))
        consts = patch_constants(v0, v0 + e1, v0 + e2, n1, n2, n3, cfg.pt_alpha)
        normal = where3(scene.flat[face_safe], normal,
                        phongtess_normal(d, n1, n2, n3, *consts, hit.u, hit.v))

    # ---- path extension decision (extendDepth, pt_utils.cl:89-96) ------
    rb = rng.at(s, depth)
    if cfg.brdf == BRDF_SCHLICK:
        extend = m_rough < rb.u(S_EXTEND)
    else:
        extend = torch.maximum(m_nu, m_nv) >= 50.0

    # ---- opportunistic last-bounce break (pathtracing.cl:274-276) ------
    is_last = depth == (cfg.max_depth + depth_added - 1)
    alive = alive & ~(hit_m & (m_d == 1.0) & ~extend & is_last)
    live = hit_m & alive

    # ---- hit point (guarded for dead lanes) ----------------------------
    hit_p = o + d * torch.where(hit_m, t, 1.0)

    # ---- NEE shadow ray (shadowRayTest, pathtracing.cl:188-199) --------
    casts = None
    if cfg.nee:
        l_vec = Vec3(lights.pos.x[0], lights.pos.y[0], lights.pos.z[0]) - hit_p
        t_light = safe_sqrt(l_vec.length2())
        l_dir = l_vec * safe_div(1.0, t_light)
        casts = live & (m_d > 0.0)
        occluded = hit.occluded
        if occluded is None:
            occluded = occlude(hit_p, l_dir, t_light, casts)
        nee_ok = casts & ~occluded

    # ---- new direction (getNewRay, pt_brdf.cl:344-378) -----------------
    ra, rbb, rc = rb.u(S_BRDF_A), rb.u(S_BRDF_B), rb.u(S_BRDF_C)
    if cfg.brdf == BRDF_SCHLICK:
        new_d = schlick_sample(d, normal, m_rough, m_p, ra, rbb, rc)
    else:
        new_d = sa_sample(d, normal, m_d, m_nu, m_nv, ra, rbb, rc)
    if not cfg.transparency:
        # Every material is opaque: the transmit branch is dead, and
        # its two draws are skipped (streams are keyed independently).
        add_depth = extend
    else:
        do_trans = (m_d < 1.0) & (m_d <= rb.u(S_TRANS))
        add_depth = extend | do_trans
        new_d = where3(do_trans, refract_dir(d, normal, m_ni, rb.u(S_REFR)), new_d)
    # Detached sampling: sample positions carry no gradient.
    new_d = new_d.detach()

    # ---- flip normal toward the viewer (pathtracing.cl:296-300) --------
    n_sh = where3(normal.dot(-d) <= 0.0, -normal, normal)

    # ---- throughput & NEE contribution (updateColor, pathtracing.cl) ---
    if cfg.brdf == BRDF_SCHLICK:
        if cfg.nee:
            brdf_l, u_l, pdf_l = schlick_eval(n_sh, d, l_dir, m_rough, m_p)
            ok = nee_ok & (torch.abs(pdf_l) > f32(1e-5))
            w_l = brdf_l * n_sh.dot(l_dir).clamp_min(0.0) / torch.where(ok, pdf_l, 1.0)
            l_rgb = Vec3(lights.rgb.x[0], lights.rgb.y[0], lights.rgb.z[0])
            contrib = color * l_rgb * m_kd * (fresnel(u_l, m_ks) * w_l * m_d + (1.0 - m_d))
            final_color = final_color + _sanitize3(where3(ok, contrib, zero3))
            secondary = secondary + ok.to(_I32)
        brdf_b, u_b, pdf_b = schlick_eval(n_sh, d, new_d, m_rough, m_p)
        pdf_bs = torch.where(live & (torch.abs(pdf_b) > f32(1e-7)), pdf_b, 1.0)
        w_b = brdf_b * n_sh.dot(new_d).clamp_min(0.0) / pdf_bs
        mult = _sanitize3(m_kd * (fresnel(u_b, m_ks) * w_b * m_d + (1.0 - m_d)))
        color = where3(live, color * mult, color)
    else:
        if cfg.nee:
            spec_l, diff_l, hk1_l, pdf_l = sa_eval(n_sh, d, l_dir, m_nu, m_nv)
            ok = nee_ok & (torch.abs(pdf_l) > f32(1e-5))
            pdf_ls = torch.where(ok, pdf_l, 1.0)
            b_s = (spec_l / pdf_ls) * fresnel(hk1_l, m_rs)
            b_d = (diff_l * m_rd / pdf_ls) * (1.0 - m_rs)
            bc = (m_ks * b_s + m_kd * b_d) * m_d + (1.0 - m_d)
            bc = _clip01(_norm_rgb(bc))
            l_rgb = Vec3(lights.rgb.x[0], lights.rgb.y[0], lights.rgb.z[0])
            contrib = bc * l_rgb * m_d + (1.0 - m_d)
            final_color = final_color + _sanitize3(where3(ok, contrib, zero3))
            secondary = secondary + ok.to(_I32)
        spec_b, diff_b, hk1_b, pdf_b = sa_eval(n_sh, d, new_d, m_nu, m_nv)
        pdf_bs = torch.where(live & (torch.abs(pdf_b) > f32(1e-7)), pdf_b, 1.0)
        b_s = (spec_b / pdf_bs) * fresnel(hk1_b, m_rs)
        b_d = (diff_b * m_rd / pdf_bs) * (1.0 - m_rs)
        bc = (m_ks * b_s + m_kd * b_d) * m_d + (1.0 - m_d)
        bc = _sanitize3(_clip01(_norm_rgb(bc)))
        color = where3(live, color * bc, color)

    # ---- extend the depth budget, loop bound, Russian roulette ---------
    depth_added = depth_added + (
        add_depth & (depth_added < cfg.max_added_depth) & live
    ).to(_I32)
    alive = alive & ((depth + 1) < cfg.max_depth + depth_added)
    rr = (depth > 2 + depth_added) & (color.max_component() < rb.u(S_RR))
    alive = alive & ~rr

    out = Lanes(where3(live, hit_p, o), where3(live, new_d, d), color, alive, light_found,
                light_val, depth_added, final_color, secondary)
    return out, casts


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in tensors)


def _check(who: str, name: str, x, dev, dtype, n: Optional[int] = None) -> None:
    """``x`` is a contiguous 1-D (or, with ``n`` None, 0-d or 1-D) tensor of
    ``dtype`` on ``dev``, with ``n`` elements when ``n`` is given."""
    ok = (isinstance(x, torch.Tensor) and x.device == dev and x.dtype == dtype
          and x.is_contiguous() and x.dim() <= 1 and (n is None or tuple(x.shape) == (n,)))
    if not ok:
        want = "a 0-d or 1-D" if n is None else f"a ({n},)"
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{who}: {name} must be {want} contiguous {dtype} tensor on {dev}, "
                         f"got {got}")


def _ptr_array(ptrs: list):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def gen_rays(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t):
    """The camera rays of sample ``s`` (``gen_rays_plain``'s contract):
    ``(o, d)``, Vec3s of (B,) float32. On a CUDA ``px`` the kernel K11, with
    the camera's fields (0-d or one-element float32 tensors on the card),
    ``px``, ``py`` and ``prev_t`` ((B,) float32) and ``rng``'s keys ((B,)
    int64) read on the device; ``gen_rays_plain`` on the CPU or where
    autograd records a camera that requires grad."""
    dev = px.device
    cam_fields = (*cam.eye, *cam.w, *cam.u, *cam.v, cam.focal_length, cam.aperture, cam.focus)
    if dev.type == "cpu" or _wants_grad(cam_fields):
        return gen_rays_plain(cam, settings, px, py, rng, s, prev_t)
    if dev.type != "cuda":
        raise ValueError(f"K11 runs on CUDA or CPU tensors, not {dev}")
    n = px.shape[0] if px.dim() == 1 else -1
    _check("K11", "px", px, dev, torch.float32, n)
    _check("K11", "py", py, dev, torch.float32, n)
    _check("K11", "prev_t", prev_t, dev, torch.float32, n)
    _check("K11", "the RNG keys", rng._base, dev, torch.int64, n)
    for i, c in enumerate(cam_fields):
        _check("K11", f"camera field {i}", c, dev, torch.float32)
        if c.numel() != 1:
            raise ValueError(f"K11: camera field {i} must hold one float, got {c.numel()}")
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    ptrs = [px.data_ptr(), py.data_ptr(), rng._base.data_ptr(), prev_t.data_ptr(),
            *(c.data_ptr() for c in cam_fields), *(out[j].data_ptr() for j in range(6))]
    consts = (ctypes.c_float * 4)(*_gen_consts(settings))
    lib = load("shade", "pbr_gen_rays", _GEN_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_gen_rays(_ptr_array(ptrs), n, int(s), consts, stream)
    if err != 0:
        raise RuntimeError(f"K11 launch failed: cudaError {err}")
    count_launch(launches, "K11")
    return Vec3(out[0], out[1], out[2]), Vec3(out[3], out[4], out[5])


def _scene_inputs(scene: ShadeScene, phong: bool) -> tuple:
    """K12's face, material and light tensors, in SHADE_PTRS order (F_*,
    M_*, L_*), with the checks' names."""
    tris, mats, lights = scene.tris, scene.materials, scene.lights
    if phong:
        faces = [tris.mtl, *tris.e1, *tris.e2, *tris.v0, *tris.n0, *tris.n1, *tris.n2, scene.flat]
    else:
        faces = [tris.mtl, *tris.e1, *tris.e2, *([None] * 13)]
    return (faces, [mats.d, mats.Ni, mats.rough, mats.p, mats.nu, mats.nv, mats.Rs, mats.Rd,
                    *mats.kd, *mats.ks],
            [*lights.pos, *lights.rgb, lights.radius, lights.type])


def shade(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
          scene: ShadeScene, occlude: Optional[Callable] = None) -> tuple:
    """One bounce's shade (``shade_plain``'s contract). On CUDA tensors the
    kernel K12: its fused instance when ``hit.occluded`` is given or NEE is
    off, else "K12 pre", ``occlude`` on its shadow ray, and "K12 post";
    ``shade_plain`` on the CPU or where autograd records an input that
    requires grad."""
    dev = hit.t.device
    mats, lights = scene.materials, scene.lights
    grad_inputs = (*lanes.o, *lanes.d, *lanes.color, *lanes.light_val, *lanes.final_color,
                   mats.d, mats.Ni, mats.rough, mats.p, mats.nu, mats.nv, mats.Rs, mats.Rd,
                   *mats.kd, *mats.ks, *lights.pos, *lights.rgb, lights.radius)
    if dev.type == "cpu" or _wants_grad(grad_inputs):
        return shade_plain(cfg, lanes, hit, rng, s, depth, scene, occlude)
    if not cfg.nee or hit.occluded is not None:
        return shade_launch("K12", cfg, lanes, hit, rng, s, depth, scene)
    *ray, casts = shade_launch("K12 pre", cfg, lanes, hit, rng, s, depth, scene)
    occ = occlude(*ray, casts)
    return shade_launch("K12 post", cfg, lanes, hit._replace(occluded=occ), rng, s, depth, scene)


def _shade_checks(name: str, cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng,
                  scene: ShadeScene) -> tuple:
    """K12's checks: every tensor the kernel reads has its dtype, its shape
    and layout on the card. Returns ``(n, faces, materials, lights)``, the
    tables in SHADE_PTRS order."""
    dev = hit.t.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, not {dev}")
    f32t, bt, it = torch.float32, torch.bool, torch.int32
    n = hit.t.shape[0] if hit.t.dim() == 1 else -1
    for group, dtype in (((*lanes.o, *lanes.d, *lanes.color, *lanes.light_val,
                           *lanes.final_color, hit.t), f32t),
                         ((lanes.alive, lanes.light_found), bt),
                         ((lanes.depth_added, lanes.secondary, hit.face), it),
                         ((rng._base,), torch.int64)):
        for x in group:
            _check(name, "a lane input", x, dev, dtype, n)
    phong = cfg.pt_alpha > 0.0
    if phong:
        for x in (hit.u, hit.v):
            _check(name, "the curved winner's (u, v)", x, dev, f32t, n)
    if name != "K12 pre" and cfg.nee:
        _check(name, "the occluded bit", hit.occluded, dev, bt, n)
    faces, mat_fields, light_fields = _scene_inputs(scene, phong)
    nf = scene.tris.mtl.shape[0] if scene.tris.mtl.dim() == 1 else -1
    for i, x in enumerate(faces):
        if x is not None:
            _check(name, f"face table {i}", x, dev, it if i == 0 else (bt if i == 19 else f32t),
                   nf)
    nm = scene.materials.d.shape[0] if scene.materials.d.dim() == 1 else -1
    for x in mat_fields:
        _check(name, "a material field", x, dev, f32t, nm)
    nl = scene.lights.count
    for i, x in enumerate(light_fields):
        _check(name, "a light field", x, dev, it if i == 7 else f32t, nl)
    if nm < 1 or (cfg.nee and nl < 1):
        raise ValueError(f"{name}: needs a material (got {nm}) and, with NEE, a light (got {nl})")
    return n, faces, mat_fields, light_fields


def shade_launch(name: str, cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int,
                 depth: int, scene: ShadeScene) -> tuple:
    """One launch of K12's instance ``name`` ("K12", "K12 pre" or "K12
    post") over checked CUDA inputs (``hit.occluded``: the occluded bit,
    where NEE is on and the instance is not "K12 pre"). Returns ``(lanes,
    casts)``, or for "K12 pre" the shadow ray ``(hit_p, l_dir, t_light,
    casts)``. chip_smoke.py times each instance alone."""
    n, faces, mat_fields, light_fields = _shade_checks(name, cfg, lanes, hit, rng, scene)
    dev, phong = hit.t.device, cfg.pt_alpha > 0.0
    f32t, bt, it = torch.float32, torch.bool, torch.int32
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    ins = [*lanes.o, *lanes.d, *lanes.color, *lanes.light_val, *lanes.final_color,
           lanes.alive, lanes.light_found, lanes.depth_added, lanes.secondary,
           hit.t, hit.face, hit.u if phong else None, hit.v if phong else None,
           hit.occluded if cfg.nee and name != "K12 pre" else None,
           rng._base, *faces, *mat_fields, *light_fields]
    if name == "K12 pre":
        ray = torch.empty((7, n), dtype=f32t, device=dev)
        casts = torch.empty((n,), dtype=bt, device=dev)
        outs = [None] * 19 + [casts] + [ray[j] for j in range(7)]
    else:
        fo = torch.empty((15, n), dtype=f32t, device=dev)
        bo = torch.empty((3 if cfg.nee else 2, n), dtype=bt, device=dev)
        io = torch.empty((2, n), dtype=it, device=dev)
        casts = bo[2] if cfg.nee else None
        outs = [*fo, bo[0], bo[1], io[0], io[1], casts] + [None] * 7
    ints = (ctypes.c_int * 6)(n, int(s), int(depth), cfg.max_depth, cfg.max_added_depth,
                              scene.lights.count)
    floats = (ctypes.c_float * 4)(*cfg.sky, f32(cfg.pt_alpha))
    lib = load("shade", "pbr_shade", _SHADE_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_shade(_ptr_array([ptr(x) for x in ins + outs]), ints, floats, cfg.brdf,
                            int(cfg.nee), int(cfg.transparency), int(phong), _MODES[name],
                            stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    count_launch(launches, name)
    if name == "K12 pre":
        return Vec3(ray[0], ray[1], ray[2]), Vec3(ray[3], ray[4], ray[5]), ray[6], casts
    v3 = lambda j: Vec3(fo[j], fo[j + 1], fo[j + 2])  # noqa: E731
    return Lanes(v3(0), v3(3), v3(6), bo[0], bo[1], v3(9), io[0], v3(12), io[1]), casts
