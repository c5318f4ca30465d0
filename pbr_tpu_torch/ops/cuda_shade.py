"""Kernels K11 and K12: the frame's elementwise shading, CUDA for Hopper, and
their backward, K11 bwd and K12 bwd; with their plain PyTorch versions.

The JAX package runs a frame as one XLA program, and XLA fuses the
elementwise work of ``trace_rays`` into a few loops, and that of its
``jax.grad`` too. These kernels are the port's counterpart of those fusions
(``csrc/shade.cu`` and ``csrc/shade_bwd.cu``, whose headers say what bounds
them and how the design answers it); they replace no Pallas kernel:

- **K11** (``gen_rays``): the camera rays of a sample, pinhole, AA jitter
  and thin-lens DoF (``pbr_tpu/models/integrator.py::_gen_rays``, :287);
- **K12** (``shade``): everything of a bounce after the search
  (``pbr_tpu/models/integrator.py:579-833``, with ``_orb_pass`` at :324),
  one template over BRDF x NEE x transparency x Phong with three instances:
  "K12" (fused: the occluded bit came with the search, or there is no NEE;
  one launch a bounce), "K12 pre" (writes the shadow ray for a shadow leg
  that is a walk of its own) and "K12 post" (finishes the bounce from that
  walk's occluded bit);
- **K11 bwd** and **K12 bwd**: their adjoints where autograd records the
  frame, run by the autograd Functions ``_GenRaysFn`` and ``_ShadeFn``.

``gen_rays_plain`` and ``shade_plain`` are the integrator's torch ops, moved
here with the same operations in the same order; ``gen_rays_vjp_plain`` and
``shade_vjp_plain`` their adjoints written out by hand in torch ops, no
autograd. The kernels are held bitwise to them on the card (the backward's
sums over the lanes to a tolerance: they sum in another order).

Dispatch: a CPU tensor runs the plain version, a CUDA tensor the kernel,
which raises when it does not build or launch. Where
``torch.is_grad_enabled()`` and an input that the step differentiates
requires grad, the step runs inside its Function, on either device: the
forward as above, the backward K11 bwd / K12 bwd on the card and the plain
adjoint on the CPU, flat-shaded and Phong bounces alike (a curved face's
shading normal is a constant of what the step differentiates: the geometry
and the winner's (u, v) are detached, and ``d`` picks between two normals
by a select). ``launches`` counts kernel launches ("K11", "K12", "K12
pre", "K12 post", "K11 bwd", "K12 bwd"); a launch under capture counts at
its graph's replays (``ops.counts``). Nothing is built or imported for
CUDA when this module is imported.
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
    fresnel_vjp,
    refract_dir,
    sa_eval,
    sa_eval_vjp,
    sa_sample,
    schlick_eval,
    schlick_eval_vjp,
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
from pbr_tpu_torch.ops.vec import (
    Vec3,
    f32,
    jitter,
    jitter_vjp,
    max_weight,
    normalized_vjp,
    safe_div,
    safe_sqrt,
    sum3,
    where3,
)
from pbr_tpu_torch.scene.camera import pixel_dim
from pbr_tpu_torch.utils.config import BRDF_SCHLICK, RenderSettings

launches = {"K11": 0, "K12": 0, "K12 pre": 0, "K12 post": 0, "K11 bwd": 0, "K12 bwd": 0}

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
# K12 bwd's pointer slots (csrc/shade_bwd.cu's BwdPtr): what the forward
# read of the lanes and the tables, the outputs' gradients (G_*), the
# inputs' gradients written (D_*; the final colour's is G_F itself), the
# warps' rows where they do not fit in shared memory, the blocks' partial
# table rows, the table gradient and the count of finished blocks.
SHADE_BWD_PTRS = (
    "I_OX", "I_OY", "I_OZ", "I_DX", "I_DY", "I_DZ", "I_CX", "I_CY", "I_CZ",
    "I_ALIVE", "I_ADDED", "I_T", "I_FACE", "I_U", "I_V", "I_OCC", "I_KEY",
    "F_MTL", "F_E1X", "F_E1Y", "F_E1Z", "F_E2X", "F_E2Y", "F_E2Z", "F_V0X", "F_V0Y", "F_V0Z",
    "F_N0X", "F_N0Y", "F_N0Z", "F_N1X", "F_N1Y", "F_N1Z", "F_N2X", "F_N2Y", "F_N2Z", "F_FLAT",
    "M_D", "M_NI", "M_ROUGH", "M_P", "M_NU", "M_NV", "M_RS", "M_RD",
    "M_KDX", "M_KDY", "M_KDZ", "M_KSX", "M_KSY", "M_KSZ",
    "L_PX", "L_PY", "L_PZ", "L_RX", "L_RY", "L_RZ", "L_RAD", "L_TYPE",
    "G_OX", "G_OY", "G_OZ", "G_DX", "G_DY", "G_DZ", "G_CX", "G_CY", "G_CZ",
    "G_LX", "G_LY", "G_LZ", "G_FX", "G_FY", "G_FZ",
    "D_OX", "D_OY", "D_OZ", "D_DX", "D_DY", "D_DZ", "D_CX", "D_CY", "D_CZ",
    "D_LX", "D_LY", "D_LZ", "D_T",
    "W_TABLE", "P_TABLE", "O_TABLE", "C_DONE",
)
# K11 bwd's pointer slots (csrc/shade_bwd.cu's GenBwdPtr).
GEN_BWD_PTRS = (
    "G_PX", "G_PY", "G_KEY", "G_PREV_T",
    "G_EYEX", "G_EYEY", "G_EYEZ", "G_WX", "G_WY", "G_WZ", "G_UX", "G_UY", "G_UZ",
    "G_VX", "G_VY", "G_VZ", "G_FOCAL", "G_APERTURE", "G_FOCUS",
    "G_GOX", "G_GOY", "G_GOZ", "G_GDX", "G_GDY", "G_GDZ",
    "P_CAMERA", "O_CAMERA", "C_CAMERA_DONE",
)
# The backward kernels' largest grid (8 blocks of 256 lanes on each of the
# H100's 132 SMs); a block's partial row of the table is its warps' rows
# summed in warp order, and the last block to finish sums the rows in block
# order. The warps' rows live in shared memory where a block's 8 fit
# (_SMEM_MAX), else in a global scratch of at most _SCRATCH_MAX bytes,
# which caps the grid.
BWD_BLOCKS = 1056
_SMEM_MAX = 232448  # the shared memory a block may have on sm_90
_SCRATCH_MAX = 256 << 20
_P, _I = ctypes.c_void_p, ctypes.c_int
# ptrs, ints, floats, brdf, nee, transparency, phong, mode, stream
_SHADE_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
# ptrs, n, sample, floats, stream
_GEN_ARGTYPES = [_P, _I, _I, _P, _P]
# ptrs, ints, alpha, brdf, nee, transparency, phong, stream
_SHADE_BWD_ARGTYPES = [_P, _P, ctypes.c_float, _I, _I, _I, _I, _P]
# ptrs, n, sample, blocks, floats, stream
_GEN_BWD_ARGTYPES = [_P, _I, _I, _I, _P, _P]


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


class _Setup(NamedTuple):
    """A bounce's state up to its shading, which ``shade_plain`` and its
    adjoint share: the orb hit of a missed lane, the hit and miss masks, the
    material index and fields, the geometric (or Phong) normal, the
    bounce's RNG, the extension decision, the lanes alive after the miss and
    the last-bounce break, the live lanes and the hit point."""

    orb_idx: torch.Tensor
    hit_m: torch.Tensor
    miss: torch.Tensor
    midx: torch.Tensor
    mats: tuple
    normal: Vec3
    rb: object
    extend: torch.Tensor
    alive: torch.Tensor
    live: torch.Tensor
    hit_p: Vec3


def _setup(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
           scene: ShadeScene) -> _Setup:
    o, d, alive = lanes.o, lanes.d, lanes.alive
    t, face = hit.t, hit.face
    tris, lights = scene.tris, scene.lights
    if lights.count:
        orb_idx = _orb_pass(o, d, lights, t)
    else:
        orb_idx = torch.full(t.shape, -1, dtype=_I32, device=t.device)
    finite = torch.isfinite(t)
    hit_m = finite & alive
    miss = alive & ~finite
    alive = alive & ~miss

    # ---- material & geometric normal -----------------------------------
    face_safe = face.clamp_min(0)
    midx = tris.mtl[face_safe]
    mats = gather_materials(scene.materials, midx)
    m_d, m_rough, m_nu, m_nv = mats[0], mats[2], mats[4], mats[5]
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
    is_last = depth == (cfg.max_depth + lanes.depth_added - 1)
    alive = alive & ~(hit_m & (m_d == 1.0) & ~extend & is_last)
    live = hit_m & alive

    # ---- hit point (guarded for dead lanes) ----------------------------
    hit_p = o + d * torch.where(hit_m, t, 1.0)
    return _Setup(orb_idx, hit_m, miss, midx, mats, normal, rb, extend, alive, live, hit_p)


def _new_direction(cfg: ShadeConfig, d: Vec3, normal: Vec3, mats: tuple, rb) -> tuple:
    """The bounce's sampled direction (getNewRay, pt_brdf.cl:344-378),
    detached, and its transmit lanes (None where every material is
    opaque)."""
    m_d, m_ni, m_rough, m_p, m_nu, m_nv = mats[:6]
    ra, rbb, rc = rb.u(S_BRDF_A), rb.u(S_BRDF_B), rb.u(S_BRDF_C)
    if cfg.brdf == BRDF_SCHLICK:
        new_d = schlick_sample(d, normal, m_rough, m_p, ra, rbb, rc)
    else:
        new_d = sa_sample(d, normal, m_d, m_nu, m_nv, ra, rbb, rc)
    do_trans = None
    if cfg.transparency:
        # Without it every material is opaque: the transmit branch is dead,
        # and its two draws are skipped (streams are keyed independently).
        do_trans = (m_d < 1.0) & (m_d <= rb.u(S_TRANS))
        new_d = where3(do_trans, refract_dir(d, normal, m_ni, rb.u(S_REFR)), new_d)
    # Detached sampling: sample positions carry no gradient.
    return new_d.detach(), do_trans


def shade_plain(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
                scene: ShadeScene, occlude: Optional[Callable] = None) -> tuple:
    """One bounce's shade after the search (the integrator's ``bounce``
    below its intersect step). ``occlude(hit_p, l_dir, t_light, casts)``
    gives the occluded bit of the lanes that cast a shadow ray where
    ``hit.occluded`` is None and NEE is on. Returns ``(lanes, casts)``,
    ``casts`` None without NEE."""
    o, d, color, _, light_found, light_val, depth_added, final_color, secondary = lanes
    lights = scene.lights
    st = _setup(cfg, lanes, hit, rng, s, depth, scene)
    m_d, m_ni, m_rough, m_p, m_nu, m_nv, m_rs, m_rd, m_kd, m_ks = st.mats
    live, hit_p, normal = st.live, st.hit_p, st.normal
    zero3 = _zeros3(hit.t)
    # ---- miss: sky or orb emission (pathtracing.cl:263-266) ------------
    miss = st.miss
    is_orb = miss & (st.orb_idx >= 0)
    orb_safe = st.orb_idx.clamp_min(0)
    orb_rgb = zero3
    for li in range(lights.count):
        orb_rgb = where3(
            orb_safe == li,
            Vec3(lights.rgb.x[li], lights.rgb.y[li], lights.rgb.z[li]),
            orb_rgb,
        )
    light_val = where3(miss, where3(is_orb, orb_rgb, Vec3(*cfg.sky)), light_val)
    light_found = light_found | miss

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
    new_d, do_trans = _new_direction(cfg, d, normal, st.mats, st.rb)
    add_depth = st.extend if do_trans is None else st.extend | do_trans

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
    alive = st.alive & ((depth + 1) < cfg.max_depth + depth_added)
    rr = (depth > 2 + depth_added) & (color.max_component() < st.rb.u(S_RR))
    alive = alive & ~rr

    out = Lanes(where3(live, hit_p, o), where3(live, new_d, d), color, alive, light_found,
                light_val, depth_added, final_color, secondary)
    return out, casts


# ---------------------------------------------------------------------------
# Plain adjoints: the backward kernels' plain versions
# ---------------------------------------------------------------------------


class LaneGrads(NamedTuple):
    """Gradients of a bounce's differentiable lane state, (B,) float32
    Vec3s: upstream, those of ``shade``'s outputs; returned, those of its
    inputs (with ``t``, the hit distance's, beside them)."""

    o: Vec3
    d: Vec3
    color: Vec3
    light_val: Vec3
    final_color: Vec3


class TableTerms(NamedTuple):
    """Each lane's terms of the table gradients before they are summed:
    ``mat`` (14, B) the material fields' (``SHADE_TABLE`` order) for
    material ``midx``; ``pos`` (3, B) light 0's position; ``rgb`` (3, B)
    the colour of light ``rgb_light`` (-1: none)."""

    mat: torch.Tensor
    midx: torch.Tensor
    pos: torch.Tensor
    rgb: torch.Tensor
    rgb_light: torch.Tensor


# The flat table gradient's rows, M entries each (materials) or L (lights).
SHADE_TABLE = ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd", "kd.x", "kd.y", "kd.z",
               "ks.x", "ks.y", "ks.z", "pos.x", "pos.y", "pos.z", "rgb.x", "rgb.y", "rgb.z")
# The camera gradient's entries, in GEN_PTRS order.
CAMERA_FIELDS = ("eye.x", "eye.y", "eye.z", "w.x", "w.y", "w.z", "u.x", "u.y", "u.z",
                 "v.x", "v.y", "v.z", "focal_length", "aperture", "focus")


def _finite_g(v: Vec3, g: Vec3) -> Vec3:
    """``_sanitize3(v)``'s adjoint: ``g`` where ``v`` is finite, else 0."""
    f = lambda c, gc: torch.where(torch.isfinite(c), gc, 0.0)  # noqa: E731
    return Vec3(f(v.x, g.x), f(v.y, g.y), f(v.z, g.z))


def _schlick_inner_vjp(u, ks: Vec3, w, m_d, g: Vec3) -> tuple:
    """``inner = fresnel(u, ks) * w * m_d + (1 - m_d)``'s adjoint:
    ``(g_u, g_ks, g_w, g_md)``."""
    f = fresnel(u, ks)
    fw = f * w
    g_fw = g * m_d
    g_md = sum3(g * fw) - sum3(g)
    g_w = sum3(g_fw * f)
    g_u, g_ks = fresnel_vjp(u, ks, g_fw * w)
    return g_u, g_ks, g_w, g_md


def _sa_bc_vjp(spec, diff, hk1, pdf, m: tuple, g: Vec3) -> tuple:
    """``_clip01(_norm_rgb(bc))``'s adjoint, ``bc = (ks b_s + kd b_d) m_d +
    (1 - m_d)`` with ``b_s = spec / pdf * fresnel(hk1, Rs)``, ``b_d = diff
    Rd / pdf * (1 - Rs)``: ``(g_spec, g_diff, g_hk1, g_pdf, g_md, g_rs,
    g_rd, g_kd, g_ks)``."""
    m_d, m_rs, m_rd, m_kd, m_ks = m[0], m[6], m[7], m[8], m[9]
    sp = spec / pdf
    fs = fresnel(hk1, m_rs)
    b_s = sp * fs
    q = diff * m_rd / pdf
    omr = 1.0 - m_rs
    b_d = q * omr
    s_ = m_ks * b_s + m_kd * b_d
    bc = s_ * m_d + (1.0 - m_d)
    mc = bc.max_component()
    den = torch.maximum(_ONE, mc)
    bcn = bc / den
    # clip to [0, 1]: minimum(maximum(c, 0), 1)
    g_mx = Vec3(*(gc * max_weight(1.0, torch.maximum(c, _ZERO)) for gc, c in zip(g, bcn)))
    g_bcn = Vec3(*(gc * max_weight(c, 0.0) for gc, c in zip(g_mx, bcn)))
    # bc / maximum(1, maximum(maximum(x, y), z))
    g_mc = -sum3(g_bcn * bcn) / den * max_weight(mc, 1.0)
    m1 = torch.maximum(bc.x, bc.y)
    g_m1 = g_mc * max_weight(m1, bc.z)
    g_bc = g_bcn / den
    g_bc = Vec3(g_bc.x + g_m1 * max_weight(bc.x, bc.y), g_bc.y + g_m1 * max_weight(bc.y, bc.x),
                g_bc.z + g_mc * max_weight(bc.z, m1))
    g_s = g_bc * m_d
    g_md = sum3(g_bc * s_) - sum3(g_bc)
    g_bs = sum3(g_s * m_ks)
    g_bd = sum3(g_s * m_kd)
    g_q = g_bd * omr
    g_sp = g_bs * fs
    g_hk1, g_rs = fresnel_vjp(hk1, m_rs, g_bs * sp)
    g_dr = g_q / pdf
    g_pdf = -(g_sp * sp) / pdf - (g_q * q) / pdf
    return (g_sp / pdf, g_dr * m_rd, g_hk1, g_pdf, g_md, g_rs - g_bd * q, g_dr * diff,
            g_s * b_d, g_s * b_s)


def shade_vjp_terms(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
                    scene: ShadeScene, g: LaneGrads) -> tuple:
    """The adjoint of ``shade_plain`` given its outputs' gradients ``g``,
    each lane's table terms unsummed: ``(LaneGrads, g_t, TableTerms)``.
    ``hit.occluded`` is the bit the forward used, where NEE is on. Torch
    ops, no autograd, in the order of ``csrc/shade_bwd.cu``'s K12 bwd,
    which recomputes the bounce from the same inputs: a live lane's
    direction gets its gradient through the hit point and the two BRDF
    evaluations (the sampled direction is detached), a dead lane passes
    ``o``, ``d`` and the colour through, a missed lane's light value goes
    to its orb's colour. The shading normal, geometric or Phong, gets no
    gradient: the triangles and the winner's (u, v) are detached, and ``d``
    reaches the curved normal only through the select between the patch's
    normal and the interpolated one (``phongtess_normal``)."""
    o, d, color = lanes.o, lanes.d, lanes.color
    t = hit.t
    lights = scene.lights
    st = _setup(cfg, lanes, hit, rng, s, depth, scene)
    m = st.mats
    m_d, m_rough, m_p, m_nu, m_nv, m_kd, m_ks = m[0], m[2], m[3], m[4], m[5], m[8], m[9]
    live, normal = st.live, st.normal
    schlick = cfg.brdf == BRDF_SCHLICK
    zero = torch.zeros_like(t)
    n_sh = where3(normal.dot(-d) <= 0.0, -normal, normal)
    new_d, _ = _new_direction(cfg, d, normal, m, st.rb)
    # Material terms, SHADE_TABLE order; Ni's stays 0 (only the detached
    # refraction reads it).
    mt = [zero] * 14

    # ---- throughput: color' = color * mult ------------------------------
    g_col = Vec3(*(torch.where(live, c, 0.0) for c in g.color))
    if schlick:
        brdf_b, u_b, pdf_b = schlick_eval(n_sh, d, new_d, m_rough, m_p)
        pok = live & (torch.abs(pdf_b) > f32(1e-7))
        pdf_bs = torch.where(pok, pdf_b, 1.0)
        cl_b = n_sh.dot(new_d).clamp_min(0.0)
        w_b = brdf_b * cl_b / pdf_bs
        inner = fresnel(u_b, m_ks) * w_b * m_d + (1.0 - m_d)
        mult0 = m_kd * inner
        mult = _sanitize3(mult0)
        g_m0 = _finite_g(mult0, g_col * color)
        g_ub, g_ks, g_w, g_md = _schlick_inner_vjp(u_b, m_ks, w_b, m_d, g_m0 * m_kd)
        g_pdf = torch.where(pok, -(g_w * w_b) / pdf_bs, 0.0)
        g_dout, _, g_r, g_p = schlick_eval_vjp(n_sh, d, new_d, m_rough, m_p,
                                               g_w / pdf_bs * cl_b, g_ub, g_pdf)
        mt[0], mt[2], mt[3] = g_md, g_r, g_p
        mt[8:11], mt[11:14] = g_m0 * inner, g_ks
    else:
        spec_b, diff_b, hk1_b, pdf_b = sa_eval(n_sh, d, new_d, m_nu, m_nv)
        pok = live & (torch.abs(pdf_b) > f32(1e-7))
        pdf_bs = torch.where(pok, pdf_b, 1.0)
        bcc = _clip01(_norm_rgb((m_ks * ((spec_b / pdf_bs) * fresnel(hk1_b, m[6]))
                                 + m_kd * ((diff_b * m[7] / pdf_bs) * (1.0 - m[6]))) * m_d
                                + (1.0 - m_d)))
        mult = _sanitize3(bcc)
        g_sp, g_df, g_hk, g_pdf, g_md, g_rs, g_rd, g_kd, g_ks = _sa_bc_vjp(
            spec_b, diff_b, hk1_b, pdf_bs, m, _finite_g(bcc, g_col * color))
        g_dout, _, g_nu, g_nv = sa_eval_vjp(n_sh, d, new_d, m_nu, m_nv, g_sp, g_df, g_hk,
                                            torch.where(pok, g_pdf, 0.0))
        mt[0], mt[4], mt[5], mt[6], mt[7] = g_md, g_nu, g_nv, g_rs, g_rd
        mt[8:11], mt[11:14] = g_kd, g_ks
    g_color = g_col * mult
    g_d = g_dout
    g_hp = Vec3(*(torch.where(live, c, 0.0) for c in g.o))
    pos = _zeros3(t)
    rgb = _zeros3(t)
    rgb_light = torch.full(t.shape, -1, dtype=_I32, device=t.device)

    # ---- NEE: final' = final + sanitize(contrib) on the lanes it lights --
    if cfg.nee:
        l_vec = Vec3(lights.pos.x[0], lights.pos.y[0], lights.pos.z[0]) - st.hit_p
        l2 = l_vec.length2()
        t_light = safe_sqrt(l2)
        inv = safe_div(1.0, t_light)
        l_dir = l_vec * inv
        l_rgb = Vec3(lights.rgb.x[0], lights.rgb.y[0], lights.rgb.z[0])
        nee_ok = live & (m_d > 0.0) & ~hit.occluded
        nt = [zero] * 14
        if schlick:
            brdf_l, u_l, pdf_l = schlick_eval(n_sh, d, l_dir, m_rough, m_p)
            ok = nee_ok & (torch.abs(pdf_l) > f32(1e-5))
            pdf_ls = torch.where(ok, pdf_l, 1.0)
            x_l = n_sh.dot(l_dir)
            w_l = brdf_l * x_l.clamp_min(0.0) / pdf_ls
            inner = fresnel(u_l, m_ks) * w_l * m_d + (1.0 - m_d)
            c1 = color * l_rgb
            c2 = c1 * m_kd
            g_c = _finite_g(c2 * inner, Vec3(*(torch.where(ok, c, 0.0) for c in g.final_color)))
            g_c2 = g_c * inner
            g_c1 = g_c2 * m_kd
            g_ul, g_ks, g_w, g_md = _schlick_inner_vjp(u_l, m_ks, w_l, m_d, g_c * c2)
            g_bc = g_w / pdf_ls
            g_dn, g_ldir, g_r, g_p = schlick_eval_vjp(
                n_sh, d, l_dir, m_rough, m_p, g_bc * x_l.clamp_min(0.0), g_ul,
                torch.where(ok, -(g_w * w_l) / pdf_ls, 0.0))
            g_ldir = g_ldir + n_sh * torch.where(x_l >= 0.0, g_bc * brdf_l, 0.0)
            g_cn = g_c1 * l_rgb
            g_lrgb = g_c1 * color
            nt[0], nt[2], nt[3] = g_md, g_r, g_p
            nt[8:11], nt[11:14] = g_c2 * c1, g_ks
        else:
            spec_l, diff_l, hk1_l, pdf_l = sa_eval(n_sh, d, l_dir, m_nu, m_nv)
            ok = nee_ok & (torch.abs(pdf_l) > f32(1e-5))
            pdf_ls = torch.where(ok, pdf_l, 1.0)
            bcc = _clip01(_norm_rgb((m_ks * ((spec_l / pdf_ls) * fresnel(hk1_l, m[6]))
                                     + m_kd * ((diff_l * m[7] / pdf_ls) * (1.0 - m[6]))) * m_d
                                    + (1.0 - m_d)))
            bl = bcc * l_rgb
            g_c = _finite_g(bl * m_d + (1.0 - m_d),
                            Vec3(*(torch.where(ok, c, 0.0) for c in g.final_color)))
            g_bl = g_c * m_d
            g_sp, g_df, g_hk, g_pdf, g_md, g_rs, g_rd, g_kd, g_ks = _sa_bc_vjp(
                spec_l, diff_l, hk1_l, pdf_ls, m, g_bl * l_rgb)
            g_dn, g_ldir, g_nu, g_nv = sa_eval_vjp(n_sh, d, l_dir, m_nu, m_nv, g_sp, g_df, g_hk,
                                                   g_pdf)
            g_lrgb = g_bl * bcc
            nt[0] = g_md + (sum3(g_c * bl) - sum3(g_c))
            nt[4], nt[5], nt[6], nt[7] = g_nu, g_nv, g_rs, g_rd
            nt[8:11], nt[11:14] = g_kd, g_ks
        # l_dir = l_vec * safe_div(1, t_light), t_light = safe_sqrt(l_vec . l_vec)
        g_tl = torch.where(torch.abs(t_light) > 1e-12, g_ldir.dot(l_vec) * -(inv * inv), 0.0)
        g_l2 = torch.where(l2 > 0.0, g_tl / (2.0 * t_light), 0.0)
        g_lvec = g_ldir * inv + l_vec * (g_l2 * 2.0)
        okv = lambda v: Vec3(*(torch.where(ok, c, 0.0) for c in v))  # noqa: E731
        g_lvec = okv(g_lvec)
        if schlick:
            g_color = g_color + okv(g_cn)
        g_d = g_d + okv(g_dn)
        g_hp = g_hp - g_lvec
        mt = [a + torch.where(ok, b, 0.0) for a, b in zip(mt, nt)]
        pos = g_lvec
        rgb = okv(g_lrgb)
        rgb_light = torch.where(ok, 0, rgb_light)

    # ---- the hit point o + d t, and what passes a dead lane -------------
    g_d = g_d + g_hp * t
    g_t = torch.where(live, g_hp.dot(d), 0.0)
    sel = lambda a, b: Vec3(*(torch.where(live, x, y) for x, y in zip(a, b)))  # noqa: E731
    is_orb = st.miss & (st.orb_idx >= 0)
    g_lv = Vec3(*(torch.where(st.miss, 0.0, c) for c in g.light_val))
    rgb = Vec3(*(torch.where(is_orb, a, b) for a, b in zip(g.light_val, rgb)))
    rgb_light = torch.where(is_orb, st.orb_idx, rgb_light)
    mat = torch.stack([torch.where(live, x, 0.0) for x in mt])
    terms = TableTerms(mat, st.midx, pos.stack(torch).T, rgb.stack(torch).T, rgb_light)
    return (LaneGrads(sel(g_hp, g.o), sel(g_d, g.d), sel(g_color, g.color), g_lv,
                      g.final_color), g_t, terms)


def table_sum(terms: TableTerms, n_mat: int, n_light: int, dtype=torch.float32) -> torch.Tensor:
    """The flat table gradient (``SHADE_TABLE`` rows: 14 of ``n_mat``
    entries, 6 of ``n_light``) of each lane's ``terms``, summed in
    ``dtype``."""
    dev = terms.mat.device
    mat = torch.zeros((14, n_mat), dtype=dtype, device=dev)
    mat.index_add_(1, terms.midx.long(), terms.mat.to(dtype))
    pos = torch.zeros((3, n_light), dtype=dtype, device=dev)
    if n_light:
        pos[:, 0] = terms.pos.to(dtype).sum(dim=1)
    rgb = torch.zeros((3, n_light), dtype=dtype, device=dev)
    has = terms.rgb_light >= 0
    rgb.index_add_(1, terms.rgb_light.clamp_min(0).long(),
                   torch.where(has, terms.rgb.to(dtype), 0.0))
    return torch.cat([mat.reshape(-1), pos.reshape(-1), rgb.reshape(-1)])


def shade_vjp_plain(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
                    scene: ShadeScene, g: LaneGrads) -> tuple:
    """K12 bwd's plain version: ``(LaneGrads, g_t, table)``, the table
    gradient flat (``table_sum``) of ``shade_vjp_terms``."""
    lane, g_t, terms = shade_vjp_terms(cfg, lanes, hit, rng, s, depth, scene, g)
    return lane, g_t, table_sum(terms, int(scene.materials.d.shape[0]), scene.lights.count)


def gen_rays_vjp_terms(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t,
                       g_o: Vec3, g_d: Vec3) -> torch.Tensor:
    """The adjoint of ``gen_rays_plain`` with respect to the camera's 15
    scalars (``CAMERA_FIELDS``), each lane's terms unsummed: (15, B). Torch
    ops, no autograd, in the order of ``csrc/shade_bwd.cu``'s K11 bwd."""
    c_fx, c_fy, half_px, aa_scale = _gen_consts(settings)
    eye, cw, cu, cv = cam.eye, cam.w, cam.u, cam.v
    fx = c_fx + 2.0 * px
    fy = c_fy + 2.0 * py
    q = cw + (cu * fx + cv * fy) * half_px
    d0 = q.normalized()
    r0 = rng.at(s, 0)
    rnd = r0.u(S_AA_R)
    phi = PI_X2 * r0.u(S_AA_PHI)
    sina, cosa = torch.sqrt(rnd), torch.sqrt(1.0 - rnd)
    q1 = d0 + jitter(d0, phi, sina, cosa) * aa_scale
    d1 = q1.normalized()
    t_obj = torch.where(torch.isfinite(prev_t), prev_t, 1000.0)
    fin = torch.isfinite(cam.focus)
    t_foc = torch.where(fin, cam.focus, 1000.0)
    lens = cam.focal_length / cam.aperture
    u_r = r0.u(S_DOF_R)
    radius = u_r * lens * 0.5
    angle = PI_X2 * r0.u(S_DOF_PHI)
    ca, sa = torch.cos(angle), torch.sin(angle)
    o_dof = eye + cu * (radius * ca) + cv * (radius * sa)
    q2 = eye + d1 * t_foc - o_dof
    use = (cam.focus >= 0.0) & (t_obj > 0.0)
    msk = lambda v: Vec3(*(torch.where(use, c, 0.0) for c in v))  # noqa: E731
    # The lens: o' = o_dof, d' = normalized(eye + d1 t_foc - o_dof).
    g_q2 = normalized_vjp(q2, msk(g_d))
    g_od = msk(g_o) - g_q2
    g_eye = Vec3(*(torch.where(use, a, b) for a, b in zip(g_q2 + g_od, g_o)))
    g_d1 = Vec3(*(torch.where(use, a, b) for a, b in zip(g_q2 * t_foc, g_d)))
    g_rad = g_od.dot(cu) * ca + g_od.dot(cv) * sa
    g_lens = g_rad * 0.5 * u_r
    g_focus = torch.where(use & fin, g_q2.dot(d1), 0.0)
    g_focal = torch.where(use, g_lens / cam.aperture, 0.0)
    g_aperture = torch.where(use, -(g_lens * lens) / cam.aperture, 0.0)
    # The jitter and the pinhole: d1 = normalized(d0 + jitter(d0) aa),
    # d0 = normalized(w + (u fx + v fy) half_px).
    g_q1 = normalized_vjp(q1, g_d1)
    g_q = normalized_vjp(q, g_q1 + jitter_vjp(d0, phi, sina, cosa, g_q1 * aa_scale))
    g_t3 = g_q * half_px
    g_u = g_t3 * fx + g_od * (radius * ca)
    g_v = g_t3 * fy + g_od * (radius * sa)
    return torch.stack([*g_eye, *g_q, *g_u, *g_v, g_focal, g_aperture, g_focus])


def gen_rays_vjp_plain(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t,
                       g_o: Vec3, g_d: Vec3) -> torch.Tensor:
    """K11 bwd's plain version: the camera's 15 gradients (``CAMERA_FIELDS``),
    a (15,) tensor, of ``gen_rays_vjp_terms`` summed over the lanes."""
    return gen_rays_vjp_terms(cam, settings, px, py, rng, s, prev_t, g_o, g_d).sum(dim=1)


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


def _cam_fields(cam) -> tuple:
    """The camera's 15 scalars in ``CAMERA_FIELDS`` (and GEN_PTRS) order."""
    return (*cam.eye, *cam.w, *cam.u, *cam.v, cam.focal_length, cam.aperture, cam.focus)


def gen_rays(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t):
    """The camera rays of sample ``s`` (``gen_rays_plain``'s contract):
    ``(o, d)``, Vec3s of (B,) float32. On a CUDA ``px`` the kernel K11
    (``gen_rays_launch``), on the CPU the plain version; where autograd
    records a camera field that requires grad, either through
    ``_GenRaysFn``, whose backward is K11 bwd on the card
    (``gen_rays_bwd_launch``) and ``gen_rays_vjp_plain`` on the CPU."""
    if _wants_grad(_cam_fields(cam)):
        out = _GenRaysFn.apply((cam, settings, px, py, rng, s, prev_t), *_cam_fields(cam))
        return Vec3(*out[:3]), Vec3(*out[3:])
    if px.device.type == "cpu":
        return gen_rays_plain(cam, settings, px, py, rng, s, prev_t)
    return gen_rays_launch(cam, settings, px, py, rng, s, prev_t)


def _gen_checks(who: str, cam, px, py, rng: PixelRng, prev_t) -> int:
    """K11's and K11 bwd's checks of what they read; returns the lanes."""
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"{who} runs on CUDA tensors, not {dev}")
    n = px.shape[0] if px.dim() == 1 else -1
    _check(who, "px", px, dev, torch.float32, n)
    _check(who, "py", py, dev, torch.float32, n)
    _check(who, "prev_t", prev_t, dev, torch.float32, n)
    _check(who, "the RNG keys", rng._base, dev, torch.int64, n)
    for i, c in enumerate(_cam_fields(cam)):
        _check(who, f"camera field {i}", c, dev, torch.float32)
        if c.numel() != 1:
            raise ValueError(f"{who}: camera field {i} must hold one float, got {c.numel()}")
    return n


def gen_rays_launch(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t):
    """One launch of K11 over checked CUDA inputs (``gen_rays``' contract):
    the camera's fields 0-d or one-element float32 tensors on the card,
    ``px``, ``py`` and ``prev_t`` (B,) float32, ``rng``'s keys (B,) int64,
    all read on the device."""
    dev = px.device
    n = _gen_checks("K11", cam, px, py, rng, prev_t)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    ptrs = [px.data_ptr(), py.data_ptr(), rng._base.data_ptr(), prev_t.data_ptr(),
            *(c.data_ptr() for c in _cam_fields(cam)), *(out[j].data_ptr() for j in range(6))]
    consts = (ctypes.c_float * 4)(*_gen_consts(settings))
    lib = load("shade", "pbr_gen_rays", _GEN_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_gen_rays(_ptr_array(ptrs), n, int(s), consts, stream)
    if err != 0:
        raise RuntimeError(f"K11 launch failed: cudaError {err}")
    count_launch(launches, "K11")
    return Vec3(out[0], out[1], out[2]), Vec3(out[3], out[4], out[5])


def _bwd_blocks(n: int) -> int:
    """The backward kernels' grid: one block a 256-lane chunk, at most
    ``BWD_BLOCKS`` (each then takes every ``BWD_BLOCKS``-th chunk). Fixed by
    ``n`` alone, so the sums' order, and their bits, repeat."""
    return max(1, min(-(-n // 256), BWD_BLOCKS))


def gen_rays_bwd_launch(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t,
                        g_o: Vec3, g_d: Vec3) -> torch.Tensor:
    """K11 bwd over checked CUDA inputs (``gen_rays_vjp_plain``'s contract):
    each lane's camera terms, recomputed from K11's inputs, summed in a
    fixed order (a block's partial row, then the last block to finish sums
    the rows in order): the (15,) gradient of ``CAMERA_FIELDS``."""
    dev = px.device
    n = _gen_checks("K11 bwd", cam, px, py, rng, prev_t)
    grads = [c.contiguous() for c in (*g_o, *g_d)]
    for c in grads:
        _check("K11 bwd", "an output's gradient", c, dev, torch.float32, n)
    blocks = _bwd_blocks(n)
    part = torch.empty((blocks, 15), dtype=torch.float32, device=dev)
    out = torch.empty((15,), dtype=torch.float32, device=dev)
    done = torch.zeros((1,), dtype=torch.int32, device=dev)
    ptrs = [px.data_ptr(), py.data_ptr(), rng._base.data_ptr(), prev_t.data_ptr(),
            *(c.data_ptr() for c in _cam_fields(cam)), *(c.data_ptr() for c in grads),
            part.data_ptr(), out.data_ptr(), done.data_ptr()]
    consts = (ctypes.c_float * 4)(*_gen_consts(settings))
    lib = load("shade_bwd", "pbr_gen_rays_bwd", _GEN_BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_gen_rays_bwd(_ptr_array(ptrs), n, int(s), blocks, consts, stream)
    if err != 0:
        raise RuntimeError(f"K11 bwd launch failed: cudaError {err}")
    count_launch(launches, "K11 bwd")
    return out


class _Leaf(int):
    """A tensor's place in the list that ``_save`` hands to
    ``ctx.save_for_backward``."""


def _strip(x, leaves: list):
    """``x`` with each tensor in it (in tuples, NamedTuples and a
    ``PixelRng``) replaced by its ``_Leaf`` in ``leaves``, which it joins."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _Leaf(len(leaves) - 1)
    if isinstance(x, PixelRng):
        return (PixelRng, _strip(x._base, leaves))
    if isinstance(x, tuple):
        vals = [_strip(v, leaves) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _dress(x, leaves):
    """``_strip``'s inverse over the saved tensors ``leaves``."""
    if isinstance(x, _Leaf):
        return leaves[x]
    if isinstance(x, tuple) and x and x[0] is PixelRng:
        r = object.__new__(PixelRng)
        r._base = _dress(x[1], leaves)
        return r
    if isinstance(x, tuple):
        vals = [_dress(v, leaves) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _save(ctx, call: tuple) -> None:
    """Saves ``call``'s tensors with ``ctx.save_for_backward`` (autograd
    then checks that nothing wrote to them before the backward) and its
    structure beside them; ``_saved`` gives the call back."""
    leaves = []
    ctx.layout = _strip(call, leaves)
    ctx.save_for_backward(*leaves)


def _saved(ctx) -> tuple:
    return _dress(ctx.layout, ctx.saved_tensors)


class _GenRaysFn(torch.autograd.Function):
    """The camera rays where autograd records the camera: forward K11 on
    the card, ``gen_rays_plain`` on the CPU; backward K11 bwd on the card,
    ``gen_rays_vjp_plain`` on the CPU. The inputs are the camera's 15
    scalars; it saves the inputs alone (the backward recomputes the
    rest)."""

    @staticmethod
    def forward(ctx, call, *fields):
        cam, settings, px, py, rng, s, prev_t = call
        run = gen_rays_plain if px.device.type == "cpu" else gen_rays_launch
        o, d = run(cam, settings, px, py, rng, s, prev_t)
        _save(ctx, call)
        return (*o, *d)

    @staticmethod
    def backward(ctx, *gs):
        cam, settings, px, py, rng, s, prev_t = _saved(ctx)
        run = gen_rays_vjp_plain if px.device.type == "cpu" else gen_rays_bwd_launch
        g = run(cam, settings, px, py, rng, s, prev_t, Vec3(*gs[:3]), Vec3(*gs[3:]))
        return (None, *(g[i].reshape(f.shape) for i, f in enumerate(_cam_fields(cam))))


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


def _grad_inputs(lanes: Lanes, hit: Hit, scene: ShadeScene) -> tuple:
    """K12's differentiable inputs in the order of ``_ShadeFn``'s: the
    lanes' o, d, colour, light value and final colour, t, the 14 material
    fields and the lights' position and colour."""
    mats, lights = scene.materials, scene.lights
    return (*lanes.o, *lanes.d, *lanes.color, *lanes.light_val, *lanes.final_color, hit.t,
            mats.d, mats.Ni, mats.rough, mats.p, mats.nu, mats.nv, mats.Rs, mats.Rd,
            *mats.kd, *mats.ks, *lights.pos, *lights.rgb)


def shade(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
          scene: ShadeScene, occlude: Optional[Callable] = None) -> tuple:
    """One bounce's shade (``shade_plain``'s contract). On CUDA tensors the
    kernel K12: its fused instance when ``hit.occluded`` is given or NEE is
    off, else "K12 pre", ``occlude`` on its shadow ray, and "K12 post"; on
    the CPU ``shade_plain``. Where autograd records an input that requires
    grad, the fused or post step goes through ``_ShadeFn``: its forward
    the same kernel (the plain version on the CPU), its backward K12 bwd
    (``shade_bwd_launch``; ``shade_vjp_plain`` on the CPU), flat-shaded
    or Phong."""
    dev = hit.t.device
    wants = _wants_grad((*_grad_inputs(lanes, hit, scene), scene.lights.radius))
    name = "K12"
    if dev.type == "cuda" and cfg.nee and hit.occluded is None:
        *ray, casts = shade_launch("K12 pre", cfg, lanes, hit, rng, s, depth, scene)
        hit, name = hit._replace(occluded=occlude(*ray, casts)), "K12 post"
    if wants:
        out = _ShadeFn.apply((name, cfg, lanes, hit, rng, s, depth, scene, occlude),
                             *_grad_inputs(lanes, hit, scene))
        v3 = lambda j: Vec3(*out[j:j + 3])  # noqa: E731
        return (Lanes(v3(0), v3(3), v3(6), out[15], out[16], v3(9), out[17], v3(12), out[18]),
                out[19] if cfg.nee else None)
    if dev.type == "cpu":
        return shade_plain(cfg, lanes, hit, rng, s, depth, scene, occlude)
    return shade_launch(name, cfg, lanes, hit, rng, s, depth, scene)


class _ShadeFn(torch.autograd.Function):
    """A bounce's shade where autograd records it (``shade``): forward the
    fused K12 or "K12 post" on the card, ``shade_plain`` on the CPU (which
    takes the shadow leg's bit from ``occlude`` itself); backward K12 bwd on
    the card, ``shade_vjp_plain`` on the CPU. It saves the inputs and the
    occluded bit alone: the backward recomputes the bounce."""

    @staticmethod
    def forward(ctx, call, *diff):
        name, cfg, lanes, hit, rng, s, depth, scene, occlude = call
        if hit.t.device.type == "cpu":
            bits = []

            def leg(*ray):
                bits.append(occlude(*ray))
                return bits[-1]

            out, casts = shade_plain(cfg, lanes, hit, rng, s, depth, scene, leg)
            if bits:
                hit = hit._replace(occluded=bits[0])
        else:
            out, casts = shade_launch(name, cfg, lanes, hit, rng, s, depth, scene)
        _save(ctx, (cfg, lanes, hit, rng, s, depth, scene))
        flags = (out.alive, out.light_found, out.depth_added, out.secondary)
        ctx.mark_non_differentiable(*flags, *(() if casts is None else (casts,)))
        return (*out.o, *out.d, *out.color, *out.light_val, *out.final_color, *flags,
                *(() if casts is None else (casts,)))

    @staticmethod
    def backward(ctx, *gs):
        cfg, lanes, hit, rng, s, depth, scene = _saved(ctx)
        g = LaneGrads(*(Vec3(*gs[j:j + 3]) for j in range(0, 15, 3)))
        run = shade_vjp_plain if hit.t.device.type == "cpu" else shade_bwd_launch
        lane, g_t, table = run(cfg, lanes, hit, rng, s, depth, scene, g)
        m, nl = int(scene.materials.d.shape[0]), scene.lights.count
        rows = [table[i * m:(i + 1) * m] for i in range(14)]
        rows += [table[14 * m + i * nl:14 * m + (i + 1) * nl] for i in range(6)]
        return (None, *(c for v in lane for c in v), g_t, *rows)


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


def shade_bwd_launch(cfg: ShadeConfig, lanes: Lanes, hit: Hit, rng: PixelRng, s: int, depth: int,
                     scene: ShadeScene, g: LaneGrads) -> tuple:
    """K12 bwd over checked CUDA inputs (``shade_vjp_plain``'s contract;
    fused or post alike, flat-shaded or Phong: ``hit.occluded`` the bit
    the forward used where NEE is on): one thread a lane recomputes the
    bounce and writes its inputs' gradients, bitwise the plain adjoint's
    (the final colour's is ``g.final_color`` itself); each block sums its
    lanes' table terms in a fixed order into a partial row and the last
    block to finish sums the rows in order. Returns ``(LaneGrads, g_t,
    table)``."""
    n, faces, mat_fields, light_fields = _shade_checks("K12 bwd", cfg, lanes, hit, rng, scene)
    dev, phong = hit.t.device, cfg.pt_alpha > 0.0
    grads = [c.contiguous() for v in g for c in v]
    for c in grads:
        _check("K12 bwd", "an output's gradient", c, dev, torch.float32, n)
    m, nl = int(scene.materials.d.shape[0]), scene.lights.count
    rows = 14 * m + 6 * nl
    blocks = _bwd_blocks(n)
    scratch = None
    if 8 * 4 * rows > _SMEM_MAX:  # a block's 8 warp rows in global memory
        blocks = max(1, min(blocks, _SCRATCH_MAX // (8 * 4 * rows)))
        scratch = torch.empty((blocks, 8, rows), dtype=torch.float32, device=dev)
    lane = torch.empty((13, n), dtype=torch.float32, device=dev)
    part = torch.empty((blocks, rows), dtype=torch.float32, device=dev)
    table = torch.empty((rows,), dtype=torch.float32, device=dev)
    done = torch.zeros((1,), dtype=torch.int32, device=dev)
    ins = [*lanes.o, *lanes.d, *lanes.color, lanes.alive, lanes.depth_added, hit.t, hit.face,
           hit.u if phong else None, hit.v if phong else None,
           hit.occluded if cfg.nee else None, rng._base, *faces[:20], *mat_fields,
           *light_fields]
    ptrs = [None if x is None else x.data_ptr() for x in ins]
    ptrs += [c.data_ptr() for c in grads] + [lane[j].data_ptr() for j in range(13)]
    ptrs += [None if scratch is None else scratch.data_ptr(), part.data_ptr(),
             table.data_ptr(), done.data_ptr()]
    ints = (ctypes.c_int * 8)(n, int(s), int(depth), cfg.max_depth, cfg.max_added_depth, nl, m,
                              blocks)
    lib = load("shade_bwd", "pbr_shade_bwd", _SHADE_BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_shade_bwd(_ptr_array(ptrs), ints, f32(cfg.pt_alpha), cfg.brdf,
                                int(cfg.nee), int(cfg.transparency), int(phong), stream)
    if err != 0:
        raise RuntimeError(f"K12 bwd launch failed: cudaError {err}")
    count_launch(launches, "K12 bwd")
    v3 = lambda j: Vec3(lane[j], lane[j + 1], lane[j + 2])  # noqa: E731
    return LaneGrads(v3(0), v3(3), v3(6), v3(9), g.final_color), lane[12], table
