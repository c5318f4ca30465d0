"""The wavefront path-tracing integrator on torch tensors.

The counterpart of ``pbr_tpu/models/integrator.py::trace_rays``: the whole
ray batch advances together through generate (camera rays, AA jitter,
thin-lens DoF), intersect (``ops/traverse.py``: kernel K1, kernel K3
over the cluster verdicts on a scene in the gated band, kernel K4 over
the candidate lists above it, or a BVH walk, K6, K7 or K8; with Phong
tessellation the curved-patch search of ``ops/phongtess.py``: kernel K10
over the clusters' candidate lists or the Phong BVH walk K9), and shade (NEE,
BRDF sample, throughput update, Russian roulette), with per-ray liveness
as masks. Same estimator, same quirks,
same counter-based RNG, so the port's frame agrees with the NumPy oracle
pixel by pixel (up to the ULPs of transcendentals).

What the JAX version does only to please XLA is not ported. These
``RenderSettings`` fields are read and ignored: ``bounce_loop`` and
``sample_loop`` (the bounce and sample loops are Python loops here),
``remat`` and the ``PBR_TPU_CKPT_*`` / ``PBR_TPU_GATHER_VJP`` switches
(checkpointing scopes), and the shard_map varying-axes workarounds. The
material gather is the JAX default's select chain up to 16 materials and
plain indexing above (``_gather_materials``): exact table values either
way. JAX's one-hot matmul for 17-128 materials and its opt-in matmul
backward are TPU choices and are not ported.

Gradients are stopped exactly where the JAX version stops them: the
nearest-face search and the geometry (``ops/traverse.py``, and the
geometry gather below) and the sampled directions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pbr_tpu_torch.ops.brdf import (
    PI_X2,
    fresnel,
    refract_dir,
    sa_eval,
    sa_sample,
    schlick_eval,
    schlick_sample,
)
from pbr_tpu_torch.ops.intersect import INF, gather_vec3, geometric_normal, sphere
from pbr_tpu_torch.ops.phongtess import (
    face_is_flat,
    intersect_scene_phongtess,
    occluded_scene_phongtess,
    patch_constants,
    phongtess_normal,
)
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
from pbr_tpu_torch.ops.traverse import detach_tris, intersect_scene, occluded_scene
from pbr_tpu_torch.ops.vec import Vec3, f32, jitter, safe_div, safe_sqrt, where3
from pbr_tpu_torch.scene.camera import pixel_dim
from pbr_tpu_torch.utils.config import BRDF_SCHLICK, RenderSettings

_I32 = torch.int32
_ZERO, _ONE = torch.tensor(0.0), torch.tensor(1.0)  # 0-d: broadcast on any device


class TraceResult(NamedTuple):
    """``pbr_tpu.models.integrator.TraceResult`` with tensors."""

    color: Vec3  # (B,) frame color (before the progressive blend)
    focus_t: torch.Tensor  # (B,) first-hit distance of sample 0
    n_path_rays: Optional[torch.Tensor] = None  # () path segments traced
    n_shadow_rays: Optional[torch.Tensor] = None  # () NEE shadow rays traced
    heat_bounces: Optional[torch.Tensor] = None  # (B,) live bounces per pixel
    n_dropped: Optional[torch.Tensor] = None  # () lanes lost to compaction overflow
    bounce_row_live: Optional[torch.Tensor] = None  # (max_total_depth,) live-row share
    heat_tests: Optional[torch.Tensor] = None  # (B,) ray-face tests per pixel
    heat_visits: Optional[torch.Tensor] = None  # (B,) BVH node visits (0 where none are counted)


class _Carry(NamedTuple):
    """Per-lane state of one stage of the bounce loop."""

    o: Vec3
    d: Vec3
    color: Vec3
    alive: torch.Tensor
    light_found: torch.Tensor
    light_val: Vec3
    depth_added: torch.Tensor
    final_color: Vec3
    secondary: torch.Tensor
    focus_t: torch.Tensor
    heat: Optional[torch.Tensor]
    heat_tests: Optional[torch.Tensor]
    heat_visits: Optional[torch.Tensor]


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


def _gather_materials(mats, midx):
    """All per-ray material fields; every value is a table entry verbatim.

    With at most ``SELECT_MAX_MATERIALS`` materials each field is the JAX
    default's select chain (``pbr_tpu/models/integrator.py:176-186``):
    ``f[0] * ones``, then one ``torch.where`` per material 1..M-1. Its
    backward is M elementwise selects and M small sums a field; plain
    indexing's backward sorts the B indices. Above that, plain indexing."""
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


def _compact_rows(alive, block: int, cap: int):
    """Row-granular live compaction plan (``_compact_rows`` of the JAX
    version). Lanes group into rows of ``block``; a row is live iff any
    lane is. Returns ``(src, slot, n_ok, n_drop)``:

    - ``src`` (cap,): original row of the j-th live row, in row order,
      0 past the live count;
    - ``slot`` (R,): each row's compact slot, ``cap`` when dead or over
      capacity;
    - ``n_ok`` (): live rows that got a slot;
    - ``n_drop`` (): live lanes lost to capacity overflow.

    No host sync: ``src`` is a scatter into ``cap + 1`` slots whose last
    one takes every dead or overflowing row and is then dropped.
    """
    r = alive.shape[0] // block
    a2 = alive.reshape(r, block)
    row_live = a2.any(dim=1)
    pos = torch.cumsum(row_live.to(_I32), 0, dtype=_I32) - 1
    ok = row_live & (pos < cap)
    slot = torch.where(ok, pos, cap).to(_I32)
    ridx = torch.arange(r, dtype=_I32, device=alive.device)
    src = torch.zeros(cap + 1, dtype=_I32, device=alive.device)
    src = src.scatter(0, slot.long(), ridx)[:cap]
    n_ok = torch.clamp_max(row_live.sum(dtype=_I32), cap)
    n_drop = torch.where(row_live & ~ok, a2.sum(dim=1, dtype=_I32), 0).sum(dtype=_I32)
    return src, slot, n_ok, n_drop


def _take_rows(v, src, block: int):
    """Gather rows of ``block`` consecutive lanes: (R*block,) -> (cap*block,)."""
    return v.reshape(-1, block)[src].reshape(-1)


def _gen_rays(cam, settings: RenderSettings, px, py, rng: PixelRng, s: int, prev_t):
    """Primary rays: pinhole + AA jitter + thin-lens DoF (initRay,
    pathtracing.cl:25-48; pt_utils.cl:327-373). Camera fields are 0-d
    tensors and broadcast against the (B,) batch."""
    w, h = settings.width, settings.height
    pxdim = np.float32(pixel_dim(w, h, settings.fov))
    eye, cw, cu, cv = cam.eye, cam.w, cam.u, cam.v

    fx = f32(1.0 - w) + 2.0 * px
    fy = f32(1.0 - h) + 2.0 * py
    d = (cw + (cu * fx + cv * fy) * f32(pxdim * np.float32(0.5))).normalized()

    r0 = rng.at(s, 0)
    rnd = r0.u(S_AA_R)
    phi = PI_X2 * r0.u(S_AA_PHI)
    aa = jitter(d, phi, torch.sqrt(rnd), torch.sqrt(1.0 - rnd))
    d = (d + aa * f32(pxdim * np.float32(settings.anti_aliasing))).normalized()

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


def _orb_pass(o, d, lights, t_geom):
    """Orb-light visibility on a geometry miss (traverseLights,
    pt_bvh.cl:54-74): the last orb hit in light order wins."""
    orb_idx = torch.full(o.x.shape, -1, dtype=_I32, device=o.x.device)
    for i in range(lights.count):
        center = Vec3(lights.pos.x[i], lights.pos.y[i], lights.pos.z[i])
        _, hit = sphere(o, d, center, lights.radius[i])
        orb_idx = torch.where((lights.type[i] == 2) & hit, i, orb_idx)
    return torch.where(torch.isfinite(t_geom), -1, orb_idx)


def _shadow_occluded(tris, hit_p, l_dir, t_light, casts, mode, tables, pt_alpha=0.0,
                     pt_faces=None):
    """Any-hit shadow test (traverseShadows, pt_bvh.cl:133-177): occluded
    iff some geometry hit lies closer than the light. Used when the
    intersector has no fused shadow leg; ``casts``: the lanes whose bit the
    caller reads (``ops/traverse.py::occluded_scene``: the per-ray BVH walk
    runs kernel K8's any-hit instance on those lanes only, the plain sweep
    a second nearest-hit search over every lane). With Phong tessellation
    (``pt_alpha`` > 0) the shadow ray tests the curved patches too
    (``ops/phongtess.py::occluded_scene_phongtess``, ``pt_faces``: its face
    table): where the nearest dispatch walks the BVH, the any-hit walk
    (kernel K9's any-hit instance); the sweep and the cluster search, then
    t < t_light. The JAX version searches nearest on every lane and
    re-evaluates t; the port closes the lanes that cast no shadow ray,
    whose bit is never read."""
    if pt_alpha > 0.0:
        return occluded_scene_phongtess(hit_p, l_dir, t_light, tris, pt_alpha,
                                        bvh=tables["bvh"], clusters=tables["clusters"],
                                        max_leaf=tables["max_leaf"], alive=casts,
                                        faces=pt_faces)
    return occluded_scene(hit_p, l_dir, t_light, tris, mode=mode, alive=casts, **tables)


def _stage_capacities(settings: RenderSettings, rows_total: int, block: int):
    """The validated compaction schedule: [(bounce, row capacity)],
    strictly shrinking. Capacities round up to whole 1024-lane tiles, as
    in the JAX version, so both drop exactly the same lanes."""
    schedule = []
    prev_cap, prev_kb = rows_total, 0
    tile_rows = max(1, 1024 // block) if 1024 % block == 0 else 1
    if rows_total % tile_rows:
        tile_rows = 1
    for kb, frac in sorted(settings.compact_schedule):
        cap = max(1, int(np.ceil(rows_total * frac)))
        cap = min(rows_total, -(-cap // tile_rows) * tile_rows)
        if prev_kb < kb < settings.max_total_depth and 0 < cap < prev_cap:
            schedule.append((kb, cap))
            prev_cap, prev_kb = cap, kb
    return schedule


def trace_rays(
    scene,
    cam,
    settings: RenderSettings,
    pixel_ids: torch.Tensor,
    frame_seed,
    prev_t: Optional[torch.Tensor] = None,
    with_stats: bool = False,
    max_leaf: Optional[int] = None,
) -> TraceResult:
    """Trace ``settings.samples`` paths for each pixel id.

    ``scene``: a ``SceneParams`` (``pbr_tpu_torch.scene.to_torch``);
    ``cam``: a ``CameraState`` of 0-d tensors (``camera_to_torch``);
    ``pixel_ids``: (B,) int32 global pixel indices (y * width + x) on the
    scene's device; ``frame_seed``: a Python int or a 0-d integer tensor;
    ``prev_t``: the previous frame's first-hit distances, or None;
    ``max_leaf``: the faces a leaf of the scene's BVH may hold, for the
    tree walks; None takes the BVH's own (``ops/cuda_bvh.py::leaf_bound``).

    ``settings.phong_tessellation`` > 0 traces curved patches
    (``ops/phongtess.py``; build the scene with the same
    ``phong_tess_alpha``) and ignores ``settings.intersector``, as the JAX
    version does.
    """
    dev = pixel_ids.device
    ids = pixel_ids
    px = (ids % settings.width).to(torch.float32)
    py = (ids // settings.width).to(torch.float32)
    rng = PixelRng(frame_seed, ids)
    if prev_t is None:
        prev_t = torch.full(px.shape, INF, dtype=torch.float32, device=dev)

    # Geometry is not a gradient target: the whole integrator sees it
    # detached (the JAX version's stop_gradient on the triangle arrays).
    tris = detach_tris(scene.tris)
    # The acceleration tables every intersect call of the frame takes.
    tables = dict(clusters=scene.clusters, bvh=scene.bvh, forest=scene.forest,
                  max_leaf=max_leaf)
    pt_alpha = float(settings.phong_tessellation)
    flat = face_is_flat(tris) if pt_alpha > 0.0 else None
    # The Phong searches' face table (None: a scene of flat faces alone,
    # whose searches build their own).
    pt_faces = getattr(scene, "phong_records", None)
    mats = scene.materials
    lights = scene.lights
    num_lights = lights.count
    nee_enabled = bool(settings.shadow_rays) and num_lights > 0
    sky = Vec3(*(f32(c) for c in settings.sky_light))
    mtd = settings.max_total_depth

    batch = px.shape[0]
    block = max(1, int(settings.compact_block))
    while block > 1 and batch % block:
        block //= 2
    rows_total = batch // block
    schedule = _stage_capacities(settings, rows_total, block)

    def zero_count():
        return torch.zeros((), dtype=torch.int64, device=dev)

    # Counters: totals as int64 0-d tensors (summed without a host sync).
    n_path = zero_count() if with_stats else None
    n_shadow = zero_count() if with_stats else None
    n_drop_total = zero_count() if schedule else None
    row_frac = torch.zeros((mtd,), dtype=torch.float32, device=dev) if with_stats else None

    def lane_stats(like):
        """Zeroed per-lane counters: bounces, tests, visits."""
        if not with_stats:
            return None, None, None
        z = torch.zeros(like.shape, dtype=_I32, device=dev)
        return z, z.clone(), z.clone()

    def bounce(px, rng, s, depth, c: _Carry) -> _Carry:
        nonlocal n_path, n_shadow, row_frac
        o, d, color, alive = c.o, c.d, c.color, c.alive
        light_found, light_val, depth_added = c.light_found, c.light_val, c.depth_added
        final_color, secondary, focus_t = c.final_color, c.secondary, c.focus_t
        heat, heat_tests, heat_visits = c.heat, c.heat_tests, c.heat_visits
        zero3 = _zeros3(px)
        if with_stats:
            n_path = n_path + alive.sum()
            heat = heat + alive.to(_I32)
            rl = alive.reshape(-1, block).any(dim=1)
            frac = rl.to(torch.float32).sum() / f32(rows_total)
            row_frac = row_frac + (
                torch.arange(mtd, dtype=_I32, device=dev) == depth
            ).to(torch.float32) * frac

        # ---- intersect -----------------------------------------------------
        occ_fused = None
        pt_u = pt_v = None
        if pt_alpha > 0.0:
            # Curved patches: the BVH walk or the cluster search over bounds
            # inflated at build time, the all-faces sweep without a BVH.
            t, face, pt_u, pt_v = intersect_scene_phongtess(
                o, d, tris, pt_alpha, bvh=scene.bvh, clusters=scene.clusters,
                max_leaf=max_leaf, alive=alive, faces=pt_faces)
            out = ((None, None),)  # no counters, as in the JAX version
        elif nee_enabled:
            l0 = Vec3(lights.pos.x[0], lights.pos.y[0], lights.pos.z[0])
            out = intersect_scene(o, d, tris, mode=settings.intersector, light_pos=l0,
                                  alive=alive, with_counts=with_stats, **tables)
            t, face, occ_fused = out[:3]
        else:
            out = intersect_scene(o, d, tris, mode=settings.intersector, alive=alive,
                                  with_counts=with_stats, **tables)
            t, face = out[:2]
        if with_stats:  # a mode without a counter gives None and adds nothing
            tests, visits = out[-1]
            if tests is not None:
                heat_tests = heat_tests + torch.where(alive, tests, 0)
            if visits is not None:
                heat_visits = heat_visits + torch.where(alive, visits, 0)
        if num_lights:
            orb_idx = _orb_pass(o, d, lights, t)
        else:
            orb_idx = torch.full(px.shape, -1, dtype=_I32, device=dev)

        if s == 0 and depth == 0:  # sample 0's first hit is the focus channel
            focus_t = t

        finite = torch.isfinite(t)
        hit = finite & alive
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
        light_val = where3(miss, where3(is_orb, orb_rgb, sky), light_val)
        light_found = light_found | miss
        alive = alive & ~miss

        # ---- material & geometric normal -----------------------------------
        face_safe = face.clamp_min(0)
        midx = tris.mtl[face_safe]
        m_d, m_ni, m_rough, m_p, m_nu, m_nv, m_rs, m_rd, m_kd, m_ks = (
            _gather_materials(mats, midx)
        )
        e1 = gather_vec3(tris.e1, face_safe)
        e2 = gather_vec3(tris.e2, face_safe)
        normal = geometric_normal(e1, e2)
        if pt_u is not None:
            # A curved winner's shading normal (getPhongTessNormal,
            # pt_utils.cl:282-294).
            v0 = gather_vec3(tris.v0, face_safe)
            n1, n2, n3 = (gather_vec3(n, face_safe) for n in (tris.n0, tris.n1, tris.n2))
            consts = patch_constants(v0, v0 + e1, v0 + e2, n1, n2, n3, pt_alpha)
            normal = where3(flat[face_safe], normal,
                            phongtess_normal(d, n1, n2, n3, *consts, pt_u, pt_v))

        # ---- path extension decision (extendDepth, pt_utils.cl:89-96) ------
        rb = rng.at(s, depth)
        if settings.brdf == BRDF_SCHLICK:
            extend = m_rough < rb.u(S_EXTEND)
        else:
            extend = torch.maximum(m_nu, m_nv) >= 50.0

        # ---- opportunistic last-bounce break (pathtracing.cl:274-276) ------
        is_last = depth == (settings.max_depth + depth_added - 1)
        alive = alive & ~(hit & (m_d == 1.0) & ~extend & is_last)
        live = hit & alive

        # ---- hit point (guarded for dead lanes) ----------------------------
        hit_p = o + d * torch.where(hit, t, 1.0)

        # ---- NEE shadow ray (shadowRayTest, pathtracing.cl:188-199) --------
        if nee_enabled:
            l_vec = Vec3(lights.pos.x[0], lights.pos.y[0], lights.pos.z[0]) - hit_p
            t_light = safe_sqrt(l_vec.length2())
            l_dir = l_vec * safe_div(1.0, t_light)
            casts = live & (m_d > 0.0)
            occluded = occ_fused
            if occluded is None:
                occluded = _shadow_occluded(tris, hit_p, l_dir, t_light, casts,
                                            settings.intersector, tables, pt_alpha, pt_faces)
            nee_ok = casts & ~occluded
            if with_stats:
                n_shadow = n_shadow + casts.sum()

        # ---- new direction (getNewRay, pt_brdf.cl:344-378) -----------------
        ra, rbb, rc = rb.u(S_BRDF_A), rb.u(S_BRDF_B), rb.u(S_BRDF_C)
        if settings.brdf == BRDF_SCHLICK:
            new_d = schlick_sample(d, normal, m_rough, m_p, ra, rbb, rc)
        else:
            new_d = sa_sample(d, normal, m_d, m_nu, m_nv, ra, rbb, rc)
        if settings.no_transparency:
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
        if settings.brdf == BRDF_SCHLICK:
            if nee_enabled:
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
            if nee_enabled:
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
            add_depth & (depth_added < settings.max_added_depth) & live
        ).to(_I32)
        alive = alive & ((depth + 1) < settings.max_depth + depth_added)
        rr = (depth > 2 + depth_added) & (color.max_component() < rb.u(S_RR))
        alive = alive & ~rr

        return _Carry(
            where3(live, hit_p, o), where3(live, new_d, d), color, alive,
            light_found, light_val, depth_added, final_color, secondary,
            focus_t, heat, heat_tests, heat_visits,
        )

    final_color = _zeros3(px)
    secondary = torch.ones(px.shape, dtype=_I32, device=dev)  # pathtracing.cl:249
    focus_t = torch.full(px.shape, INF, dtype=torch.float32, device=dev)
    heat, heat_tests, heat_visits = lane_stats(px)

    for s in range(settings.samples):
        o, d = _gen_rays(cam, settings, px, py, rng, s, prev_t)
        ones = torch.ones_like(px)
        carry = _Carry(
            o, d, Vec3(ones, ones.clone(), ones.clone()),
            torch.ones(px.shape, dtype=torch.bool, device=dev),
            torch.zeros(px.shape, dtype=torch.bool, device=dev), _zeros3(px),
            torch.zeros(px.shape, dtype=_I32, device=dev),
            final_color, secondary, focus_t, heat, heat_tests, heat_visits,
        )
        # Stage 0 is the full batch with the real accumulators. Each
        # schedule entry ends a stage (folding in the emission of lanes that
        # died there), gathers the surviving rows into a smaller stage with
        # fresh accumulators, and records the row mapping so the deeper
        # stages' contributions fold back out below.
        stage_px, stage_rng = px, rng
        folds = []
        lo = 0
        for kb, cap in schedule:
            for depth in range(lo, kb):
                carry = bounce(stage_px, stage_rng, s, depth, carry)
            fc = carry.final_color + where3(
                carry.light_found, carry.color * carry.light_val, _zeros3(stage_px)
            )
            if lo == 0:
                focus_t = carry.focus_t  # only the full-width stage sets focus
            src, slot, n_ok, n_drop = _compact_rows(carry.alive, block, cap)
            n_drop_total = n_drop_total + n_drop
            folds.append((slot, cap, fc, carry.secondary,
                          (carry.heat, carry.heat_tests, carry.heat_visits), _zeros3(stage_px)))
            tr = lambda v: _take_rows(v, src, block)  # noqa: E731
            g3 = lambda v: Vec3(tr(v.x), tr(v.y), tr(v.z))  # noqa: E731
            stage_px = tr(stage_px)
            stage_rng = stage_rng.gather_rows(src, block)
            # Slots past the live count hold row 0's data: mask them dead.
            valid_row = torch.arange(cap, dtype=_I32, device=dev) < n_ok
            alive_s = tr(carry.alive) & valid_row[:, None].expand(cap, block).reshape(-1)
            carry = _Carry(
                g3(carry.o), g3(carry.d), g3(carry.color), alive_s,
                torch.zeros_like(alive_s), _zeros3(stage_px), tr(carry.depth_added),
                _zeros3(stage_px), torch.zeros(stage_px.shape, dtype=_I32, device=dev),
                torch.zeros_like(stage_px), *lane_stats(stage_px),
            )
            lo = kb
        for depth in range(lo, mtd):
            carry = bounce(stage_px, stage_rng, s, depth, carry)
        fc_s = carry.final_color + where3(
            carry.light_found, carry.color * carry.light_val, _zeros3(stage_px)
        )
        sec_s, stats_s = carry.secondary, (carry.heat, carry.heat_tests, carry.heat_visits)
        if not schedule:
            focus_t = carry.focus_t
        for slot, cap, fc_prev, sec_prev, stats_prev, zero3_prev in reversed(folds):
            ok_row = slot < cap
            sc = slot.clamp_max(cap - 1)
            tk = lambda v: _take_rows(v, sc, block)  # noqa: E731
            ok_lane = ok_row[:, None].expand(ok_row.shape[0], block).reshape(-1)
            fc_s = fc_prev + where3(ok_lane, Vec3(tk(fc_s.x), tk(fc_s.y), tk(fc_s.z)),
                                    zero3_prev)
            sec_s = sec_prev + torch.where(ok_lane, tk(sec_s), 0)
            if with_stats:
                stats_s = tuple(prev + torch.where(ok_lane, tk(cur), 0)
                                for prev, cur in zip(stats_prev, stats_s))
        final_color, secondary = fc_s, sec_s
        heat, heat_tests, heat_visits = stats_s

    final_color = final_color / secondary.to(torch.float32)
    if settings.samples > 1:
        final_color = final_color / f32(settings.samples)
        if row_frac is not None:
            row_frac = row_frac / f32(settings.samples)
    return TraceResult(
        color=final_color,
        focus_t=focus_t,
        n_path_rays=n_path,
        n_shadow_rays=n_shadow,
        heat_bounces=heat,
        n_dropped=n_drop_total,
        bounce_row_live=row_frac,
        heat_tests=heat_tests,
        heat_visits=heat_visits,
    )
