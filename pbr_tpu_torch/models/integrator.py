"""The wavefront path-tracing integrator on torch tensors.

The counterpart of ``pbr_tpu/models/integrator.py::trace_rays``: the whole
ray batch advances together through generate (camera rays, AA jitter,
thin-lens DoF: kernel K11), intersect (``ops/traverse.py``: kernel K1,
kernel K3 over the cluster verdicts on a scene in the gated band, kernel K4
over the candidate lists above it, or a BVH walk, K6, K7 or K8; with Phong
tessellation the curved-patch search of ``ops/phongtess.py``: kernel K10
over the clusters' candidate lists or the Phong BVH walk K9), and shade
(NEE, BRDF sample, throughput update, Russian roulette: kernel K12), with
per-ray liveness as masks. K11 and K12 (``ops/cuda_shade.py``) run a
frame on the card, their plain versions (the torch ops) on the CPU. A
compaction schedule gathers each stage's rows by kernel K13 and folds them
back by K14 (``ops/cuda_compact.py``); where autograd records the frame,
the backward of all four runs K11 bwd, K12 bwd, K13 bwd and K14 bwd on the
card. Same estimator, same quirks,
same counter-based RNG, so the port's frame agrees with the NumPy oracle
pixel by pixel (up to the ULPs of transcendentals).

What the JAX version does only to please XLA is not ported. These
``RenderSettings`` fields are read and ignored: ``bounce_loop`` and
``sample_loop`` (the bounce and sample loops are Python loops here),
``remat`` and the ``PBR_TPU_CKPT_*`` / ``PBR_TPU_GATHER_VJP`` switches
(checkpointing scopes), and the shard_map varying-axes workarounds. The
material gather is the JAX default's select chain up to 16 materials and
plain indexing above (``cuda_shade.gather_materials``): exact table values either
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

from pbr_tpu_torch.ops.cuda_compact import Plan, fold, take_rows
from pbr_tpu_torch.ops.cuda_shade import Hit, Lanes, ShadeConfig, ShadeScene, gen_rays, shade
from pbr_tpu_torch.ops.intersect import INF
from pbr_tpu_torch.ops.phongtess import (
    face_is_flat,
    intersect_scene_phongtess,
    occluded_scene_phongtess,
)
from pbr_tpu_torch.ops.rng import PixelRng
from pbr_tpu_torch.ops.traverse import detach_tris, intersect_scene, occluded_scene
from pbr_tpu_torch.ops.vec import Vec3, f32, where3
from pbr_tpu_torch.utils.config import RenderSettings

_I32 = torch.int32


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


def stage_plan(settings: RenderSettings, batch: int) -> tuple:
    """``(block, schedule)`` of a sample of ``batch`` lanes: the row width
    (``compact_block`` halved until it divides the batch) and
    ``_stage_capacities``' schedule over those rows."""
    block = max(1, int(settings.compact_block))
    while block > 1 and batch % block:
        block //= 2
    return block, _stage_capacities(settings, batch // block, block)


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
    lights = scene.lights
    shade_cfg = ShadeConfig.of(settings, lights.count)
    shade_scene = ShadeScene(tris, scene.materials, lights, flat)
    nee_enabled = shade_cfg.nee
    mtd = settings.max_total_depth

    block, schedule = stage_plan(settings, px.shape[0])
    rows_total = px.shape[0] // block

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

        if s == 0 and depth == 0:  # sample 0's first hit is the focus channel
            focus_t = t

        # ---- shade: kernel K12 on a forward frame on the card --------------
        def occlude(hit_p, l_dir, t_light, casts):
            return _shadow_occluded(tris, hit_p, l_dir, t_light, casts, settings.intersector,
                                    tables, pt_alpha, pt_faces)

        lanes, casts = shade(
            shade_cfg, Lanes(o, d, color, alive, light_found, light_val, depth_added,
                             final_color, secondary),
            Hit(t, face, pt_u, pt_v, occ_fused), rng, s, depth, shade_scene, occlude)
        if with_stats and casts is not None:
            n_shadow = n_shadow + casts.sum()
        return _Carry(*lanes, focus_t, heat, heat_tests, heat_visits)

    final_color = _zeros3(px)
    secondary = torch.ones(px.shape, dtype=_I32, device=dev)  # pathtracing.cl:249
    focus_t = torch.full(px.shape, INF, dtype=torch.float32, device=dev)
    heat, heat_tests, heat_visits = lane_stats(px)

    for s in range(settings.samples):
        o, d = gen_rays(cam, settings, px, py, rng, s, prev_t)  # kernel K11
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
            plan = Plan(src, slot, n_ok, cap, block)
            folds.append((plan, fc, carry.secondary,
                          (carry.heat, carry.heat_tests, carry.heat_visits)))
            # Kernel K13: every field the next stage takes, gathered by rows
            # in one launch; slots past the live count hold row 0's data
            # and are masked dead.
            taken, alive_s = take_rows(
                plan, [*carry.o, *carry.d, *carry.color, carry.depth_added, stage_px,
                       stage_rng._base], carry.alive)
            stage_px = taken[10]
            stage_rng = stage_rng.gather_rows(src, block, base=taken[11])
            carry = _Carry(
                Vec3(*taken[0:3]), Vec3(*taken[3:6]), Vec3(*taken[6:9]), alive_s,
                torch.zeros_like(alive_s), _zeros3(stage_px), taken[9],
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
        # Kernel K14: each stage's rows added back into the outer stage's
        # lanes, one launch a fold.
        for plan, fc_prev, sec_prev, stats_prev in reversed(folds):
            out = fold(plan, [*fc_prev, sec_prev, *(stats_prev if with_stats else ())],
                       [*fc_s, sec_s, *(stats_s if with_stats else ())])
            fc_s, sec_s = Vec3(*out[:3]), out[3]
            if with_stats:
                stats_s = tuple(out[4:])
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
