"""The port's render slice (trace_rays, render_frame, PathTracer) against
the JAX package: the NumPy oracle ``render_cpu`` and JAX's jitted
``trace_rays`` on the CPU.

The frame gate is the repo's (tests/test_render_golden.py): at least 99%
of pixels within 1e-3, because a ULP difference in a transcendental can
flip a rare discrete decision of a chaotic path tracer. Compaction is a
pure permutation, so schedule on and off must be bitwise equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.models import pathtracer as jax_pathtracer
from pbr_tpu.reference.cpu import render_cpu
from pbr_tpu.scene.build import bvh_max_leaf, derive_static_flags, scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.scene.procedural import cornell_box, multi_room, single_triangle
from pbr_tpu.utils.config import BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN, RenderSettings
from pbr_tpu.utils.morton import morton_pixel_ids
from pbr_tpu_torch import PathTracer, camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.models.pathtracer import (
    probe_compact_schedule,
    probe_subset_ids,
    schedule_cost,
)
from pbr_tpu_torch.ops import cuda_gated
from pbr_tpu_torch.scene.build import scene_from_text as port_scene_from_text

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine (measured: a
# 3 s test took 180 s with four workers).
torch.set_num_threads(1)


def _bench_settings(size, **kw):
    """bench.py's main-path settings at ``size``² (no_transparency as
    derive_static_flags sets it for the all-opaque Cornell box)."""
    base = dict(
        width=size, height=size, samples=1, max_depth=3, max_added_depth=5,
        shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
        no_transparency=True,
    )
    base.update(kw)
    return RenderSettings(**base)


@pytest.fixture(scope="module")
def cornell():
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    return scene, cam


def _trace(scene, cam, settings, seed, **kw):
    ids = torch.arange(settings.width * settings.height, dtype=torch.int32)
    return trace_rays(to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"), settings,
                      ids, seed, **kw)


def _rgb(res, settings):
    return res.color.stack().numpy().reshape(settings.height, settings.width, 3)


def _assert_close(got, ref, flip_budget=0.01, mean_tol=1e-2):
    d = np.abs(got - ref).max(axis=-1)
    flips = (d > 1e-3).mean()
    assert flips <= flip_budget, f"{flips:.2%} pixels differ by more than 1e-3"
    agree = d <= 1e-3
    assert np.abs(got - ref)[agree].mean() < mean_tol


@pytest.fixture(scope="module")
def multiroom():
    """bench.py's multiroom scene (bench.py:187-193): 1,428 faces with a
    ClusterSet of 64-face clusters, so ``auto`` runs the gated sweep."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    cam = make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0))
    return scene, cam


def _render_jax(scene, cam, settings, seed):
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    ids = jnp.arange(settings.width * settings.height, dtype=jnp.int32)
    f = jax.jit(functools.partial(jax_integrator.trace_rays, jnp, max_leaf=bvh_max_leaf(scene)),
                static_argnames=("settings",))
    res = f(jscene, jcam, settings=settings, pixel_ids=ids, frame_seed=jnp.uint32(seed))
    rgb = np.stack([np.asarray(res.color.x), np.asarray(res.color.y),
                    np.asarray(res.color.z)], -1)
    return rgb.reshape(settings.height, settings.width, 3)


@pytest.mark.parametrize("brdf", [BRDF_SHIRLEY_ASHIKHMIN, BRDF_SCHLICK])
def test_cornell_matches_oracle_and_jax(cornell, brdf):
    scene, cam = cornell
    settings = _bench_settings(64, brdf=brdf)
    got = _rgb(_trace(scene, cam, settings, 3), settings)
    assert np.isfinite(got).all()
    ref_np, _ = render_cpu(scene, cam, settings, frame_seed=3)
    _assert_close(got, ref_np)
    _assert_close(got, _render_jax(scene, cam, settings, 3))


def test_single_triangle_matches_oracle():
    obj, mtl, li = single_triangle()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    cam = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(width=32, height=32, samples=1, max_depth=2,
                              max_added_depth=0, shadow_rays=0, anti_aliasing=0.0)
    got = _rgb(_trace(scene, cam, settings, 7), settings)
    ref, _ = render_cpu(scene, cam, settings, frame_seed=7)
    _assert_close(got, ref, flip_budget=0.005)


def test_transparency_branch_matches_oracle(cornell):
    """The transmit branch (``no_transparency`` off) with a glass block."""
    scene, cam = cornell
    mats = scene.materials
    d = np.asarray(mats.d).copy()
    d[-2] = 0.3  # the glossy block turns transparent
    glass = scene._replace(materials=mats._replace(d=d, Ni=np.full_like(d, 1.5)))
    settings = _bench_settings(32, no_transparency=False, samples=2)
    got = _rgb(_trace(glass, cam, settings, 5), settings)
    ref, _ = render_cpu(glass, cam, settings, frame_seed=5)
    _assert_close(got, ref)


@pytest.mark.parametrize("brdf", [BRDF_SHIRLEY_ASHIKHMIN, BRDF_SCHLICK])
def test_compaction_on_off_bitwise_and_counters(cornell, brdf):
    scene, cam = cornell
    # 40² in rows of 16 lanes: 100 rows, not a whole number of 1024-lane
    # tiles, so the capacities are not rounded up to the full batch.
    settings = _bench_settings(40, brdf=brdf, compact_block=16, samples=2)
    full = _trace(scene, cam, settings, 7, with_stats=True)
    sched = settings.replace(compact_schedule=((4, 0.73), (5, 0.3), (6, 0.1)))
    comp = _trace(scene, cam, sched, 7, with_stats=True)
    assert int(comp.n_dropped) == 0
    assert full.n_dropped is None
    for a, b in zip(full.color, comp.color):
        assert torch.equal(a, b)
    assert torch.equal(full.focus_t, comp.focus_t)
    for name in ("n_path_rays", "n_shadow_rays", "heat_bounces", "heat_tests",
                 "heat_visits", "bounce_row_live"):
        assert torch.equal(getattr(full, name), getattr(comp, name)), name
    # The counters equal the NumPy integrator's on the same schedule.
    ids = np.arange(40 * 40, dtype=np.int32)
    with np.errstate(all="ignore"):
        ref = jax_integrator.trace_rays(np, scene, cam, sched, ids, 7, with_stats=True)
    assert int(comp.n_path_rays) == int(ref.n_path_rays)
    assert int(comp.n_shadow_rays) == int(ref.n_shadow_rays)
    assert int(comp.n_dropped) == int(ref.n_dropped)
    np.testing.assert_array_equal(comp.bounce_row_live.numpy(), ref.bounce_row_live)
    # Per-pixel bounce counts may differ only where a decision flipped.
    assert (comp.heat_bounces.numpy() == ref.heat_bounces).mean() >= 0.99


def test_compaction_overflow_counts_dropped_lanes(cornell):
    scene, cam = cornell
    settings = _bench_settings(40, compact_block=16, compact_schedule=((1, 0.05),))
    res = _trace(scene, cam, settings, 1)
    ids = np.arange(40 * 40, dtype=np.int32)
    with np.errstate(all="ignore"):
        ref = jax_integrator.trace_rays(np, scene, cam, settings, ids, 1)
    assert int(res.n_dropped) > 0
    assert int(res.n_dropped) == int(ref.n_dropped)


def test_progressive_frames_match_numpy_render_frame(cornell):
    """4 progressive PathTracer frames against NumPy's render_frame chain,
    including the row flip of image() and depth_image()."""
    scene, cam = cornell
    settings = _bench_settings(32)
    pt = PathTracer(scene, settings, device="cpu", lane_order="scanline")
    npx = 32 * 32
    state = jax_pathtracer.init_frame_state(np, npx)
    ids = np.arange(npx, dtype=np.int32)
    for i in range(4):
        pt.render(cam, frame_seed=10 + i)
        with np.errstate(all="ignore"):
            state = jax_pathtracer.render_frame(np, scene, cam, settings, state, ids, 10 + i)
    assert pt.sample_count == 4
    ref = np.stack([state.rgb.x, state.rgb.y, state.rgb.z], -1).reshape(32, 32, 3)[::-1]
    img = pt.image()
    assert img.shape == (32, 32, 3) and img.dtype == np.float32
    _assert_close(img, ref)
    depth = pt.depth_image()
    np.testing.assert_allclose(depth, state.depth.reshape(32, 32)[::-1], rtol=1e-5)


def test_morton_lane_order_gives_the_same_image(cornell):
    scene, cam = cornell
    settings = _bench_settings(32, compact_block=16)
    a = PathTracer(scene, settings, device="cpu", lane_order="scanline")
    b = PathTracer(scene, settings, device="cpu", lane_order="morton")
    a.render(cam, 4)
    b.render(cam, 4)
    np.testing.assert_array_equal(a.image(), b.image())


def test_auto_schedule_matches_jax_probe(cornell):
    """compact_schedule='auto' resolves at the first render to the schedule
    the JAX package's probe derives on the same scene, and the image is
    the one the explicit schedule gives."""
    scene, cam = cornell
    settings = _bench_settings(64, compact_block=32, compact_schedule="auto")
    pt = PathTracer(scene, settings, device="cpu", lane_order="scanline")
    pt.render(cam, 2)
    ref = jax_pathtracer.probe_compact_schedule(scene, cam, settings.replace(compact_schedule=()))
    assert pt.settings.compact_schedule == ref
    assert len(ref) > 0
    got = probe_compact_schedule(pt.scene, camera_to_torch(cam, "cpu"),
                                 settings.replace(compact_schedule=()))
    assert got == ref
    pinned = PathTracer(scene, settings.replace(compact_schedule=ref), device="cpu")
    pinned.render(cam, 2)
    np.testing.assert_array_equal(pt.image(), pinned.image())


def test_morton_probe_matches_jax_probe(cornell):
    """The probe over a strided subset of Morton lane blocks derives the
    schedule the JAX package's probe derives from the same permutation."""
    scene, cam = cornell
    settings = _bench_settings(64, compact_block=32)
    mperm = morton_pixel_ids(64, 64)
    ref = jax_pathtracer.probe_compact_schedule(scene, cam, settings, pixel_ids=mperm)
    got = probe_compact_schedule(to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"),
                                 settings, pixel_ids=mperm)
    assert got == ref
    assert len(ref) > 0


@pytest.mark.parametrize("n, block, target", [
    (64 * 64, 32, 1024), (96 * 64, 48, 512), (1000, 64, 300), (4096, 16, 10 ** 6),
])
def test_probe_helpers_match_jax(n, block, target):
    """probe_subset_ids and schedule_cost, carried over from the JAX
    package, give its answers: the same lanes, the same widths."""
    ids = np.random.default_rng(n).permutation(n).astype(np.int32)
    np.testing.assert_array_equal(probe_subset_ids(ids, block, target),
                                  jax_pathtracer.probe_subset_ids(ids, block, target))
    for sched in ((), ((5, 0.0469), (6, 0.002), (7, 0.002)), ((2, 0.9), (4, 1.5)),
                  ((3, 0.5), (1, 0.7))):
        assert schedule_cost(sched, 8) == jax_pathtracer.schedule_cost(sched, 8)


def test_move_light_and_reset(cornell):
    scene, cam = cornell
    settings = _bench_settings(16)
    pt = PathTracer(scene, settings, device="cpu")
    pt.render(cam, 0)
    before = pt.image().copy()
    old_pos = pt.scene.light_pos.detach().clone()
    pt.move_light(0, 0.0, -0.5, 0.0)
    assert pt.sample_count == 0
    assert torch.equal(pt.scene.light_pos[1, 0], old_pos[1, 0] + np.float32(-0.5))
    assert float(np.asarray(scene.lights.pos.y)[0]) == float(old_pos[1, 0])  # NumPy scene untouched
    pt.render(cam, 0)
    assert not np.array_equal(before, pt.image())
    pt.reset_sample_count()
    assert pt.sample_count == 0


def test_to_torch_round_trips_the_numpy_scene(cornell):
    scene, cam = cornell
    ts = to_torch(scene, "cpu")
    for name in ("v0", "e1", "e2", "n0", "n1", "n2"):
        for c in "xyz":
            a = getattr(getattr(ts.tris, name), c)
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), getattr(getattr(scene.tris, name), c))
    assert ts.tris.mtl.dtype == torch.int32
    np.testing.assert_array_equal(ts.tris.mtl.numpy(), scene.tris.mtl)
    for name in ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd", "light"):
        np.testing.assert_array_equal(getattr(ts.materials, name).numpy(),
                                      getattr(scene.materials, name))
    for name in ("kd", "ks"):
        for c in "xyz":
            np.testing.assert_array_equal(getattr(getattr(ts.materials, name), c).numpy(),
                                          getattr(getattr(scene.materials, name), c))
    for name in ("pos", "rgb"):
        for c in "xyz":
            np.testing.assert_array_equal(getattr(getattr(ts.lights, name), c).numpy(),
                                          getattr(getattr(scene.lights, name), c))
    np.testing.assert_array_equal(ts.lights.radius.numpy(), scene.lights.radius)
    assert ts.lights.type.dtype == torch.int32
    np.testing.assert_array_equal(ts.lights.type.numpy(), scene.lights.type)
    # Gradient targets are parameters, off until a gradient pass needs them.
    params = dict(ts.named_parameters())
    assert {"mat_kd", "light_pos", "light_rgb"} <= set(params)
    assert not any(p.requires_grad for p in params.values())
    tc = camera_to_torch(cam, "cpu")
    for f in ("eye", "w", "u", "v"):
        for c in "xyz":
            t = getattr(getattr(tc, f), c)
            assert t.shape == () and t.dtype == torch.float32
            assert float(t) == float(getattr(getattr(cam, f), c))
    assert float(tc.focus) == float(cam.focus)


def test_phong_tessellation_is_refused(cornell):
    """Phong tessellation is ported (ops/phongtess.py): phong_tessellation >
    0 renders, on the Cornell box's flat faces the same frame as without
    it (a face whose vertex normals agree takes Möller-Trumbore)."""
    scene, cam = cornell
    settings = _bench_settings(8)
    got = _rgb(_trace(scene, cam, settings.replace(phong_tessellation=0.5), 0), settings)
    assert np.isfinite(got).all()
    _assert_close(got, _rgb(_trace(scene, cam, settings, 0), settings))


def test_unported_intersector_is_refused(cornell):
    """Every intersector of the JAX package is ported ('gemm' renders, below),
    and so is Phong tessellation, which is taken where a scene is built: a
    Cornell box built with phong_tess_alpha > 0 is the JAX package's build,
    its BVH over the (here flat) face bounds and no forest."""
    ref, _ = scene_from_text(*cornell_box(), use_bvh=True, phong_tess_alpha=0.5)
    got, _ = port_scene_from_text(*cornell_box(), use_bvh=True, phong_tess_alpha=0.5)
    for name in ("bb_min", "bb_max"):
        for c in "xyz":
            np.testing.assert_array_equal(getattr(getattr(got.bvh, name), c),
                                          getattr(getattr(ref.bvh, name), c))
    np.testing.assert_array_equal(got.tris.v0.x, ref.tris.v0.x)
    assert got.forest is None and ref.forest is None


def test_gemm_intersector_renders(cornell):
    """intersector='gemm' (the sweep as a matrix product; NEE through the
    separate shadow search) renders the brute sweep's frame within the frame
    gate."""
    scene, cam = cornell
    settings = _bench_settings(16)
    got = _rgb(_trace(scene, cam, settings.replace(intersector="gemm"), 2), settings)
    assert np.isfinite(got).all()
    _assert_close(got, _rgb(_trace(scene, cam, settings, 2), settings))


def _gated_spy(monkeypatch):
    """Record, for each gated-sweep call, whether it got an alive mask."""
    calls = []
    real = cuda_gated.intersect_gated

    def spy(*args, **kw):
        calls.append(kw.get("alive") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(cuda_gated, "intersect_gated", spy)
    return calls


def test_multiroom_matches_oracle_and_jax(multiroom, monkeypatch):
    """bench.py's multiroom settings at 48² through the port's CPU path
    (auto: the gated sweep's plain version at every bounce, with the alive
    mask) against the NumPy oracle and JAX's jitted trace_rays (which walks
    the BVH on the CPU)."""
    scene, cam = multiroom
    settings = derive_static_flags(scene, _bench_settings(48, no_transparency=False))
    assert settings.no_transparency
    calls = _gated_spy(monkeypatch)
    got = _rgb(_trace(scene, cam, settings, 3), settings)
    assert calls == [True] * settings.max_total_depth
    assert np.isfinite(got).all() and got.mean() > 0.1
    ref_np, _ = render_cpu(scene, cam, settings, frame_seed=3)
    _assert_close(got, ref_np)
    _assert_close(got, _render_jax(scene, cam, settings, 3))


def test_multiroom_compaction_on_off_bitwise(multiroom):
    """Compaction regroups lanes into other gated tiles: the verdicts
    change, the answers do not (the gate is conservative). 0 dropped."""
    scene, cam = multiroom
    settings = _bench_settings(40, compact_block=16)
    full = _trace(scene, cam, settings, 7, with_stats=True)
    sched = settings.replace(compact_schedule=((4, 0.73), (5, 0.3), (6, 0.1)))
    comp = _trace(scene, cam, sched, 7, with_stats=True)
    assert int(comp.n_dropped) == 0
    for a, b in zip(full.color, comp.color):
        assert torch.equal(a, b)
    assert torch.equal(full.focus_t, comp.focus_t)
    for name in ("n_path_rays", "n_shadow_rays", "heat_bounces", "bounce_row_live"):
        assert torch.equal(getattr(full, name), getattr(comp, name)), name
    # The executed tests are the gated sweep's: fewer than the full sweep's
    # 2F a bounce, and never more than it.
    tests = full.heat_tests.numpy()
    bounces = full.heat_bounces.numpy()
    assert np.all(tests <= 2 * scene.tris.count * bounces)
    assert tests.sum() < 2 * scene.tris.count * bounces.sum()


def test_multiroom_pathtracer_probes_through_the_gated_sweep(multiroom, monkeypatch):
    """PathTracer keeps the clusters: its schedule and lane-order probes
    run the gated sweep, as the frames do; the probed schedule is the JAX
    package's, and the frame drops no lane."""
    scene, cam = multiroom
    settings = _bench_settings(64, compact_block=32, compact_schedule="auto")
    calls = _gated_spy(monkeypatch)
    pt = PathTracer(scene, settings, device="cpu")
    assert pt.scene.clusters is not None and pt.scene.clusters.count == 32
    pt.render(cam, 2)
    mtd = pt.settings.max_total_depth
    assert calls == [True] * (3 * mtd)  # two probes, one frame
    assert pt.lane_order in ("scanline", "morton")
    perm = None if pt.lane_order == "scanline" else morton_pixel_ids(64, 64)
    ref = jax_pathtracer.probe_compact_schedule(
        scene, cam, settings.replace(compact_schedule=()), pixel_ids=perm)
    assert pt.settings.compact_schedule == ref
    img = pt.image()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    res = trace_rays(pt.scene, camera_to_torch(cam, "cpu"), pt.settings, pt.pixel_ids, 2,
                     with_stats=True)
    assert res.n_dropped is None or int(res.n_dropped) == 0
