"""The tree-walk slice as a whole: 16² frames of ``trace_rays`` in each tree
mode against the JAX package's ``trace_rays`` (its NumPy backend, the
Pallas walks in interpret mode as tests/test_forest.py runs them), the
``bvh`` mode's node-visit and test counters against JAX's, and
``PathTracer``'s ``max_leaf``.

Frames: the repo's frame gate, at least 99% of pixels within 1e-3
(tests/test_render_golden.py), since a ULP difference can turn a path.
Counters: as tests/test_counters.py:207-218 holds the JAX package's own,
at least 90% of pixels equal and sums within 5% (a turned path walks
other nodes).
"""

import functools

import numpy as np
import pytest
import torch

from pbr_tpu.accel.forest import build_forest as jax_build_forest
from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops import pallas_bvh as jax_pallas_bvh
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.utils.config import BVHConfig as JaxBVHConfig
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu_torch import PathTracer, camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.accel.forest import build_forest
from pbr_tpu_torch.models.pathtracer import probe_compact_schedule
from pbr_tpu_torch.ops import cuda_bvh
from pbr_tpu_torch.scene.build import bvh_max_leaf, scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import grey_soup
from pbr_tpu_torch.utils.config import BVHConfig, RenderSettings

torch.set_num_threads(1)

SIZE = 16
# bench.py's settings, cut to 3 bounces: the grey soup's diffuse paths end
# at depth 3 anyway, and each bounce of the JAX reference is an
# interpret-mode kernel call.
FRAME = dict(width=SIZE, height=SIZE, samples=1, max_depth=3, max_added_depth=0,
             shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0))


@functools.lru_cache(maxsize=None)
def _scenes(mode):
    """bench.py's grey soup (orb light, eye at z = 3.5) at 600 faces, in
    both host layers: 8-face leaves for the slab walk, a forest of 256-face
    chunks for the forest walk. Returns (JAX scene, port scene, camera)."""
    leaves = 8 if mode == "pallas_bvh_hbm" else None
    obj = grey_soup(600)
    js, _ = jax_scene_from_text(*obj, use_bvh=True,
                                bvh_cfg=leaves and JaxBVHConfig(max_faces=leaves))
    ps, _ = scene_from_text(*obj, use_bvh=True, bvh_cfg=leaves and BVHConfig(max_faces=leaves))
    if mode == "pallas_bvh_forest":
        js = js._replace(forest=jax_build_forest(js.tris, chunk=256))
        ps = ps._replace(forest=build_forest(ps.tris, chunk=256))
    cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    return js, ps, cam


def _jax_frame(js, cam, mode, monkeypatch, **kw):
    for name in ("intersect_bvh_packet", "intersect_bvh_packet_hbm", "intersect_bvh_forest"):
        monkeypatch.setattr(jax_pallas_bvh, name,
                            functools.partial(getattr(jax_pallas_bvh, name), interpret=True))
    settings = JaxSettings(intersector=mode, **FRAME)
    ids = np.arange(SIZE * SIZE, dtype=np.int32)
    from pbr_tpu.scene.build import bvh_max_leaf as jax_max_leaf

    with np.errstate(all="ignore"):
        return jax_integrator.trace_rays(np, js, cam, settings, ids, 3,
                                         max_leaf=jax_max_leaf(js), **kw)


def _port_frame(ps, cam, mode, **kw):
    settings = RenderSettings(intersector=mode, **FRAME)
    ids = torch.arange(SIZE * SIZE, dtype=torch.int32)
    return trace_rays(to_torch(ps, "cpu"), camera_to_torch(cam, "cpu"), settings, ids, 3,
                      max_leaf=bvh_max_leaf(ps), **kw)


@pytest.mark.parametrize("mode", ["bvh", "pallas_bvh", "pallas_bvh_forest", "pallas_bvh_hbm"])
def test_frame_matches_jax_package(mode, monkeypatch):
    js, ps, cam = _scenes(mode)
    ref = np.stack(list(_jax_frame(js, cam, mode, monkeypatch).color), axis=-1)
    got = _port_frame(ps, cam, mode).color.stack().numpy()
    d = np.abs(got - ref).max(axis=-1)
    assert (d <= 1e-3).mean() >= 0.99, f"{(d > 1e-3).mean():.2%} of pixels differ"
    assert np.isfinite(got).all() and got.mean() > 0.01


def test_bvh_counters_match_jax_package(monkeypatch):
    """``heat_tests`` and ``heat_visits`` of a 16² frame through 'bvh'
    (K8's plain version): the JAX package's exact counters."""
    js, ps, cam = _scenes("bvh")
    ref = _jax_frame(js, cam, "bvh", monkeypatch, with_stats=True)
    got = _port_frame(ps, cam, "bvh", with_stats=True)
    for name in ("heat_tests", "heat_visits"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert b.sum() > 0
        assert (a == b).mean() >= 0.9, name
        assert abs(int(a.sum()) - int(b.sum())) <= 0.05 * b.sum(), name
    assert int(got.n_path_rays) == int(ref.n_path_rays)


@pytest.mark.parametrize("mode", ["pallas_bvh", "pallas_bvh_forest"])
def test_packet_modes_count_nothing_and_compaction_is_bitwise(mode):
    """The packet walks give no per-ray counters (zeros, as the JAX package
    gives for a mode without them); compaction on (the occupancy probe's
    schedule) and off gives the same frame bitwise."""
    _, ps, cam = _scenes(mode)
    full = _port_frame(ps, cam, mode, with_stats=True)
    assert not full.heat_tests.any() and not full.heat_visits.any()
    settings = RenderSettings(intersector=mode, compact_block=16, **FRAME)
    ts, tc = to_torch(ps, "cpu"), camera_to_torch(cam, "cpu")
    settings = settings.replace(compact_schedule=probe_compact_schedule(
        ts, tc, settings, max_leaf=bvh_max_leaf(ps)))
    assert settings.compact_schedule
    ids = torch.arange(SIZE * SIZE, dtype=torch.int32)
    comp = trace_rays(to_torch(ps, "cpu"), camera_to_torch(cam, "cpu"), settings, ids, 3,
                      max_leaf=bvh_max_leaf(ps))
    plain = trace_rays(to_torch(ps, "cpu"), camera_to_torch(cam, "cpu"),
                       settings.replace(compact_schedule=()), ids, 3, max_leaf=bvh_max_leaf(ps))
    assert int(comp.n_dropped) == 0
    for a, b in zip(comp.color, plain.color):
        assert torch.equal(a, b)


def test_pathtracer_derives_max_leaf_and_renders_the_slab_walk(monkeypatch):
    """``PathTracer(max_leaf=None)`` takes ``bvh_max_leaf(scene)`` (8 here)
    and hands it to every intersect call of the frame."""
    _, ps, cam = _scenes("pallas_bvh_hbm")
    seen = []
    real = cuda_bvh.intersect_bvh_packet_hbm

    def spy(*args, **kw):
        seen.append(kw["max_leaf"])
        return real(*args, **kw)

    monkeypatch.setattr(cuda_bvh, "intersect_bvh_packet_hbm", spy)
    pt = PathTracer(ps, RenderSettings(intersector="pallas_bvh_hbm", **FRAME), device="cpu",
                    lane_order="scanline")
    assert pt.max_leaf == bvh_max_leaf(ps) == 8
    pt.render(cam, frame_seed=1)
    img = pt.image()
    assert seen and set(seen) == {8}
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
    assert PathTracer(ps, RenderSettings(**FRAME), device="cpu", max_leaf=64).max_leaf == 64
