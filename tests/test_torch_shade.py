"""The frame's shading (``pbr_tpu_torch/ops/cuda_shade.py``: kernels K11,
the camera rays, and K12, a bounce's shade) on the CPU, where the wrappers
run their plain versions, against the JAX package.

- ``gen_rays_plain`` against ``pbr_tpu.models.integrator._gen_rays`` with
  ``xp=jnp`` (pinhole, AA jitter, thin-lens DoF with finite and infinite
  previous distances): every component within 4 float32 ULPs of the
  larger of its magnitude and 1e-3 (ULP_TOL). torch's CPU sqrt is 1 ULP
  off NumPy's on ~0.7% of inputs, and the CPU sin and cos of the two
  frameworks differ by an ULP; a normalisation carries such an ULP into
  every component.
- ``trace_rays``, whose bounces go through ``cuda_shade.shade`` and whose
  samples go through ``cuda_shade.gen_rays`` (counted), against JAX's
  ``trace_rays`` for every combination K12 templates: Shirley-Ashikhmin and
  Schlick x NEE on and off x transparency on and off, a scene whose orb
  light the camera sees, compaction on, and a Phong frame. The gate is
  tests/test_torch_render.py's: at most 1% of pixels off by more than
  1e-3, and a mean difference below 1e-2 on the others (a ULP in a
  transcendental can flip a rare discrete decision of a path tracer). The
  frames with transparency on are held to the JAX package's NumPy oracle
  (``render_cpu``), as tests/test_torch_render.py's transparency test
  holds them: on the Shirley-Ashikhmin glass frame JAX's jitted CPU frame
  is itself 1.4-2.1% of pixels off that oracle, the port 0.2-0.4%
  (24² and 32², 2 samples).
- Under autograd, with parameters that require grad, the frame is
  bitwise the frame without it (on the CPU the plain version either way:
  under autograd through the autograd Functions, whose backward is the
  plain adjoint, tests/test_torch_shade_grad.py) and the gradients are
  finite: tests/test_torch_grad.py holds them to ``jax.grad``.
- The pointer slots of K11, K12 (``csrc/shade.cu``) and of their backward
  (``csrc/shade_bwd.cu``) are the wrappers', in order.

The kernels themselves run only on a card: tests/test_torch_shade_card.py.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops import rng as jax_rng
from pbr_tpu.reference.cpu import render_cpu
from pbr_tpu.scene.build import bvh_max_leaf, scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.scene.procedural import cornell_box, single_triangle
from pbr_tpu.utils.config import BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN, RenderSettings
from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.models import integrator
from pbr_tpu_torch.ops import counts, cuda_shade
from pbr_tpu_torch.ops.rng import PixelRng
from pbr_tpu_torch.scene.procedural import cornell_sphere

torch.set_num_threads(1)

ULP_TOL = 4
CAM_BOX = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
CAM_TRI = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))


def _ulps(got: np.ndarray, ref: np.ndarray) -> float:
    scale = np.spacing(np.maximum(np.abs(ref), np.float32(1e-3)).astype(np.float32))
    return float(np.max(np.abs(got.astype(np.float64) - ref) / scale))


@pytest.mark.parametrize("case", ["pinhole", "aa", "dof, finite prev_t", "dof, infinite prev_t"])
def test_gen_rays_plain_matches_jax(case):
    w, h, seed, s = 32, 24, 7, 1
    dof = case.startswith("dof")
    cam = make_camera_state(eye=(0.1, 1.0, 3.2), center_dir=(0.05, -0.1, 1.0),
                            focus=2.5 if dof else -1.0, focal_length=0.05, aperture=2.0)
    settings = RenderSettings(width=w, height=h, anti_aliasing=0.0 if case == "pinhole" else 0.7,
                              fov=40.0)
    ids = np.arange(w * h, dtype=np.int32)
    px, py = (ids % w).astype(np.float32), (ids // w).astype(np.float32)
    prev_t = np.random.default_rng(0).uniform(0.5, 4.0, w * h).astype(np.float32)
    prev_t[::5] = np.inf
    if case == "dof, infinite prev_t":
        prev_t[:] = np.inf
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    ro, rd = jax_integrator._gen_rays(jnp, jcam, settings, jnp.asarray(px), jnp.asarray(py),
                                      jax_rng.PixelRng(seed, jnp.asarray(ids, jnp.uint32)), s,
                                      jnp.asarray(prev_t))
    args = (camera_to_torch(cam, "cpu"), settings, torch.from_numpy(px), torch.from_numpy(py),
            PixelRng(seed, torch.from_numpy(ids)), s, torch.from_numpy(prev_t))
    o, d = cuda_shade.gen_rays_plain(*args)
    for got, ref in zip((*o, *d), (*ro, *rd)):
        ref = np.broadcast_to(np.asarray(ref), (w * h,))
        assert _ulps(got.numpy(), ref) <= ULP_TOL
    # On CPU tensors the wrapper is the plain version.
    for a, b in zip((*o, *d), (*cuda_shade.gen_rays(*args)[0], *cuda_shade.gen_rays(*args)[1])):
        assert torch.equal(a, b)


def _assert_close(got, ref, flip_budget=0.01, mean_tol=1e-2):
    """tests/test_torch_render.py's frame gate."""
    d = np.abs(got - ref).max(axis=-1)
    flips = (d > 1e-3).mean()
    assert flips <= flip_budget, f"{flips:.2%} pixels differ by more than 1e-3"
    agree = d <= 1e-3
    assert np.abs(got - ref)[agree].mean() < mean_tol


def _glass(scene):
    """The Cornell box with its glossy block turned to glass."""
    mats = scene.materials
    d = np.asarray(mats.d).copy()
    d[-2] = 0.3
    return scene._replace(materials=mats._replace(d=d, Ni=np.full_like(d, 1.5)))


def _scene(name: str):
    if name == "orb":
        # One triangle, a point light (light 0: NEE) and an orb the camera
        # sees in front of the triangle.
        obj, mtl, _ = single_triangle()
        lights = ("newlight p\ntype 1\npos 0.0 2.0 1.0\nradius 0.0\nrgb 4 4 4\n"
                  "newlight orb\ntype 2\npos 0.35 0.6 0.0\nradius 0.02\nrgb 5 3 1\n")
        return scene_from_text(obj, mtl, lights, use_bvh=False)[0], CAM_TRI
    if name == "phong":
        return scene_from_text(*cornell_sphere(), use_bvh=True, phong_tess_alpha=0.8)[0], CAM_BOX
    scene = scene_from_text(*cornell_box(), use_bvh=False)[0]
    return (_glass(scene) if name == "glass" else scene), CAM_BOX


def _settings(size: int, **kw) -> RenderSettings:
    base = dict(width=size, height=size, samples=1, max_depth=3, max_added_depth=2,
                shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
                no_transparency=True)
    base.update(kw)
    return RenderSettings(**base)


SA, SCH = BRDF_SHIRLEY_ASHIKHMIN, BRDF_SCHLICK
# (case, scene, size, settings): every combination K12 templates, the orb
# light, compaction on, and Phong tessellation.
CASES = [
    *((f"{'schlick' if brdf == SCH else 'sa'}, nee {nee}, {'glass' if glass else 'opaque'}",
       "glass" if glass else "box", 24,
       dict(brdf=brdf, shadow_rays=nee, no_transparency=not glass, samples=2 if glass else 1))
      for brdf in (SA, SCH) for nee in (1, 0) for glass in (False, True)),
    ("orb light", "orb", 24, dict(brdf=SCH)),
    ("compaction", "box", 32, dict(compact_block=16, compact_schedule=((2, 0.5), (3, 0.25)),
                                   max_depth=4)),
    ("phong", "phong", 16, dict(phong_tessellation=0.8)),
]


def _jax_frame(scene, cam, settings, seed):
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    ids = jnp.arange(settings.width * settings.height, dtype=jnp.int32)
    f = jax.jit(functools.partial(jax_integrator.trace_rays, jnp, max_leaf=bvh_max_leaf(scene)),
                static_argnames=("settings",))
    res = f(jscene, jcam, settings=settings, pixel_ids=ids, frame_seed=jnp.uint32(seed))
    return np.stack([np.asarray(c) for c in res.color], -1)


def _spied(monkeypatch) -> dict:
    """Counts the integrator's calls of the two wrappers."""
    calls = {"gen_rays": 0, "shade": 0}
    for name in calls:
        real = getattr(integrator, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(integrator, name, spy)
    return calls


def _port_frame(scene, cam, settings, seed):
    ids = torch.arange(settings.width * settings.height, dtype=torch.int32)
    return trace_rays(to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"), settings, ids, seed,
                      max_leaf=bvh_max_leaf(scene))


@pytest.mark.parametrize("case, scene_name, size, kw", CASES, ids=[c[0] for c in CASES])
def test_trace_through_the_shade_matches_jax(case, scene_name, size, kw, monkeypatch):
    scene, cam = _scene(scene_name)
    settings = _settings(size, **kw)
    calls = _spied(monkeypatch)
    before = counts()
    with torch.no_grad():
        res = _port_frame(scene, cam, settings, 3)
    got = res.color.stack().numpy()
    # Every sample's camera rays and every bounce's shade went through the
    # wrappers, which on CPU tensors run the plain versions: no launch.
    assert calls == {"gen_rays": settings.samples,
                     "shade": settings.samples * settings.max_total_depth}
    assert counts() == before
    assert np.isfinite(got).all() and got.sum() > 0
    if settings.no_transparency:
        ref = _jax_frame(scene, cam, settings, 3)
    else:
        ref = render_cpu(scene, cam, settings, frame_seed=3)[0].reshape(-1, 3)
    _assert_close(got, ref)


def test_the_orb_case_sees_its_orb():
    """The orb-light case's camera rays hit the orb (light 1) where they
    miss the triangle, so its emission is in the frame."""
    scene, cam = _scene("orb")
    settings = _settings(24)
    ts = to_torch(scene, "cpu")
    ids = torch.arange(24 * 24, dtype=torch.int32)
    px, py = (ids % 24).float(), (ids // 24).float()
    o, d = cuda_shade.gen_rays_plain(camera_to_torch(cam, "cpu"), settings, px, py,
                                     PixelRng(3, ids), 0, torch.full((24 * 24,), np.inf))
    orb = cuda_shade._orb_pass(o, d, ts.lights, torch.full((24 * 24,), np.inf))
    assert int((orb == 1).sum()) > 4


def test_grad_path_gives_the_same_frame(monkeypatch):
    """With the scene's parameters and the eye requiring grad, the frame is
    bitwise the no-grad frame (the plain version either way on the CPU),
    every bounce still through ``shade``, and the gradients are finite."""
    scene, cam = _scene("glass")
    settings = _settings(16, no_transparency=False)
    ids = torch.arange(16 * 16, dtype=torch.int32)
    ts = to_torch(scene, "cpu")
    ct = camera_to_torch(cam, "cpu")
    with torch.no_grad():
        ref = trace_rays(ts, ct, settings, ids, 5)
    calls = _spied(monkeypatch)
    ts.requires_grad_()
    eye_x = ct.eye.x.clone().requires_grad_()
    ct = ct._replace(eye=ct.eye._replace(x=eye_x))
    res = trace_rays(ts, ct, settings, ids, 5)
    assert calls == {"gen_rays": 1, "shade": settings.max_total_depth}
    for a, b in zip(res.color, ref.color):
        assert a.requires_grad and torch.equal(a.detach(), b)
    loss = res.color.x.sum() + res.color.y.sum() + res.color.z.sum()
    grads = torch.autograd.grad(loss, [ts.mat_kd, ts.light_rgb, eye_x])
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().sum()) > 0


def _source(enum: str) -> str:
    """The source that defines ``enum``: the backward's in shade_bwd.cu."""
    name = "shade_bwd.cu" if enum in ("BwdPtr", "GenBwdPtr") else "shade.cu"
    return (Path(cuda_shade.__file__).resolve().parents[1] / "csrc" / name).read_text()


def _enum(name: str) -> tuple:
    src = _source(name)
    body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return tuple(w for w in re.findall(r"\b[A-Z][A-Z0-9_]*\b", body))


@pytest.mark.parametrize("enum, names, total", [
    ("ShadePtr", cuda_shade.SHADE_PTRS, "kShadePtrs"),
    ("GenPtr", cuda_shade.GEN_PTRS, "kGenPtrs"),
    ("BwdPtr", cuda_shade.SHADE_BWD_PTRS, "kBwdPtrs"),
    ("GenBwdPtr", cuda_shade.GEN_BWD_PTRS, "kGenBwdPtrs"),
])
def test_pointer_slots_match_the_kernel_source(enum, names, total):
    """The wrappers fill the kernels' pointer arrays in the order of the
    source's enums (a slot out of place would hand a kernel the wrong
    tensor)."""
    found = _enum(enum)
    assert re.search(rf"\b{total}\b", _source(enum))
    assert found == names


def test_shade_launch_counts_are_counted():
    assert {"K11", "K12", "K12 pre", "K12 post", "K11 bwd", "K12 bwd"} <= set(counts())
