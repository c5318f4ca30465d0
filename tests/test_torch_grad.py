"""Gradients through the port (torch.autograd over trace_rays) against
``jax.grad`` of the JAX package's ``trace_rays`` on the CPU, and against
central finite differences of the port itself.

The losses are those of tests/test_grad.py: 16² frames, detached sampling,
so for a fixed seed the frame is a piecewise-smooth function of materials,
lights and camera, and AD follows the smooth piece. Gradients are switched
on with ``SceneParams.requires_grad_()`` and ``requires_grad_()`` on the
camera's eye, as a user would.

Tolerances. Against ``jax.grad``: rtol 1e-4 plus 1e-5 of the largest
magnitude of the gradient, since the two frameworks sum float32 in other
orders and torch's CPU sqrt is 1 ULP off NumPy's on ~0.7% of inputs.
Against finite differences: those of tests/test_grad.py (float32
differences of a loss at eps 1e-3 to 1e-2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.scene.build import bvh_max_leaf, derive_static_flags, scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.scene.procedural import cornell_box, multi_room, single_triangle
from pbr_tpu.utils.config import RenderSettings
from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import cuda_cull as cc
from pbr_tpu_torch.ops import cuda_gated as cg
from pbr_tpu_torch.scene.procedural import grey_soup

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine (measured: a
# 3 s test took 180 s with four workers).
torch.set_num_threads(1)


def _cornell():
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(width=16, height=16, samples=1, max_depth=3, max_added_depth=0,
                              shadow_rays=1, anti_aliasing=0.3, sky_light=(0.85, 0.9, 1.0))
    return scene, cam, settings


def _triangle():
    """tests/test_grad.py::test_camera_eye_grads: one triangle, an
    unoccluded orb light, Schlick; the image moves smoothly with the eye."""
    obj, mtl, _ = single_triangle()
    lights = "newlight l\ntype 2\npos 0.5 2.0 1.0\nradius 0.05\nrgb 3 3 3\n"
    scene, _ = scene_from_text(obj, mtl, lights, use_bvh=False)
    cam = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(width=16, height=16, samples=1, max_depth=2, max_added_depth=0,
                              shadow_rays=1, anti_aliasing=0.0, brdf=0)
    return scene, cam, settings


def _multiroom():
    """bench.py's multiroom configuration at 16² (use_bvh=True: 1,428
    faces with clusters, so the port's auto dispatch runs the gated sweep;
    the JAX package on the CPU walks the BVH)."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    cam = make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0))
    settings = derive_static_flags(scene, RenderSettings(
        width=16, height=16, samples=1, max_depth=3, max_added_depth=5, shadow_rays=1,
        anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0)))
    return scene, cam, settings


def _soup():
    """bench.py's soup scene (grey material, orb light, eye at z = 3.5) at
    6,400 faces, 112 clusters, at 16², both packages through
    intersector='cull' (the JAX package's in interpret mode, its bounce loop
    a scan to keep the compile short): the port's big-band path, sorted and
    early-out, at a size the CPU takes."""
    scene, _ = scene_from_text(*grey_soup(6400), use_bvh=True)
    cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    settings = derive_static_flags(scene, RenderSettings(
        width=16, height=16, samples=1, max_depth=3, max_added_depth=5, shadow_rays=1,
        anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0), intersector="cull",
        bounce_loop="scan"))
    return scene, cam, settings


SETUPS = {"cornell": _cornell, "triangle": _triangle, "multiroom": _multiroom,
          "soup": _soup}


def _pixel_loss(color, squared):
    """Per-pixel terms of the loss: tests/test_grad.py's squared colors, or
    bench.py's color sum."""
    if squared:
        return color.x ** 2 + color.y ** 2 + color.z ** 2
    return color.x + color.y + color.z


def _port_loss(ts, tc, settings, squared, weights=None, seed=13):
    """The port's loss, with optional per-pixel ``weights``; also returns
    the frame's colors, (npx, 3)."""
    npx = settings.width * settings.height
    ids = torch.arange(npx, dtype=torch.int32)
    res = trace_rays(ts, tc, settings, ids, seed)
    terms = _pixel_loss(res.color, squared)
    if weights is not None:
        terms = terms * torch.tensor(weights)
    scale = 1.0 / npx if squared else 1.0
    return terms.sum() * scale, res.color.stack().detach().numpy()


def _port_grads(name, squared, weights):
    scene, cam, settings = SETUPS[name]()
    ts = to_torch(scene, "cpu").requires_grad_()
    tc = camera_to_torch(cam, "cpu")
    for c in tc.eye:
        c.requires_grad_()
    loss, color = _port_loss(ts, tc, settings, squared, weights)
    loss.backward()
    # A parameter that no path reaches (e.g. the refraction index of an
    # all-opaque scene) has no .grad; jax.grad gives zeros for it.
    grads = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
             for name, p in ts.named_parameters()}
    grads["eye"] = np.array([float(c.grad) for c in tc.eye], dtype=np.float32)
    return float(loss.detach()), grads, color


@functools.lru_cache(maxsize=None)
def _jax_loss_fn(name, squared):
    scene, cam, settings = SETUPS[name]()
    tree = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    jscene, jcam = tree(scene), tree(cam)
    npx = settings.width * settings.height
    ids = jnp.arange(npx, dtype=jnp.int32)
    max_leaf = bvh_max_leaf(scene)

    def loss(mats, lights, cam_, weights):
        sc = jscene._replace(materials=mats, lights=lights)
        res = jax_integrator.trace_rays(jnp, sc, cam_, settings, ids, jnp.uint32(13),
                                        max_leaf=max_leaf)
        scale = 1.0 / npx if squared else 1.0
        color = jnp.stack([res.color.x, res.color.y, res.color.z], -1)
        return jnp.sum(_pixel_loss(res.color, squared) * weights) * scale, color

    f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True, allow_int=True))
    return functools.partial(f, jscene.materials, jscene.lights, jcam)


def _jax_grads(name, squared, weights):
    (val, color), (gm, gl, gc) = _jax_loss_fn(name, squared)(jnp.asarray(weights))
    st = lambda v: np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])  # noqa: E731
    grads = {f"mat_{k}": np.asarray(getattr(gm, k)) for k in
             ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd")}
    grads.update(mat_kd=st(gm.kd), mat_ks=st(gm.ks), light_pos=st(gl.pos),
                 light_rgb=st(gl.rgb), light_radius=np.asarray(gl.radius),
                 eye=np.array([gc.eye.x, gc.eye.y, gc.eye.z], dtype=np.float32))
    return float(val), grads, np.asarray(color)


@functools.lru_cache(maxsize=None)
def _matched_grads(name, squared):
    """Both packages' gradients of the loss over the pixels whose colors
    agree within 1e-3. A ULP difference (torch's CPU sqrt; the gated
    sweep's linear form against the BVH walk's classic form at shared box
    edges) can flip a discrete decision of a path, and a flipped pixel
    contributes another gradient; the repo's frame gate allows 1% of such
    pixels, and so does this mask."""
    scene, _, settings = SETUPS[name]()
    npx = settings.width * settings.height
    ones = np.ones(npx, dtype=np.float32)
    _, _, color_p = _port_grads(name, squared, ones)
    _, _, color_j = _jax_grads(name, squared, ones)
    agree = (np.abs(color_p - color_j).max(axis=1) <= 1e-3).astype(np.float32)
    assert agree.mean() >= 0.99, f"{1 - agree.mean():.2%} of pixels flipped"
    return _port_grads(name, squared, agree)[:2], _jax_grads(name, squared, agree)[:2]


def _close(got, ref):
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale + 1e-7)


@pytest.mark.parametrize("name, squared", [
    ("cornell", True), ("triangle", True), ("multiroom", False), ("soup", False),
])
def test_grads_match_jax_grad(name, squared):
    """Every parameter of SceneParams (materials and lights) and the eye,
    over the pixels whose colors agree (``_matched_grads``)."""
    (loss, got), (ref_loss, ref) = _matched_grads(name, squared)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert set(got) == set(ref)
    for p in ref:
        assert np.isfinite(got[p]).all(), p
        _close(got[p], ref[p])
    assert np.abs(got["mat_kd"]).max() > 1e-4  # materials visibly matter
    assert np.abs(got["light_rgb"]).max() > 1e-4  # NEE makes the light matter


def test_multiroom_grads_run_through_the_gated_sweep(monkeypatch):
    """The multiroom loss is traced through the gated sweep at every
    bounce, and the material and light parameters get finite gradients."""
    calls = []
    real = cg.intersect_gated

    def spy(*args, **kw):
        calls.append(kw.get("alive") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(cg, "intersect_gated", spy)
    scene, cam, settings = _multiroom()
    ts = to_torch(scene, "cpu").requires_grad_()
    _port_loss(ts, camera_to_torch(cam, "cpu"), settings, squared=False)[0].backward()
    assert calls == [True] * settings.max_total_depth
    for name in ("mat_kd", "mat_ks", "mat_Rs", "mat_Rd", "light_pos", "light_rgb"):
        grad = getattr(ts, name).grad
        assert grad is not None and torch.isfinite(grad).all() and grad.abs().max() > 0, name


def _fd(f, x0: float, eps: float) -> float:
    return (f(x0 + eps) - f(x0 - eps)) / (2 * eps)


@pytest.mark.parametrize("param, index, eps, atol", [
    ("mat_kd", (0, 0), 1e-3, 5e-3),
    ("mat_kd", (0, 2), 1e-3, 5e-3),
    ("mat_kd", (1, 3), 1e-3, 5e-3),
    ("light_rgb", (0, 0), 1e-2, 5e-3),
])
def test_cornell_grads_match_finite_differences(param, index, eps, atol):
    """Central differences of the port's own loss (tests/test_grad.py's
    _fd_check tolerances: atol 5e-3, rtol 5e-2)."""
    scene, cam, settings = _cornell()
    _, grads, _ = _port_grads("cornell", True, None)
    ts = to_torch(scene, "cpu")
    tc = camera_to_torch(cam, "cpu")
    p = getattr(ts, param)
    x0 = float(p[index])

    def f(x):
        with torch.no_grad():
            p[index] = x
            return float(_port_loss(ts, tc, settings, squared=True)[0])

    fd = _fd(f, x0, eps)
    ad = float(grads[param][index])
    assert abs(fd - ad) <= atol + 5e-2 * abs(fd), (fd, ad)


def test_eye_grad_matches_finite_differences():
    """tests/test_grad.py::test_camera_eye_grads on the port: d loss /
    d eye.z against central differences (atol 1e-3, rtol 5e-2)."""
    scene, cam, settings = _triangle()
    _, grads, _ = _port_grads("triangle", True, None)
    ts = to_torch(scene, "cpu")
    tc0 = camera_to_torch(cam, "cpu")
    z0 = float(tc0.eye.z)

    def f(z):
        tc = tc0._replace(eye=tc0.eye._replace(z=torch.tensor(z, dtype=torch.float32)))
        with torch.no_grad():
            return float(_port_loss(ts, tc, settings, squared=True)[0])

    g = float(grads["eye"][2])
    assert np.isfinite(g) and abs(g) > 1e-6
    fd = _fd(f, z0, 1e-3)
    assert abs(fd - g) <= 1e-3 + 0.05 * abs(fd), (fd, g)


def test_light_pos_grad_matches_jax_and_is_finite():
    """The light position's y gradient on the Cornell loss (the value the
    port was first checked on: -16.97 against jax.grad)."""
    (_, got), (_, ref) = _matched_grads("cornell", True)
    g, r = got["light_pos"][1, 0], ref["light_pos"][1, 0]
    assert np.isfinite(g) and abs(g) > 1.0
    assert abs(g - r) <= 1e-4 * abs(r)


def test_soup_grads_run_through_the_cull_sweep(monkeypatch):
    """The soup loss is traced through the cull-and-sweep at every bounce,
    and kd, the light's rgb and the eye get finite, nonzero gradients."""
    calls = []
    real = cc.intersect_cull

    def spy(*args, **kw):
        calls.append(kw.get("alive") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(cc, "intersect_cull", spy)
    _, grads, _ = _port_grads("soup", False, None)
    assert calls == [True] * SETUPS["soup"]()[2].max_total_depth
    for name in ("mat_kd", "light_rgb", "eye"):
        assert np.isfinite(grads[name]).all() and np.abs(grads[name]).max() > 0, name
