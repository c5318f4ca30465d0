"""The port's bench entry point (``python -m pbr_tpu_torch.bench``) against
the JAX package, on the CPU at small sizes, and its command line.

- the ray count: the bench's path segments, shadow rays and compaction
  drops (``bench.count_rays`` over ``bench.bench_scene``) equal, exactly,
  the JAX package's ``trace_rays(..., with_stats=True)`` count on its
  NumPy backend, on the same scene and settings, and the root bench.py's
  ``count_fn`` (``trace_rays(jnp, ...)`` under jit, bench.py:288-316) but
  for the bounces of the lanes whose path XLA's rounding flips (none on
  the Cornell box, one lane of 1,024 on the soup); the probed schedule
  and the lane order are the JAX package's too: the Cornell box at 32²
  (scanline) and 64² (a schedule stage active), a soup of 300 faces at
  32² (Morton, with a BVH);
- the step: ``bench.step``'s loss and its gradient sums of kd.x, rgb.x and
  eye.x, and those of ``bench.step_grads`` to every material, light and
  camera parameter, over 2 frames from seed0 = 1, on the Cornell box at
  16², against bench.py's step body (bench.py:350-378) under
  ``jax.value_and_grad`` on the CPU, with the tolerance and the
  agree-mask of tests/test_torch_grad.py;
- the command line: ``--device cpu`` prints bench.py's four keys last,
  unit rays/s, a metric ending in " [cpu]" (in a subprocess); without
  ``--device cpu`` and with no card it exits non-zero and prints no
  result; a missing model (bench.py's suzanne, an absent .obj) exits 2;
  ``--scaling``'s harness at dp 1 and 2 on gloo CPU ranks gives a finite
  T1/T2.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.models.integrator import trace_rays as jax_trace_rays
from pbr_tpu.models.pathtracer import probe_compact_schedule as jax_probe
from pbr_tpu.ops import rng as jax_rng
from pbr_tpu.scene.build import bvh_max_leaf as jax_max_leaf
from pbr_tpu.scene.build import derive_static_flags as jax_derive_static_flags
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.camera import make_camera_state as jax_camera
from pbr_tpu.scene.procedural import cornell_box as jax_cornell_box
from pbr_tpu.scene.procedural import random_soup as jax_random_soup
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu.utils.morton import morton_pixel_ids as jax_morton
from pbr_tpu_torch import bench, trace_rays
from pbr_tpu_torch.ops import rng as port_rng
from pbr_tpu_torch.ops.cuda_bvh import leaf_bound
from pbr_tpu_torch.ops.vec import Vec3

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline"}


def _jax_scene(name: str):
    """bench.py's scene ``name`` and camera, built by the JAX package's host
    layer as bench.py builds it (bench.py:134-201)."""
    if name.startswith("soup:"):
        mtl = ("newmtl grey\nKd 0.62 0.62 0.62\nKs 1.0 1.0 1.0\nrough 1.0\np 1.0\n"
               "nu 0\nnv 0\nRs 0.05\nRd 0.95\n")
        li = "newlight orb\ntype 2\nrgb 1.6 1.5 1.4\npos 0.0 2.4 0.0\nradius 0.09\n"
        obj = jax_random_soup(int(name.split(":")[1]), seed=11).replace(
            "o soup\n", "o soup\nusemtl grey\n", 1)
        scene, _ = jax_scene_from_text(obj, mtl, li, use_bvh=True)
        return scene, jax_camera(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    scene, _ = jax_scene_from_text(*jax_cornell_box(), use_bvh=False)
    return scene, jax_camera(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))


def _jax_settings(settings) -> JaxSettings:
    """The port's settings as the JAX package's (the same dataclass)."""
    return JaxSettings(**{f.name: getattr(settings, f.name)
                          for f in dataclasses.fields(JaxSettings)})


def _tree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


@pytest.mark.parametrize("name, size", [("cornell", 64), ("soup:300", 32)])
def test_ray_count_equals_jax_count(name, size):
    """Rays a frame and drops, against the JAX package with the same lane
    order and settings. Exactly those of its ``trace_rays`` on its NumPy
    backend at seed 0, every lane's bounces too; and bench.py's
    ``count_fn`` (``trace_rays(jnp, ...)`` under jit): the same drops over
    seeds 0-3, and path segments and shadow rays that differ only by the
    bounces of the lanes whose path flips under XLA's rounding (colour off
    by more than 1e-3; at most 1% of lanes, the frame gate), so exactly
    where none flips. At 64² the Cornell box's probed schedule has an
    active stage (below 4,096 lanes no stage cuts a 1,024-lane tile)."""
    b = bench.bench_scene(name, size, "cpu")
    scene, cam = _jax_scene(name)
    max_leaf = jax_max_leaf(scene)
    if scene.bvh is not None:  # the walks take the tree's own bound, JAX's
        assert leaf_bound(b.scene.bvh) == max_leaf
    settings = _jax_settings(b.settings)
    assert settings == jax_derive_static_flags(scene, settings)
    morton = name != "cornell"  # bench.py's lane-order rule
    ids = jax_morton(size, size) if morton else np.arange(size * size, dtype=np.int32)
    np.testing.assert_array_equal(b.pixel_ids.numpy(), ids)
    if morton:  # the probe over Morton lanes and a BVH (tests/test_torch_render.py holds
        # the scanline probe to the JAX package's)
        assert b.settings.compact_schedule == jax_probe(
            scene, cam, settings.replace(compact_schedule=()), max_leaf=max_leaf, pixel_ids=ids)

    got = bench.count_rays(b)
    ref = jax_trace_rays(np, scene, cam, settings, ids, np.uint32(0), max_leaf=max_leaf,
                         with_stats=True)
    assert got[:2] == (int(ref.n_path_rays), int(ref.n_shadow_rays))
    with torch.no_grad():
        mine = trace_rays(b.scene, b.cam, b.settings, b.pixel_ids, 0, with_stats=True)
    np.testing.assert_array_equal(mine.heat_bounces.numpy(), np.asarray(ref.heat_bounces))
    assert got[0] > 0 and got[1] > 0
    if name == "cornell":  # a stage of the schedule is active: the drops are counted
        assert ref.n_dropped is not None and mine.n_dropped is not None

    @functools.partial(jax.jit, static_argnames=("settings",))
    def count_fn(scene, cam, ids, seed, settings):
        res = jax_trace_rays(jnp, scene, cam, settings, ids, seed, max_leaf=max_leaf,
                             with_stats=True)
        return res.n_path_rays, res.n_shadow_rays, res.n_dropped, res.color

    js, jc, jids = _tree(scene), _tree(cam), jnp.asarray(ids)
    n_path, n_shadow, n_drop, color = count_fn(js, jc, jids, jnp.uint32(0), settings)
    jdrops = [n_drop] + [count_fn(js, jc, jids, jnp.uint32(s), settings)[2] for s in (1, 2, 3)]
    assert max(0 if d is None else int(d) for d in jdrops) == got[2]
    jcolor = np.stack([np.asarray(color.x), np.asarray(color.y), np.asarray(color.z)], -1)
    flipped = int((np.abs(mine.color.stack().numpy() - jcolor).max(axis=1) > 1e-3).sum())
    assert flipped <= 0.01 * size * size
    slack = flipped * b.settings.max_total_depth
    assert abs(int(n_path) - got[0]) <= slack and abs(int(n_shadow) - got[1]) <= slack


@functools.lru_cache(maxsize=None)
def _jax_frame(b: bench.Bench):
    """bench.py's frame body (bench.py:350-354) under jax.value_and_grad,
    jitted on the CPU, each pixel's colour sum weighted by ``weights``
    (ones: bench.py's loss): ``f(seed, weights) -> ((loss, colours),
    (materials, lights, camera) gradients)``."""
    scene, cam = _jax_scene("cornell")
    js, jc = _tree(scene), _tree(cam)
    settings = _jax_settings(b.settings)
    ids = jnp.asarray(b.pixel_ids.numpy())

    def frame_loss(params, seed, weights):
        mats, lights, camst = params
        sc = js._replace(materials=mats, lights=lights)
        res = jax_trace_rays(jnp, sc, camst, settings, ids, seed, max_leaf=jax_max_leaf(scene))
        color = jnp.stack([res.color.x, res.color.y, res.color.z], -1)
        return (color.sum(-1) * weights).sum(), color

    f = jax.jit(jax.value_and_grad(frame_loss, has_aux=True, allow_int=True))
    return lambda seed, weights: f((js.materials, js.lights, jc), seed, jnp.asarray(weights))


def _named(grads) -> dict:
    """JAX's (materials, lights, camera) gradients keyed as the port's
    ``render_params`` (a Vec3 field's three components stacked)."""
    gm, gl, gc = grads
    st = lambda v: np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])  # noqa: E731
    out = {}
    for prefix, tree in (("mat_", gm), ("light_", gl)):
        for k, v in tree._asdict().items():
            if k not in ("light", "type"):  # the integer fields
                out[prefix + k] = st(v) if hasattr(v, "x") else np.asarray(v)
    for k, v in gc._asdict().items():
        if hasattr(v, "x"):
            out.update({f"cam.{k}.{c}": np.asarray(getattr(v, c)) for c in "xyz"})
        else:
            out[f"cam.{k}"] = np.asarray(v)
    return out


def _jax_step(b: bench.Bench, seed0: int, frames: int, weights):
    """bench.py's step (bench.py:356-378) over ``frames`` frames: the loss
    and every parameter's gradient (``_named``), summed over the frames,
    and each frame's colours."""
    loss, grads, colors = 0.0, {}, []
    for k in range(frames):
        (val, color), g = _jax_frame(b)(jax_rng.fold(jnp.uint32(seed0), jnp.uint32(k)), weights)
        loss += float(val)
        for name, v in _named(g).items():
            grads[name] = grads.get(name, 0.0) + v.astype(np.float64)
        colors.append(np.asarray(color))
    return (loss, grads), np.stack(colors)


def _colors(b: bench.Bench, seed0: int, frames: int) -> np.ndarray:
    """(frames, B, 3) colours of the step's frames on the port."""
    out = []
    with torch.no_grad():
        for k in range(frames):
            res = trace_rays(b.scene, b.cam, b.settings, b.pixel_ids, port_rng.fold(seed0, k))
            out.append(res.color.stack().numpy())
    return np.stack(out)


def _close(got, ref):
    """tests/test_torch_grad.py's tolerance: rtol 1e-4, atol 1e-5 of the
    largest magnitude."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale + 1e-7)


SEED0, FRAMES = 1, 2


@functools.lru_cache(maxsize=None)
def _matched_step():
    """The Cornell box at 16² set up for the step, the pixels whose colours
    agree within 1e-3 between the port and JAX in each of the step's
    frames (a ULP of a transcendental can flip a pixel's path; one pixel
    here), and bench.py's step body over those pixels: ``(b, agree,
    (loss, grads))``."""
    b = bench.differentiable(bench.bench_scene("cornell", 16, "cpu"))
    ref, jax_colors = _jax_step(b, SEED0, FRAMES, np.ones(16 * 16, dtype=np.float32))
    agree = (np.abs(_colors(b, SEED0, FRAMES) - jax_colors).max(axis=2) <= 1e-3).all(axis=0)
    assert agree.mean() >= 0.99
    if not agree.all():
        ref, _ = _jax_step(b, SEED0, FRAMES, agree.astype(np.float32))
    return b, agree, ref


def test_step_matches_bench_py_body(monkeypatch):
    """``bench.step`` (forward and backward, 2 frames from seed0 = 1) on the
    Cornell box at 16² against bench.py's body under jax.value_and_grad:
    the loss and the gradient sums of kd.x, rgb.x and eye.x. Where a
    pixel's path flips between the two, both losses take only the pixels
    whose colours agree (``_matched_step``), as tests/test_torch_grad.py
    does: JAX's weighted by that mask, the port's colours multiplied by it
    as ``trace_rays`` returns them to the step."""
    b, agree, (loss, grads) = _matched_step()
    ref = (loss, grads["mat_kd"][0], grads["light_rgb"][0], grads["cam.eye.x"])
    if not agree.all():
        w = torch.tensor(agree.astype(np.float32))
        real = bench.trace_rays

        def masked(*args, **kw):
            res = real(*args, **kw)
            return res._replace(color=Vec3(res.color.x * w, res.color.y * w, res.color.z * w))

        monkeypatch.setattr(bench, "trace_rays", masked)
    got = bench.step(b.scene, b.cam, b.settings, b.pixel_ids, SEED0, frames=FRAMES)
    assert abs(float(got[0]) - ref[0]) <= 1e-5 * abs(ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert np.isfinite(g.numpy()).all()
        _close(g.numpy(), r)
    assert np.abs(got[1].numpy()).max() > 1e-4  # the materials matter
    # Every field of the camera gets its gradient, not the eye alone.
    cam = b.cam
    assert all(t.requires_grad for f in cam for t in (f if isinstance(f, tuple) else (f,)))


def test_step_grads_match_bench_py_body_for_every_parameter():
    """``bench.step_grads``, the gradients behind ``bench.step``: every
    material and light parameter and every camera field (eye, w, u, v,
    focal_length, aperture, focus), summed over the step's 2 frames, against
    bench.py's body over the pixels whose colours agree (``weights``), with
    the tolerance of ``_close``."""
    b, agree, (loss, ref) = _matched_step()
    got_loss, got = bench.step_grads(b.scene, b.cam, b.settings, b.pixel_ids, SEED0,
                                     frames=FRAMES, weights=torch.tensor(agree.astype(np.float32)))
    assert abs(float(got_loss) - loss) <= 1e-5 * abs(loss)
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        _close(g, r)
    assert np.abs(ref["cam.w.z"]).max() > 1e-4  # the camera's basis matters, not the eye alone


def test_forward_step_is_the_frames_colour_sum():
    """``--fwd-only``'s step: the sum of the frames' colours, no graph."""
    b = bench.bench_scene("cornell", 16, "cpu")
    got = bench.step(b.scene, b.cam, b.settings, b.pixel_ids, 3, frames=2, fwd_only=True)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), _colors(b, 3, 2).astype(np.float64).sum(), rtol=1e-5)


@pytest.fixture(scope="module")
def cli_runs():
    """``python -m pbr_tpu_torch.bench --device cpu --size 16 --iters 1``
    with and without ``--fwd-only``, both started at once: {fwd_only:
    (exit code, stdout, stderr)}."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {fwd: subprocess.Popen(
        [sys.executable, "-m", "pbr_tpu_torch.bench", "--device", "cpu", "--size", "16",
         "--iters", "1", *(["--fwd-only"] if fwd else [])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for fwd in (False, True)}
    try:
        out = {}
        for fwd, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[fwd] = (p.returncode, stdout, stderr)
        return out
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


@pytest.mark.parametrize("fwd_only", [False, True], ids=["fwd+bwd", "fwd"])
def test_cli_prints_bench_py_keys_last(cli_runs, fwd_only):
    rc, stdout, stderr = cli_runs[fwd_only]
    assert rc == 0, stderr
    last = json.loads(stdout.strip().splitlines()[-1])
    assert set(last) == KEYS and last["unit"] == "rays/s"
    mode = "fwd" if fwd_only else "fwd+bwd"
    assert last["metric"] == f"rays/s/chip ({mode}) 1spp 16x16 cornell [cpu]"
    assert math.isfinite(last["value"]) and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 200e6, 4)
    assert "[bench] device: cpu" in stderr
    assert "16x16: " in stderr and " rays/frame" in stderr


def test_without_a_card_exits_and_prints_no_result(monkeypatch, capsys):
    """No card and no ``--device cpu``: a non-zero exit and no line on
    stdout; no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--size", "16", "--iters", "1"])
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_missing_model_exits_2(capsys):
    """bench.py's --scene suzanne, a model the repository does not carry:
    exit 2 and no result, as bench.py exits when the model is absent."""
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--scene", "suzanne", "--size", "16"])
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert "[bench] scene not found" in out.err and out.out == ""


def test_missing_obj_path_exits_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--scene", str(tmp_path / "absent.obj"), "--size", "16"])
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert "[bench] scene not found" in out.err and out.out == ""


def test_scaling_on_gloo_ranks(monkeypatch):
    """``--scaling``'s harness at dp 1 and 2, 16², on gloo CPU ranks (one
    torch thread each): a finite, positive T1/T2 line."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = bench.run_scaling(iters=2, dps=(1, 2), size=16, timeout=240)
    assert out["metric"] == "dp-sharding overhead efficiency T1/T2 (gloo CPU ranks, 16x16)"
    assert out["unit"] == "ratio" and math.isfinite(out["value"]) and out["value"] > 0
