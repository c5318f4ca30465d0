"""The port's compiled steps (``pbr_tpu_torch/utils/graph.py``): the frame
step of ``PathTracer``, the bench's K-frame step and ``fit``'s
value-and-grad, each a function over static tensors that the card captures
once as a CUDA graph and replays. Here, on the CPU, the same static-buffer
form runs eagerly, and is held to:

- (a) the eager path, bitwise: ``PathTracer`` over 4 frames with a new
  camera object, a ``move_light`` and a ``reset_sample_count`` between
  them, against ``render_frame``; the bench's ``FrameStep`` at K = 3 and
  16² against ``step_grads`` / ``step`` over 3 frames and against the sum
  of three one-frame steps, and to bench.py's own body under ``lax.scan``
  with K = 3 (tests/test_torch_bench.py's tolerance and agree-mask);
  ``app.fit_steps`` against the eager loss and gradient, and against
  ``jax.value_and_grad`` of the JAX CLI's loss
  (tests/test_torch_app.py::test_fit_loss_and_grad_match_jax's tolerance);
- (b) a no-host-read guard (``HostReadGuard``, a ``TorchDispatchMode``
  here): K1's plain version, and
  Cornell's frame step and bench step forward and backward, run under it
  without one op that reads the device from the host or whose output's
  shape depends on the data, so a host read added later fails here before
  any card run; the guard itself raises on each kind;
- (c) ``warmup`` then ``render`` gives ``render``'s image alone, and
  ``warmup`` leaves the sample count at 0;
- (d) without a card, ``PathTracer(device='cuda')``, the bench and ``fit``
  raise or exit, and never carry on on the CPU; a capture off the card
  raises;
- a replay's launches: ``ops.KERNELS`` finds each kernel instance from its
  CUDA function's demangled name (as the driver's graph nodes and
  torch.profiler give it) and covers every ``__global__`` of csrc/; a
  replay adds its graph's kernel nodes to ``counts()``; a wrapper counts
  no launch under capture.

The card's own checks (graphed frames bitwise against eager ones, the
graph's kernel nodes against an eager frame's launches and the device's
profiled kernels) are chip_smoke.py's graph phase; the test marked
``cuda`` below runs only where there is a card.
"""

import dataclasses
import json
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pbr_tpu import app as jax_app
from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.models.integrator import trace_rays as jax_trace_rays
from pbr_tpu.ops import rng as jax_rng
from pbr_tpu.scene.build import bvh_max_leaf as jax_max_leaf
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.camera import make_camera_state as jax_camera
from pbr_tpu.scene.procedural import cornell_box as jax_cornell_box
from pbr_tpu.utils.config import CameraConfig as JaxCameraConfig
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu_torch import PathTracer, app, bench
from pbr_tpu_torch.models.pathtracer import init_frame_state, render_frame
from pbr_tpu_torch import ops
from pbr_tpu_torch.ops import counts, cuda_intersect, zero_counts
from pbr_tpu_torch.ops import rng as port_rng
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.parallel.mesh import render_params
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.device import camera_to_torch, to_torch
from pbr_tpu_torch.scene.procedural import cornell_box
from pbr_tpu_torch.utils.config import CameraConfig, RenderSettings
from pbr_tpu_torch.utils import graph as graph_mod
from pbr_tpu_torch.utils.graph import CapturedStep


# ------------------------------------------------------ the host-read guard --

_aten = torch.ops.aten
# Ops that read the device from the host, or whose output's shape depends
# on the data (so the host must read it): none may run inside a CUDA graph.
_HOST_READS = {
    _aten._local_scalar_dense.default: "reads a value to the host (item, int, float, bool)",
    _aten.nonzero.default: "output shape depends on the data",
    _aten.argwhere.default: "output shape depends on the data",
    _aten.masked_select.default: "output shape depends on the data",
    _aten.equal.default: "returns a host bool",
    _aten.is_nonzero.default: "returns a host bool",
    _aten.bincount.default: "output shape depends on the data",
    _aten._unique.default: "output shape depends on the data",
    _aten._unique2.default: "output shape depends on the data",
    _aten.unique_dim.default: "output shape depends on the data",
    _aten.unique_consecutive.default: "output shape depends on the data",
}
_BOOL_INDEXED = (_aten.index.Tensor, _aten.index_put.default, _aten.index_put_.default,
                 _aten._index_put_impl_.default)


class HostReadError(RuntimeError):
    """An op that needs the host to read the device."""


class HostReadGuard(TorchDispatchMode):
    """While active, every op that reads the device from the host, or whose
    output's shape depends on the data, raises ``HostReadError`` before it
    runs: ``_HOST_READS``, ``repeat_interleave`` with tensor repeats and no
    ``output_size``, and a boolean index."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _HOST_READS.get(func)
        if func is _aten.repeat_interleave.Tensor and kwargs.get("output_size") is None:
            why = "tensor repeats without output_size: output shape depends on the data"
        if func in _BOOL_INDEXED and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                         for i in args[1]):
            why = "a boolean index: output shape depends on the data"
        if why:
            raise HostReadError(f"{func}: {why}")
        return func(*args, **kwargs)

torch.set_num_threads(1)

SIZE = 16


def _settings(**kw) -> RenderSettings:
    return bench.bench_settings(SIZE, compact_schedule="auto", **kw)


def _cornell():
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    return scene, make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))


def _state_equal(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.rgb, b.rgb))
            and torch.equal(a.depth, b.depth) and torch.equal(a.sample_count, b.sample_count))


# --------------------------------------------------------- (a) PathTracer --

@pytest.mark.parametrize("lane_order", ["auto", "morton"])
def test_pathtracer_static_step_equals_render_frame_bitwise(lane_order):
    """4 frames through ``PathTracer.render``'s static-buffer step (seed,
    camera and accumulator static, the state updated in place) against
    ``render_frame`` on a scene and camera of its own: a new camera object
    after frame 0, a light moved after frame 1 (accumulation restarts), the
    count reset after frame 2 and a new camera object equal in value for
    frame 3; bitwise after every frame. The ``light_pos`` parameter handed
    out before the move keeps the old position; the step reads the new."""
    scene, cam_a = _cornell()
    cam_b = make_camera_state(eye=(0.1, 1.05, 3.1), center_dir=(0.02, 0.0, 1.0))
    cam_b2 = make_camera_state(eye=(0.1, 1.05, 3.1), center_dir=(0.02, 0.0, 1.0))
    pt = PathTracer(scene, _settings(), device="cpu", lane_order=lane_order)
    pt.warmup(cam_a)  # the probes: the reference takes their settings and lanes
    ts = to_torch(scene, "cpu")
    ref = init_frame_state(SIZE * SIZE, "cpu")
    handed_out = pt.scene.light_pos
    old = handed_out.detach().clone()
    for i, cam in enumerate((cam_a, cam_b, cam_b, cam_b2)):
        if i == 2:
            pt.move_light(0, 0.05, -0.3, 0.1)
            with torch.no_grad():
                ts.light_pos[:, 0] += torch.tensor((0.05, -0.3, 0.1))
            ref = init_frame_state(SIZE * SIZE, "cpu")
            assert torch.equal(handed_out, old)
            assert torch.equal(pt.scene.light_pos, ts.light_pos)
        if i == 3:
            pt.reset_sample_count()
            ref = init_frame_state(SIZE * SIZE, "cpu")
            assert pt.sample_count == 0
        pt.render(cam, frame_seed=i)
        with torch.no_grad():
            ref = render_frame(ts, camera_to_torch(cam, "cpu"), pt.settings, ref, pt.pixel_ids, i,
                               max_leaf=pt.max_leaf)
        assert _state_equal(pt.state, ref), f"frame {i}"
    assert pt.sample_count == 1 and pt.graph is not None and pt.graph.graph is None


def test_pathtracer_state_assignment_copies_into_the_static_state():
    """Assigning ``pt.state`` (a restored checkpoint) writes into the step's
    static tensors: the next frame blends onto it."""
    scene, cam = _cornell()
    pt = PathTracer(scene, _settings(), device="cpu")
    pt.render(cam, 0)
    pt.render(cam, 1)
    saved = init_frame_state(SIZE * SIZE, "cpu")
    for d, s in zip((*saved.rgb, saved.depth, saved.sample_count),
                    (*pt.state.rgb, pt.state.depth, pt.state.sample_count)):
        d.copy_(s)
    static = pt.state
    pt.render(cam, 2)
    ref = pt.image().copy()
    pt.state = saved
    assert pt.state is static and pt.sample_count == 2
    pt.render(cam, 2)
    np.testing.assert_array_equal(pt.image(), ref)


# ----------------------------------------------------- (a) the bench step --

SEED0, K = 1, 3


def _frame_grads(b: bench.Bench, seed):
    """One frame's colour sum and its gradient to every parameter of
    ``render_params``, zeros where a parameter is unused."""
    params = render_params(b.scene, b.cam)
    loss = bench._frame_loss(b.scene, b.cam, b.settings, b.pixel_ids, seed)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), got)}


@functools.lru_cache(maxsize=None)
def _bench_cornell():
    return bench.differentiable(bench.bench_scene("cornell", SIZE, "cpu"))


def test_bench_k_frame_step_equals_the_eager_step_and_three_one_frame_steps():
    """``FrameStep`` (one frame's step over static tensors, its seed
    ``fold(seed0, k)`` from a static counter, replayed K = 3 times into
    static sums) against ``step_grads(..., frames=3)`` and against the sum
    of three one-frame steps: the loss and all 28 gradients, bitwise; a
    second call restarts the sums."""
    b = _bench_cornell()
    fs = bench.FrameStep(b)
    fs(7, 2)  # a call with other seeds first: the next must not carry it over
    loss, grads = fs(SEED0, K)
    ref_loss, ref = bench.step_grads(b.scene, b.cam, b.settings, b.pixel_ids, SEED0, frames=K)
    assert torch.equal(loss, ref_loss) and set(grads) == set(ref) and len(ref) == 28
    for name, g in ref.items():
        assert torch.equal(grads[name], g), name
    one = [_frame_grads(b, port_rng.fold(SEED0, k)) for k in range(K)]
    assert torch.equal(loss, one[0][0] + one[1][0] + one[2][0])
    for name in ref:
        assert torch.equal(grads[name], one[0][1][name] + one[1][1][name] + one[2][1][name]), name


def test_bench_forward_k_frame_step_equals_the_eager_step():
    """``FrameStep(fwd_only=True)`` at K = 3 against ``step(...,
    fwd_only=True, frames=3)`` and three one-frame colour sums: bitwise."""
    b = bench.bench_scene("cornell", SIZE, "cpu")
    got = bench.FrameStep(b, fwd_only=True)(SEED0, K)
    ref = bench.step(b.scene, b.cam, b.settings, b.pixel_ids, SEED0, frames=K, fwd_only=True)
    assert torch.equal(got, ref) and not got.requires_grad
    with torch.no_grad():
        one = [bench._frame_loss(b.scene, b.cam, b.settings, b.pixel_ids,
                                 port_rng.fold(SEED0, k)) for k in range(K)]
    assert torch.equal(got, one[0] + one[1] + one[2])


def test_frame_seed_from_the_static_counter_equals_fold():
    """The seed a replay derives on the device, ``fold(seed0, k)`` of two
    int64 tensors, equals ``fold`` of Python ints and JAX's uint32 fold."""
    for seed0 in (0, 1, 2, 12345, 2**32 - 1):
        for k in (0, 1, 2, 31):
            t = port_rng.fold(torch.tensor(seed0, dtype=torch.int64), torch.tensor(k))
            assert int(t) == port_rng.fold(seed0, k) == int(jax_rng.fold(jnp.uint32(seed0),
                                                                           jnp.uint32(k)))


def _jax_settings(settings) -> JaxSettings:
    return JaxSettings(**{f.name: getattr(settings, f.name)
                          for f in dataclasses.fields(JaxSettings)})


@functools.lru_cache(maxsize=None)
def _jax_scan_step():
    """bench.py's backward step (bench.py:350-378) with its ``lax.scan`` over
    K frames, on the JAX package's Cornell box at the port's settings and
    lanes, each pixel's colour sum weighted by ``weights`` (ones: bench.py's
    loss): ``f(weights) -> ((loss, (K, B, 3) colours), gradient sums)``."""
    b = _bench_cornell()
    scene, _ = jax_scene_from_text(*jax_cornell_box(), use_bvh=False)
    cam = jax_camera(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    tree = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    js, jc = tree(scene), tree(cam)
    settings = _jax_settings(b.settings)
    ids = jnp.asarray(b.pixel_ids.numpy())
    max_leaf = jax_max_leaf(scene)

    def step(weights):
        params0 = (js.materials, js.lights, jc)

        def frame_loss(params, seed):
            mats, lights, camst = params
            sc = js._replace(materials=mats, lights=lights)
            res = jax_trace_rays(jnp, sc, camst, settings, ids, seed, max_leaf=max_leaf)
            color = jnp.stack([res.color.x, res.color.y, res.color.z], -1)
            return (color.sum(-1) * weights).sum(), color

        def body(carry, k):
            loss_sum, gsum = carry
            seed = jax_rng.fold(jnp.uint32(SEED0), k)
            (loss, color), grads = jax.value_and_grad(frame_loss, has_aux=True,
                                                      allow_int=True)(params0, seed)
            gsum = jax.tree_util.tree_map(
                lambda a, g: a if g.dtype == jax.dtypes.float0 else a + g, gsum, grads)
            return (loss_sum + loss, gsum), color

        gzero = jax.tree_util.tree_map(jnp.zeros_like, params0)
        return jax.lax.scan(body, (jnp.float32(0.0), gzero), jnp.arange(K, dtype=jnp.uint32))

    return jax.jit(step)


def _named(grads) -> dict:
    """JAX's (materials, lights, camera) gradients keyed as ``render_params``."""
    gm, gl, gc = grads
    st = lambda v: np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])  # noqa: E731
    out = {}
    for prefix, tree in (("mat_", gm), ("light_", gl)):
        for k, v in tree._asdict().items():
            if k not in ("light", "type"):
                out[prefix + k] = st(v) if hasattr(v, "x") else np.asarray(v)
    for k, v in gc._asdict().items():
        if hasattr(v, "x"):
            out.update({f"cam.{k}.{c}": np.asarray(getattr(v, c)) for c in "xyz"})
        else:
            out[f"cam.{k}"] = np.asarray(v)
    return out


def _close(got, ref):
    """tests/test_torch_grad.py's tolerance: rtol 1e-4, atol 1e-5 of the
    largest magnitude."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale + 1e-7)


def test_bench_k_frame_step_matches_bench_py_scan_body(monkeypatch):
    """``FrameStep`` at K = 3 against bench.py's body under ``lax.scan`` with
    K = 3 and ``jax.value_and_grad``: the loss within 1e-5 of its magnitude
    and all 28 gradients with ``_close``'s tolerance. Where a pixel's path
    flips in some frame (a ULP of a transcendental; at most 1% of each
    frame's pixels, the repo's frame gate), both take only the pixels whose
    colours agree within 1e-3 in every frame:
    JAX's weighted by that mask, the port's colours multiplied by it, as
    tests/test_torch_bench.py::test_step_matches_bench_py_body does."""
    b = _bench_cornell()
    f = _jax_scan_step()
    ones = np.ones(SIZE * SIZE, dtype=np.float32)
    (loss, jgrads), colors = f(jnp.asarray(ones))
    with torch.no_grad():
        mine = np.stack([bench.trace_rays(b.scene, b.cam, b.settings, b.pixel_ids,
                                          port_rng.fold(SEED0, k)).color.stack().numpy()
                         for k in range(K)])
    per_frame = np.abs(mine - np.asarray(colors)).max(axis=2) <= 1e-3  # (K, B)
    assert (per_frame.mean(axis=1) >= 0.99).all()  # the repo's frame gate, each frame
    agree = per_frame.all(axis=0)
    if not agree.all():
        (loss, jgrads), _ = f(jnp.asarray(agree.astype(np.float32)))
        w = torch.tensor(agree.astype(np.float32))
        real = bench.trace_rays

        def masked(*args, **kw):
            res = real(*args, **kw)
            return res._replace(color=Vec3(res.color.x * w, res.color.y * w, res.color.z * w))

        monkeypatch.setattr(bench, "trace_rays", masked)
    got_loss, got = bench.FrameStep(b)(SEED0, K)
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    ref = _named(jgrads)
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        _close(g, r)
    assert np.abs(ref["mat_kd"]).max() > 1e-4


# -------------------------------------------------------------- (a) fit --

def _fit_problem(size: int):
    settings = RenderSettings().replace(width=size, height=size, shadow_rays=1, brdf=0,
                                        max_depth=2, max_added_depth=0)
    scene, settings = app._load_scene("cornell", settings)
    import argparse

    args = argparse.Namespace(eye=None, center=None, size=size)
    cam = app._camera_for(args, CameraConfig(), "cornell").state()
    return app.fit_problem(scene, settings, cam, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_fit(size: int):
    """tests/test_torch_app.py's JAX CLI fit problem: ``jax.value_and_grad``
    of its loss, and its albedos."""
    import argparse

    settings = JaxSettings().replace(width=size, height=size, shadow_rays=1, brdf=0,
                                     max_depth=2, max_added_depth=0)
    scene, settings = jax_app._load_scene("cornell", settings)
    args = argparse.Namespace(eye=None, center=None, size=size)
    cam = jax_app._camera_for(args, JaxCameraConfig(), "cornell").state()
    tree = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    jscene, jcam = tree(scene), tree(cam)
    npx = size * size
    ids = jnp.arange(npx, dtype=jnp.int32)

    def render(kd):
        sc = jscene._replace(materials=jscene.materials._replace(kd=kd))
        return jax_integrator.trace_rays(jnp, sc, jcam, settings, ids, jnp.uint32(5)).color

    target = render(jscene.materials.kd)

    def loss_fn(kd):
        c = render(kd)
        return (jnp.sum((c.x - target.x) ** 2) + jnp.sum((c.y - target.y) ** 2)
                + jnp.sum((c.z - target.z) ** 2)) / npx

    return jax.jit(jax.value_and_grad(loss_fn)), jscene.materials.kd


def test_fit_steps_match_the_eager_step_and_jax():
    """``app.fit_steps`` at 16², at the CLI's starting point: the loss and
    its gradient in kd bitwise those of the eager step (the variable copied
    in, the loss under autograd), and against ``jax.value_and_grad`` of the
    JAX CLI's loss with test_fit_loss_and_grad_match_jax's tolerance (loss
    within 1e-5 of its magnitude, gradient rtol 1e-4, atol 1e-5 of its
    largest magnitude); ``loss_at`` gives the same loss and leaves no
    gradient on; a second call at other albedos restarts from them."""
    vg, kd0 = _jax_fit(SIZE)
    noise = np.random.RandomState(0).uniform(-0.3, 0.3, kd0.x.shape)
    kd_j = kd0._replace(x=jnp.clip(kd0.x + jnp.asarray(noise, jnp.float32), 0, 1))
    ref_loss, ref_g = vg(kd_j)
    ref_g = np.stack([np.asarray(ref_g.x), np.asarray(ref_g.y), np.asarray(ref_g.z)])
    kd = torch.tensor(np.stack([np.asarray(kd_j.x), np.asarray(kd_j.y), np.asarray(kd_j.z)]))

    prob = _fit_problem(SIZE)
    param = prob.ts.mat_kd
    value_and_grad, loss_at = app.fit_steps(prob)
    value_and_grad(kd * 0.5)
    loss, g = value_and_grad(kd)
    g = g.clone()
    with torch.no_grad():
        param.copy_(kd)
    param.requires_grad_(True)
    eager = prob.loss()
    (eager_g,) = torch.autograd.grad(eager, param)
    param.requires_grad_(False)
    assert loss == float(eager.detach()) and torch.equal(g, eager_g)
    assert loss_at(kd) == loss and not param.requires_grad
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)) and loss > 0.1
    scale = float(np.abs(ref_g).max())
    assert scale > 1e-3
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-4, atol=1e-5 * scale + 1e-7)


# ------------------------------------------------------ (b) no host reads --

@pytest.mark.parametrize("nee", [True, False], ids=["K1", "K1'"])
def test_k1_plain_version_reads_nothing_from_the_host(nee):
    """K1's plain version (the Cornell frame's intersector on the CPU) under
    the guard: no op reads the host."""
    rng = np.random.default_rng(0)
    scene, _ = _cornell()
    ts = to_torch(scene, "cpu")
    o = Vec3(*(torch.tensor(rng.uniform(-0.5, 0.5, 512), dtype=torch.float32) + c
               for c in (0.0, 1.0, 1.0)))
    d = Vec3(*(torch.tensor(rng.normal(size=512), dtype=torch.float32) for _ in range(3)))
    d = d / torch.sqrt(d.x * d.x + d.y * d.y + d.z * d.z)
    light = Vec3(*(ts.light_pos[i, 0] for i in range(3))) if nee else None
    with HostReadGuard():
        out = cuda_intersect.intersect_fused(o, d, ts.tris, light_pos=light)
    assert out[1].shape == (512,) and int((out[1] >= 0).sum()) > 0


@pytest.mark.parametrize("fwd_only", [True, False], ids=["forward", "backward"])
def test_cornell_bench_step_reads_nothing_from_the_host(fwd_only):
    """Cornell's bench step (K1; a compaction stage active at 64²) over 2
    frames, forward or with the backward to all 28 parameters, under the
    guard: no op of the frame, of its compaction or of autograd's backward
    reads the host, so the step can be captured."""
    b = bench.bench_scene("cornell", 64, "cpu")
    assert b.settings.compact_schedule
    if not fwd_only:
        b = bench.differentiable(b)
    fs = bench.FrameStep(b, fwd_only)
    with HostReadGuard():
        out = fs(SEED0, 2)
    loss = out if fwd_only else out[0]
    assert float(loss) > 0


def test_pathtracer_frame_step_reads_nothing_from_the_host():
    """``PathTracer``'s frame step on Cornell after ``warmup`` (whose probes
    read the host, before any capture) under the guard: the frames read
    nothing; the compaction-overflow guard reads its count only after the
    step."""
    scene, cam = _cornell()
    pt = PathTracer(scene, bench.bench_settings(64, compact_schedule="auto"), device="cpu")
    pt.warmup(cam)
    assert pt.settings.compact_schedule
    step = pt._step()
    for i in range(2):
        pt._seed.fill_(i)
        with HostReadGuard():
            n_dropped = step()
        assert int(n_dropped) == 0
    assert pt.sample_count == 2


@pytest.mark.parametrize("what", ["item", "nonzero", "bool index", "repeat_interleave"])
def test_guard_raises_on_every_kind_of_host_read(what):
    """The guard raises on a value read to the host and on ops whose
    output's shape depends on the data, and passes what a frame does."""
    x = torch.arange(6.0)
    ops = {
        "item": lambda: float(x.sum()),
        "nonzero": lambda: torch.nonzero(x > 2),
        "bool index": lambda: x[x > 2],
        "repeat_interleave": lambda: torch.repeat_interleave(x, torch.tensor([1, 0, 2, 1, 1, 1])),
    }
    with HostReadGuard():
        torch.where(x > 2, x, 0.0).sum()
        torch.repeat_interleave(x, 2)
        x[torch.tensor([0, 2])]
    with pytest.raises(HostReadError):
        with HostReadGuard():
            ops[what]()


# ---------------------------------------------------------- (c) warmup --

def test_warmup_then_render_equals_render_alone():
    """``warmup`` resolves the probes and leaves the accumulator untouched
    (sample count 0, zeros); a render after it gives the image of a render
    alone."""
    scene, cam = _cornell()
    pt = PathTracer(scene, _settings(), device="cpu")
    pt.warmup(cam)
    assert pt.sample_count == 0 and pt.settings.compact_schedule
    assert all(float(t.abs().sum()) == 0.0 for t in (*pt.state.rgb, pt.state.depth))
    pt.render(cam, 4)
    alone = PathTracer(scene, _settings(), device="cpu")
    alone.render(cam, 4)
    assert pt.sample_count == alone.sample_count == 1
    assert pt.settings == alone.settings and pt.lane_order == alone.lane_order
    np.testing.assert_array_equal(pt.image(), alone.image())


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_warmup_captures_and_render_replays_on_the_card():
    """On the card: ``warmup`` captures the frame step and undoes its eager
    frame; the next ``render`` replays the graph, bitwise a render alone."""
    scene, cam = _cornell()
    pt = PathTracer(scene, _settings(), device="cuda")
    pt.warmup(cam)
    assert pt.graph.graph is not None and pt.sample_count == 0
    pt.render(cam, 4)
    alone = PathTracer(scene, _settings(), device="cuda")
    alone.render(cam, 4)
    assert pt.graph.replays == 1
    np.testing.assert_array_equal(pt.image(), alone.image())


# ------------------------------------------------------- (d) no fallback --

def test_without_a_card_nothing_carries_on_on_the_cpu(monkeypatch, capsys):
    """No card: ``PathTracer(device='cuda')`` raises, the bench and ``fit``
    exit with no result, and a capture off the card raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    scene, _ = _cornell()
    with pytest.raises((RuntimeError, AssertionError)):
        PathTracer(scene, _settings())
    with pytest.raises(SystemExit) as e:
        bench.main(["--size", "16", "--iters", "1", "--frames-per-step", "2"])
    assert e.value.code != 0 and capsys.readouterr().out == ""
    with pytest.raises(SystemExit) as e:
        app.main(["fit", "--scene", "cornell", "--size", "16", "--steps", "1"])
    assert e.value.code != 0
    with pytest.raises(ValueError, match="card"):
        CapturedStep(lambda t: t + 1, torch.zeros(2)).capture()


def test_bench_frames_per_step_must_be_positive(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--size", "16", "--frames-per-step", "0"])
    assert e.value.code == 2 and capsys.readouterr().out == ""


def test_captured_step_on_the_cpu_copies_inputs_and_calls_the_function():
    """On a CPU tensor the step copies its inputs into the static tensors and
    calls the function, every time; no graph, no replays."""
    buf = torch.zeros(3)
    step = CapturedStep(lambda t: t * 2.0, buf, name="double")
    out = step(torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(out, torch.tensor([2.0, 4.0, 6.0])) and torch.equal(buf, out / 2.0)
    assert torch.equal(step(None), out) and step.graph is None and step.replays == 0
    with pytest.raises(ValueError):
        step(buf, buf)


# ------------------------------------------- a replay's measured launches --

# A demangled name of each kernel instance's CUDA function, as the driver
# (``cuFuncGetName`` then ``__cxa_demangle``) and torch.profiler give it.
_RAYS = "float const*, float const*, float const*, float const*, float const*, float const*"
_KERNEL_NAMES = {
    "K1": f"void (anonymous namespace)::brute_intersect_kernel<true, false>({_RAYS}, "
          "float4 const*, int, float const*, int, float*, int*, int*)",
    "K1'": f"void (anonymous namespace)::brute_intersect_kernel<false, false>({_RAYS}, "
           "float4 const*, int, float const*, int, float*, int*, int*)",
    "K2": f"void (anonymous namespace)::brute_intersect_kernel<true, true>({_RAYS}, "
          "float4 const*, int, float const*, int, float*, int*, int*)",
    "K2'": f"void (anonymous namespace)::brute_intersect_kernel<false, true>({_RAYS}, "
           "float4 const*, int, float const*, int, float*, int*, int*)",
    "K3": f"void (anonymous namespace)::gated_kernel<false>({_RAYS}, float4 const*)",
    "K3 any-hit": f"void (anonymous namespace)::gated_kernel<true>({_RAYS}, float4 const*)",
    "K4": "void (anonymous namespace)::slotted_kernel<64, false>((anonymous namespace)::Rays, "
          "float4 const*, int)",
    "K4 any-hit": "void (anonymous namespace)::slotted_kernel<128, true>((anonymous "
                  "namespace)::Rays, float4 const*, int)",
    "K4m": "void (anonymous namespace)::masked_kernel<128, false>((anonymous namespace)::Rays, "
           "float4 const*, int, unsigned char const*)",
    "K4m any-hit": "void (anonymous namespace)::masked_kernel<64, true>((anonymous "
                   "namespace)::Rays, float4 const*, int, unsigned char const*)",
    "K5": "void (anonymous namespace)::slotted_rows_kernel<false>((anonymous namespace)::Rays, "
          "float4 const*, int)",
    "K5 any-hit": "void (anonymous namespace)::slotted_rows_kernel<true>((anonymous "
                  "namespace)::Rays, float4 const*, int)",
    "K5m": "void (anonymous namespace)::masked_rows_kernel<false>((anonymous namespace)::Rays, "
           "float4 const*, int, int const*)",
    "K5m any-hit": "void (anonymous namespace)::masked_rows_kernel<true>((anonymous "
                   "namespace)::Rays, float4 const*, int, int const*)",
    "K6 nearest": "void (anonymous namespace)::packet_kernel<0>((anonymous namespace)::Params)",
    "K6 NEE": "void (anonymous namespace)::packet_kernel<1>((anonymous namespace)::Params)",
    "K6 any-hit": "void (anonymous namespace)::packet_kernel<2>((anonymous namespace)::Params)",
    "K6 seeded": "void (anonymous namespace)::chain_kernel<false>((anonymous "
                 "namespace)::ChainParams)",
    "K6 seeded any-hit": "void (anonymous namespace)::chain_kernel<true>((anonymous "
                         "namespace)::ChainParams)",
    "K7 nearest": "void (anonymous namespace)::slab_kernel<0>((anonymous "
                  "namespace)::SlabParams)",
    "K7 NEE": "void (anonymous namespace)::slab_kernel<1>((anonymous namespace)::SlabParams)",
    "K8": "void (anonymous namespace)::walk_kernel<false>((anonymous namespace)::Params)",
    "K8 any-hit": "void (anonymous namespace)::walk_kernel<true>((anonymous namespace)::Params)",
    "K9": "void (anonymous namespace)::phong_walk_kernel<false>((anonymous namespace)::Params)",
    "K9 any-hit": "void (anonymous namespace)::phong_walk_kernel<true>((anonymous "
                  "namespace)::Params)",
    "K10": "void (anonymous namespace)::phong_clusters_kernel((anonymous namespace)::Params)",
    "K11": "void (anonymous namespace)::gen_rays_kernel((anonymous namespace)::GenArgs)",
    "K12": "void (anonymous namespace)::shade_kernel<1, true, false, false, 0>((anonymous "
           "namespace)::ShadeArgs)",
    "K12 pre": "void (anonymous namespace)::shade_kernel<1, true, false, true, 1>((anonymous "
               "namespace)::ShadeArgs)",
    "K12 post": "void (anonymous namespace)::shade_kernel<0, true, true, false, 2>((anonymous "
                "namespace)::ShadeArgs)",
    "K11 bwd": "void (anonymous namespace)::gen_rays_bwd_kernel((anonymous "
               "namespace)::GenBwdArgs)",
    "K12 bwd": "void (anonymous namespace)::shade_bwd_kernel<1, true, false, true>((anonymous "
               "namespace)::BwdArgs)",
    "K13": "void (anonymous namespace)::row_gather_kernel<0, 4>((anonymous "
           "namespace)::CompactArgs)",
    "K13 bwd": "void (anonymous namespace)::row_gather_kernel<1, 4>((anonymous "
               "namespace)::CompactArgs)",
    "K14": "void (anonymous namespace)::row_gather_kernel<2, 1>((anonymous "
           "namespace)::CompactArgs)",
    "K14 bwd": "void (anonymous namespace)::row_gather_kernel<3, 4>((anonymous "
               "namespace)::CompactArgs)",
}


@pytest.mark.parametrize("inst", sorted(_KERNEL_NAMES))
def test_kernel_instance_of_each_kernel_function(inst):
    """Each instance of ``counts()`` is found from its function's demangled
    name, and no other instance is."""
    assert set(ops.KERNELS) == set(counts()) == set(_KERNEL_NAMES)
    assert ops.kernel_instance(_KERNEL_NAMES[inst]) == inst


@pytest.mark.parametrize("name", [
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
    "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
    "void at::native::(anonymous namespace)::indexing_backward_kernel<float, 4>(long const*)",
    "Memcpy DtoD (Device -> Device)",
    "void (anonymous namespace)::my_walk_kernel<true>((anonymous namespace)::Params)",
])
def test_kernel_instance_of_other_functions_is_none(name):
    """torch's kernels, copies and a name that only ends like a port kernel's
    are not the port's kernels."""
    assert ops.kernel_instance(name) is None


def test_kernel_table_names_every_kernel_function_of_the_sources():
    """``ops.KERNELS`` covers every ``__global__`` function of csrc/, and
    names no other."""
    import pathlib
    import re

    src = pathlib.Path(ops.__file__).resolve().parents[1] / "csrc"
    defined = set()
    for f in src.glob("*.cu"):
        text = f.read_text()
        pat = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\("
        for m in re.finditer(pat, text):
            defined.add(m.group(1))
    named = {re.match(r"\w+", pat).group(0) for pat in ops.KERNELS.values()}
    assert defined == named


@pytest.mark.parametrize("mangled, inst", [
    (b"_ZN12_GLOBAL__N_122brute_intersect_kernelILb1ELb0EEEvPKfS2_S2_S2_S2_S2_PK6float4iS2_iPf"
     b"PiS7_", "K1"),
    (b"_ZN12_GLOBAL__N_114slotted_kernelILi64ELb0EEEvNS_4RaysEPK6float4iPKiS6_PKfS6_i", "K4"),
    (b"_ZN12_GLOBAL__N_113packet_kernelILi1EEEvNS_6ParamsE", "K6 NEE"),
    (b"_ZN12_GLOBAL__N_111walk_kernelILb1EEEvNS_6ParamsE", "K8 any-hit"),
    (b"_ZN45_GLOBAL__N__bbf69a31_12_shade_bwd_cu_4872029216shade_bwd_kernelILi1ELb0ELb0ELb1EEEv"
     b"NS_7BwdArgsE", "K12 bwd"),
])
def test_driver_names_demangle_to_their_instances(mangled, inst):
    """A mangled name, as ``cuFuncGetName`` gives it, demangles to the
    instance's function; a name that is not mangled stays as it is."""
    assert ops.kernel_instance(graph_mod._demangle(mangled)) == inst
    assert graph_mod._demangle(b"not_mangled") == "not_mangled"


def test_a_replay_adds_its_graphs_kernel_nodes_to_counts():
    """Each replay of a captured step adds its graph's kernel nodes to
    ``counts()`` by instance (torch's own kernels do not count), and
    ``zero_counts`` clears them."""

    class _Graph:
        replayed = 0

        def replay(self):
            self.replayed += 1

    step = CapturedStep(lambda t: t + 1.0, torch.zeros(2), name="replayed")
    step.device, step.graph, step.out = torch.device("cuda"), _Graph(), "out"
    step.kernels = {_KERNEL_NAMES["K1"]: 8, _KERNEL_NAMES["K3 any-hit"]: 2,
                    "void at::native::vectorized_elementwise_kernel<4>(int)": 500}
    zero_counts()
    assert step() == "out" and step() == "out"
    assert step.graph.replayed == step.replays == 2
    assert {k: v for k, v in counts().items() if v} == {"K1": 16, "K3 any-hit": 4}
    assert ops.kernel_counts(step.kernels) == {"K1": 8, "K3 any-hit": 2}
    zero_counts()
    assert not any(counts().values())


def test_a_wrapper_counts_no_launch_under_capture(monkeypatch):
    """``count_launch`` counts a launch, but not under capture, where the
    kernel only becomes a graph node."""
    table = {"K1": 0}
    for capturing in (False, True, False):
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda c=capturing: c)
        ops.count_launch(table, "K1")
    assert table == {"K1": 2}


def test_graph_steps_digests_tell_bitwise_equal_tensors(tmp_path):
    """tools/graph_steps.py holds two trees' sums and frames equal by their
    bytes' digests: -0.0 is not +0.0, a NaN equals itself, and the dtype
    counts."""
    from pbr_tpu_torch.tools import graph_steps as gs

    a = torch.tensor([0.0, 1.5, float("nan")])
    assert gs.digest(a) == gs.digest(a.clone())
    assert gs.digest(a) != gs.digest(torch.tensor([-0.0, 1.5, float("nan")]))
    assert gs.digest(a) != gs.digest(a.double())
    assert gs.digest(a[1]) == gs.digest(torch.tensor(1.5))  # a step's loss is 0-d
    assert gs.digest(a[1]) != gs.digest(a[1:2])
    for name, val in (("x.json", a), ("y.json", a.clone()), ("z.json", a + 1)):
        (tmp_path / name).write_text(json.dumps({"digests": {"c fwd": {"frame": gs.digest(val)}}}))
    assert gs.compare(tmp_path / "x.json", tmp_path / "y.json") == {"c fwd/frame": True}
    assert gs.compare(tmp_path / "x.json", tmp_path / "z.json") == {"c fwd/frame": False}


def test_graph_steps_compare_holds_gradients_to_a_tolerance(tmp_path):
    """With ``tol``, tools/graph_steps.py's comparison takes a backward
    step's gradient within ``tol`` of its largest magnitude (two trees that
    sum the same terms in other orders); forward frames and losses stay
    bitwise, and without ``tol`` everything is."""
    from pbr_tpu_torch.tools import graph_steps as gs

    def record(name, frame, loss, grad):
        (tmp_path / name).write_text(json.dumps({
            "digests": {"c fwd": {"frame": gs.digest(frame)},
                        "c fwd+bwd": {"loss": gs.digest(loss), "g": gs.digest(grad)}},
            "values": {"c fwd": {}, "c fwd+bwd": {"g": grad.tolist()}}}))

    frame, loss, grad = torch.tensor([0.5, 2.0]), torch.tensor(3.0), torch.tensor([4.0, -8.0])
    record("a.json", frame, loss, grad)
    record("b.json", frame, loss, grad + torch.tensor([0.0, 0.007]))  # 0.0009 of 8
    record("c.json", frame, loss, grad + torch.tensor([0.0, 0.009]))  # 0.0011 of 8
    record("d.json", frame, loss + 1e-6, grad)
    record("e.json", frame + 1e-6, loss, grad)
    cmp = lambda b, tol=None: gs.compare(tmp_path / "a.json", tmp_path / b, tol)  # noqa: E731
    assert all(cmp("b.json", 1e-3).values()) and not cmp("b.json")["c fwd+bwd/g"]
    assert cmp("c.json", 1e-3)["c fwd+bwd/g"] is False
    assert cmp("d.json", 1e-3)["c fwd+bwd/loss"] is False
    assert cmp("e.json", 1e-3)["c fwd/frame"] is False


_K1, _K3 = _KERNEL_NAMES["K1"], _KERNEL_NAMES["K3 any-hit"]
_TORCH = "void at::native::vectorized_elementwise_kernel<4>(int)"


@pytest.mark.parametrize("windows, want, used", [
    # every record in the first window
    ([{_K1: 16, _K3: 4, _TORCH: 9}], {"K1": 16, "K3 any-hit": 4}, 1),
    # records lost in each window, each instance whole in one of them
    ([{_K1: 12, _K3: 4}, {_K1: 15, _K3: 3}, {_K1: 16, _K3: 1}],
     {"K1": 16, "K3 any-hit": 4}, 3),
    # a node that does not run is short in every window
    ([{_K1: 16, _K3: 2}] * 8, {"K1": 16, "K3 any-hit": 2}, 8),
    # a window over the graph's count is returned as it is
    ([{_K1: 12, _K3: 4}, {_K1: 17, _K3: 4}, {_K1: 16, _K3: 4}],
     {"K1": 17, "K3 any-hit": 4}, 2),
    ([{_K1: 16, _K3: 4, _KERNEL_NAMES["K5"]: 1}],
     {"K1": 16, "K3 any-hit": 4, "K5": 1}, 1),
])
def test_graph_steps_profiled_replays_takes_each_kernels_most_over_windows(
        monkeypatch, windows, want, used):
    """tools/graph_steps.py's ``profiled_replays`` (the device's kernels
    over a graph's bare replays, by torch.profiler, which loses records)
    takes windows of ``n`` replays until each of the port's instances has
    shown its full count in one, at most ``tries``, and returns each
    instance's most; a window over the graph's count ends it as it is."""
    from pbr_tpu_torch.tools import graph_steps as gs

    class _Step:
        kernels = {_K1: 8, _K3: 2, _TORCH: 5}
        replays = 0

        def __call__(self):
            self.replays += 1

    seen = iter(windows)

    def profiled(fn):
        fn()
        return 0.0, next(seen), {}

    monkeypatch.setattr(gs, "profiled", profiled)
    step = _Step()
    assert gs.profiled_replays(step, 2) == want
    assert step.replays == 2 * used


def test_graph_steps_phong_case_steps_like_the_eager_step():
    """tools/graph_steps.py's ``phong`` case: the Cornell box with its
    curved sphere under bench.py's settings at alpha ``PHONG_ALPHA``; its
    one-frame forward step (``FrameStep``, eager on the CPU) is
    ``bench.step``'s, bitwise."""
    from pbr_tpu_torch.tools import graph_steps as gs

    b = gs.bench_case("phong", 16, "cpu")
    assert b.settings.phong_tessellation == gs.PHONG_ALPHA
    assert b.scene.phong_records is not None
    got = bench.FrameStep(b, fwd_only=True)(1, 1)
    ref = bench.step(b.scene, b.cam, b.settings, b.pixel_ids, 1, frames=1, fwd_only=True)
    assert torch.isfinite(ref) and float(ref) > 0.0
    assert torch.equal(got, ref)
