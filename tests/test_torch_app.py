"""The port's app layer (pbr_tpu_torch/app.py and the helpers it runs:
utils/image.py, utils/checkpoint.py, utils/profiling.py,
accel/visualize.py, tools/colormatrix.py) against the JAX package.

- image, colour matrices and overlays: byte-equal to the JAX package's;
- checkpoints: the JAX package's npz leaf names and order, both ways; a
  JAX ``FrameState`` restored by the port renders the next frame as the
  JAX package does (the repo's frame gate: at least 99% of pixels within
  1e-3);
- fit: loss and gradient in ``materials.kd`` against ``jax.value_and_grad``
  of the JAX CLI's loss, with tests/test_torch_grad.py's tolerance (rtol
  1e-4 plus 1e-5 of the largest magnitude); the line search never accepts
  a rise;
- the CLI smoke tests of tests/test_utils.py on ``--device cpu``, and the
  refusal to run without a card unless ``--device cpu`` says so.
"""

import argparse
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu import app as jax_app
from pbr_tpu.accel import visualize as jax_vis
from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.models.pathtracer import PathTracer as JaxPathTracer
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.camera import make_camera_state as jax_camera
from pbr_tpu.scene.procedural import cornell_box as jax_cornell
from pbr_tpu.tools import colormatrix as jax_cm
from pbr_tpu.utils import checkpoint as jax_ckpt
from pbr_tpu.utils import image as jax_image
from pbr_tpu.utils.config import CameraConfig as JaxCameraConfig
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu_torch import PathTracer, app
from pbr_tpu_torch.accel import visualize as vis
from pbr_tpu_torch.models.pathtracer import init_frame_state
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import cornell_box
from pbr_tpu_torch.tools import colormatrix as cm
from pbr_tpu_torch.utils import checkpoint as ckpt
from pbr_tpu_torch.utils import image
from pbr_tpu_torch.utils.config import CameraConfig, RenderSettings
from pbr_tpu_torch.utils.profiling import StageTimer, trace_to_file

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)


def _img(seed=0, shape=(12, 20, 3), scale=1.5):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- images --

@pytest.mark.parametrize("writer, kw", [
    ("save_render", {}), ("save_render", {"gamma": 1.0, "exposure": 0.4}),
    ("write_png", {}), ("write_ppm", {}),
])
def test_image_files_are_byte_equal(tmp_path, writer, kw):
    hdr = _img()
    u8 = jax_image.tonemap(hdr)
    np.testing.assert_array_equal(image.tonemap(hdr), u8)
    arg = hdr if writer == "save_render" else u8
    paths = [str(tmp_path / f"{who}.{'ppm' if writer == 'write_ppm' else 'png'}")
             for who in ("port", "jax")]
    getattr(image, writer)(paths[0], arg, **kw)
    getattr(jax_image, writer)(paths[1], arg, **kw)
    port_bytes, jax_bytes = (open(p, "rb").read() for p in paths)
    assert port_bytes == jax_bytes
    if writer != "write_ppm":
        np.testing.assert_array_equal(image.read_png(paths[0]), jax_image.read_png(paths[1]))


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        image.read_png(str(p))


# ------------------------------------------------------ colour matrices --

@pytest.mark.parametrize("system", sorted(jax_cm.COLOR_SYSTEMS))
def test_colormatrix_equals_jax(system, capsys):
    np.testing.assert_array_equal(cm.rgb_to_xyz_matrix(system), jax_cm.rgb_to_xyz_matrix(system))
    np.testing.assert_array_equal(cm.xyz_to_rgb_matrix(system), jax_cm.xyz_to_rgb_matrix(system))
    assert cm.legacy_scale(system) == jax_cm.legacy_scale(system)
    cm.main([system])
    port_out = capsys.readouterr().out
    jax_cm.main([system])
    assert port_out == capsys.readouterr().out


# -------------------------------------------------------------- overlays --

@pytest.mark.parametrize("what", ["bvh", "lights"])
def test_overlays_are_byte_equal(what):
    scene, _ = scene_from_text(*cornell_box(), use_bvh=True)
    jscene, _ = jax_scene_from_text(*jax_cornell(), use_bvh=True)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    jcam = jax_camera(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    base = np.clip(_img(3, (48, 64, 3)), 0.0, 1.0)
    got = getattr(vis, f"overlay_{what}")(base, scene, cam)
    ref = getattr(jax_vis, f"overlay_{what}")(base, jscene, jcam)
    assert (got != base).any()
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    if what == "bvh":
        with pytest.raises(ValueError, match="no BVH"):
            vis.overlay_bvh(base, scene._replace(bvh=None), cam)


# ----------------------------------------------------------- checkpoints --

def test_checkpoint_roundtrip_and_leaf_order(tmp_path):
    state = init_frame_state(64, "cpu")
    state = state._replace(sample_count=state.sample_count + 5,
                           depth=torch.arange(64, dtype=torch.float32))
    p = str(tmp_path / "ck")
    ckpt.save(p, state, meta={"frames": 5})
    restored, meta = ckpt.restore(p, init_frame_state(64, "cpu"))
    assert int(restored.sample_count) == 5 and restored.sample_count.dtype == torch.int32
    assert meta == {"backend": "npz", "frames": 5}
    assert torch.equal(restored.depth, state.depth)
    # The JAX package's pytree order, on a tree with a dict and a None.
    tree = {"b": (np.float32(1.0), None, [np.arange(2)]), "a": np.zeros(3)}
    ckpt.save(p, tree)
    with np.load(os.path.join(p, "state.npz")) as data:
        names = sorted(data.files, key=lambda s: int(s.split("_")[1]))
        leaves = [data[k] for k in names]
    ref = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(a, b)
    back, _ = ckpt.restore(p, tree)
    assert back["b"][1] is None and back["a"].shape == (3,)


def test_checkpoint_refuses_orbax_and_wrong_shapes(tmp_path):
    p = tmp_path / "ck"
    p.mkdir()
    (p / "meta.json").write_text(json.dumps({"backend": "orbax"}))
    with pytest.raises(ValueError, match="npz"):
        ckpt.restore(str(p), init_frame_state(4, "cpu"))
    ckpt.save(str(p), init_frame_state(4, "cpu"))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(p), init_frame_state(8, "cpu"))


def _ckpt_settings():
    return dict(width=16, height=16, samples=1, max_depth=3, max_added_depth=2,
                shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0))


def test_jax_frame_state_resumes_in_the_port(tmp_path, monkeypatch):
    """A FrameState the JAX package wrote as npz (orbax blocked) restores
    into the port's, and the next 16² frame equals the JAX package's next
    frame; the port's checkpoint restores into the JAX package too."""
    jscene, _ = jax_scene_from_text(*jax_cornell(), use_bvh=False)
    jcam = jax_camera(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    jpt = JaxPathTracer(jscene, JaxSettings(**_ckpt_settings()), lane_order="scanline")
    for i in range(2):
        jpt.render(jcam, frame_seed=i)
    p = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "orbax", None)
        m.setitem(sys.modules, "orbax.checkpoint", None)
        jax_ckpt.save(p, jpt.state, meta={"frames": 2})
    assert json.load(open(os.path.join(p, "meta.json")))["backend"] == "npz"

    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    pt = PathTracer(scene, RenderSettings(**_ckpt_settings()), device="cpu",
                    lane_order="scanline")
    pt.state, meta = ckpt.restore(p, pt.state)
    assert pt.sample_count == 2 and meta["frames"] == 2
    np.testing.assert_array_equal(pt.image(), jpt.image())
    pt.render(cam, frame_seed=2)
    jpt.render(jcam, frame_seed=2)
    assert pt.sample_count == 3
    within = (np.abs(pt.image() - jpt.image()).max(axis=-1) <= 1e-3).mean()
    assert within >= 0.99, within
    # And back: the port's checkpoint restores into the JAX package.
    ckpt.save(p, pt.state, meta={"frames": 3})
    state, meta = jax_ckpt.restore(p, jpt.state)
    assert int(np.asarray(state.sample_count)) == 3 and meta["frames"] == 3
    np.testing.assert_array_equal(np.asarray(state.rgb.x), pt.state.rgb.x.numpy())


# ------------------------------------------------------------- profiling --

def test_stage_timer_and_trace(tmp_path):
    t = StageTimer()
    with t.span("a"):
        pass
    with t.span("a", sync="cpu"):
        pass
    t.add("b", 0.5)
    rows = {name: (c, tot) for name, c, tot, _ in t.rows()}
    assert rows["a"][0] == 2 and abs(rows["b"][1] - 500.0) < 1e-6
    assert "stage" in t.table()
    with trace_to_file(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


# ------------------------------------------------------------------- fit --

def _fit_args(size):
    return argparse.Namespace(eye=None, center=None, size=size)


@functools.lru_cache(maxsize=None)
def _jax_fit(size):
    """The JAX CLI's fit problem (pbr_tpu/app.py::cmd_fit): its settings,
    scene and camera, and ``jax.value_and_grad`` of its loss."""
    settings = JaxSettings().replace(width=size, height=size, shadow_rays=1, brdf=0,
                                     max_depth=2, max_added_depth=0)
    scene, settings = jax_app._load_scene("cornell", settings)
    cam = jax_app._camera_for(_fit_args(size), JaxCameraConfig(), "cornell").state()
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


def test_fit_loss_and_grad_match_jax():
    """At 16², the port's fit loss and its gradient in kd against
    ``jax.value_and_grad`` of the JAX CLI's loss, at the CLI's starting
    point (RandomState(0) noise on the red albedos)."""
    vg, kd0 = _jax_fit(16)
    noise = np.random.RandomState(0).uniform(-0.3, 0.3, kd0.x.shape)
    kd_j = kd0._replace(x=jnp.clip(kd0.x + jnp.asarray(noise, jnp.float32), 0, 1))
    ref_loss, ref_g = vg(kd_j)
    ref_g = np.stack([np.asarray(ref_g.x), np.asarray(ref_g.y), np.asarray(ref_g.z)])

    settings = RenderSettings().replace(width=16, height=16, shadow_rays=1, brdf=0,
                                        max_depth=2, max_added_depth=0)
    scene, settings = app._load_scene("cornell", settings)
    cam = app._camera_for(_fit_args(16), CameraConfig(), "cornell").state()
    prob = app.fit_problem(scene, settings, cam, "cpu")
    param = prob.ts.mat_kd
    with torch.no_grad():
        param.copy_(torch.tensor(np.stack([np.asarray(kd_j.x), np.asarray(kd_j.y),
                                           np.asarray(kd_j.z)])))
    param.requires_grad_(True)
    loss = prob.loss()
    (g,) = torch.autograd.grad(loss, param)
    loss = float(loss.detach())
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert loss > 0.1
    scale = float(np.abs(ref_g).max())
    assert scale > 1e-3
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-4, atol=1e-5 * scale + 1e-7)


def test_fit_descends_and_never_accepts_a_rise():
    """A 32², 12-step fit: the loss falls, each step's loss is at most the
    last, and the final albedos are closer to the truth than the start."""
    res = app.main(["fit", "--scene", "cornell", "--size", "32", "--steps", "12",
                    "--device", "cpu"])
    losses = res["losses"] + [res["final_loss"]]
    assert all(b <= a for a, b in zip(losses, losses[1:])), losses
    assert res["final_loss"] < 0.5 * losses[0]
    assert any(res["accepted"])
    assert res["kd_err"] < 0.3  # the starting noise is up to 0.3


def test_fit_with_a_tiny_step_runs_and_keeps_the_albedos(tmp_path):
    """--lr 1e-7: the line search does not run while the step is at most
    1e-6, so no candidate exists; the fit keeps its albedos (the JAX CLI
    would read an unbound candidate) and still writes its image."""
    out = str(tmp_path / "fit.png")
    res = app.main(["fit", "--scene", "cornell", "--size", "8", "--steps", "3", "--lr", "1e-7",
                    "--device", "cpu", "--out", out])
    assert res["accepted"] == [False, False, False]
    assert res["losses"] == [res["final_loss"]] * 3
    assert image.read_png(out).shape == (8, 8, 3)


# ------------------------------------------------------------------- CLI --

def test_cli_render_smoke(tmp_path):
    """tests/test_utils.py::test_cli_render_smoke on --device cpu: render,
    checkpoint, resume."""
    out = str(tmp_path / "r.png")
    ck = str(tmp_path / "ck")
    res = app.main(["render", "--scene", "triangle", "--frames", "2", "--size", "32",
                    "--out", out, "--checkpoint", ck, "--stats", "--device", "cpu"])
    assert os.path.exists(out) and os.path.exists(os.path.join(ck, "meta.json"))
    assert res["tracer"].sample_count == 2
    res = app.main(["render", "--scene", "triangle", "--frames", "1", "--size", "32",
                    "--out", out, "--checkpoint", ck, "--device", "cpu"])
    assert res["tracer"].sample_count == 3
    assert json.load(open(os.path.join(ck, "meta.json")))["frames"] == 3


def test_cli_render_outputs(tmp_path):
    """--depth-out, --heatmap, --denoise and the overlays at 16² on the CPU:
    the files have the frame's size; the denoised image is the filter run in
    pixel-row order, its rows then flipped to the image's top-first order."""
    p = {k: str(tmp_path / f"{k}.png") for k in ("out", "depth", "heat", "den", "ovl")}
    res = app.main(["render", "--scene", "cornell", "--frames", "2", "--size", "16",
                    "--out", p["out"], "--depth-out", p["depth"], "--heatmap", p["heat"],
                    "--device", "cpu", "--lane-order", "scanline"])
    for k in ("out", "depth", "heat"):
        assert image.read_png(p[k]).shape == (16, 16, 3)
    heat = image.read_png(p["heat"])
    assert heat[..., 0].max() == 255 and heat[..., 1].max() == 255  # tests and bounces
    pt = res["tracer"]
    from pbr_tpu_torch.ops.denoise import first_hit_features, noise_filter
    from pbr_tpu_torch.scene.device import camera_to_torch

    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    img = pt.image()
    den = app._denoised(pt, camera_to_torch(cam, "cpu"), img, torch.device("cpu"))
    feats = first_hit_features(pt.scene, camera_to_torch(cam, "cpu"), pt.settings)
    ref = noise_filter(torch.tensor(np.ascontiguousarray(img[::-1])), *feats).numpy()[::-1]
    np.testing.assert_allclose(den, ref, rtol=1e-5, atol=1e-6)
    res = app.main(["render", "--scene", "cornell", "--frames", "1", "--size", "16",
                    "--out", p["den"], "--denoise", "--device", "cpu"])
    assert np.isfinite(res["image"]).all() and image.read_png(p["den"]).shape == (16, 16, 3)
    app.main(["render", "--scene", "cornell", "--frames", "1", "--size", "16", "--out", p["ovl"],
              "--lights-overlay", "--device", "cpu"])
    assert image.read_png(p["ovl"]).shape == (16, 16, 3)


def test_cli_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    """No card and no --device cpu: every command stops; nothing falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["render", "--out", str(tmp_path / "x.png")], ["fit"], ["view"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            app.main(argv + ["--size", "8"])
    assert not (tmp_path / "x.png").exists()
