"""The port's terminal viewer (pbr_tpu_torch/viewer.py): tests/test_viewer.py
on the CPU (scripted-key loop, camera and light moves restarting the
accumulation, focus picking, overlays, the startup breakdown, the CLI), and
against the JAX package's viewer: the blit helpers byte-equal, and a
scripted run's image within the repo's frame gate (at least 99% of pixels
within 1e-3). The JAX viewer's draft-then-refine startup is not ported, so
its test has no counterpart here."""

import io
import json

import numpy as np
import pytest
import torch

from pbr_tpu import viewer as jax_viewer
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.procedural import cornell_box as jax_cornell
from pbr_tpu.utils.config import CameraConfig as JaxCameraConfig
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu_torch import app
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.procedural import cornell_box
from pbr_tpu_torch.utils.config import CameraConfig, RenderSettings
from pbr_tpu_torch.viewer import Viewer, ansi_halfblocks, downsample, tonemap_u8

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

_SETTINGS = dict(width=32, height=32, samples=1, max_depth=2, max_added_depth=0,
                 shadow_rays=1, anti_aliasing=0.0)
_CAM = dict(eye=(0.0, 1.0, 3.2), center=(0.0, 0.0, 1.0))


def _make_viewer(use_bvh=False, **kw):
    scene, _ = scene_from_text(*cornell_box(), use_bvh=use_bvh)
    return Viewer(scene, RenderSettings(**_SETTINGS), CameraConfig(**_CAM), out=io.StringIO(),
                  device="cpu", **kw)


def test_scripted_loop_renders_and_accumulates():
    v = _make_viewer()
    v.run(max_frames=3, keys="", draw=True)
    assert v.frame == 3
    assert v.tracer.sample_count == 3
    out = v.out.getvalue()
    assert "▀" in out and "spp" in out


def test_info_toggle_shows_stage_times():
    """'i' shows the live per-stage ms readout (the InfoWindow analog)."""
    v = _make_viewer()
    v.run(max_frames=4, keys="i", draw=True)
    out = v.out.getvalue()
    assert "stages:" in out
    assert "trace" in out and "blit" in out
    assert v.stage_ms["trace"] > 0


def test_camera_move_restarts_accumulation():
    v = _make_viewer()
    v.run(max_frames=2, keys="", draw=False)
    assert v.tracer.sample_count == 2
    eye0 = list(v.camera.eye)
    v.run(max_frames=4, keys="w", draw=False)
    # 'w' moved the camera forward and reset the accumulator
    assert v.camera.eye != eye0
    assert v._resets >= 1
    assert v.tracer.sample_count < 4


def test_rotation_and_speed_keys():
    v = _make_viewer()
    v.handle_key("f")
    assert abs(v.camera.speed - (CameraConfig().speed + 0.1)) < 1e-9
    rx0 = v.camera.rot_x
    v.handle_key("LEFT")
    assert v.camera.rot_x != rx0
    v.handle_key("r")
    assert v.camera.rot_x == 0.0


def test_light_move_mode_moves_orb():
    v = _make_viewer()
    x0 = float(v.tracer.scene.lights.pos.x[0])
    v.handle_key("l")
    assert v.move_light
    v.handle_key("d")
    x1 = float(v.tracer.scene.lights.pos.x[0])
    assert abs(x1 - x0 - 0.25) < 1e-6
    assert v._resets >= 1
    # toggling back returns WASD to the camera
    v.handle_key("l")
    assert not v.move_light


def test_quit_key_stops_loop():
    v = _make_viewer()
    v.run(max_frames=100, keys="  x", draw=False)
    assert v.quit and v.frame <= 3


def test_focus_keys():
    v = _make_viewer()
    v.run(max_frames=1, keys="", draw=False)
    v.handle_key("p")
    assert v.focus > 0.0  # center pixel hits the back wall
    v.handle_key("o")
    assert v.focus == -1.0


def test_arbitrary_pixel_focus():
    """Pick mode moves the crosshair with arrows; 'p' focuses at the
    crosshair; the API accepts explicit coordinates and clamps them."""
    v = _make_viewer()
    v.run(max_frames=1, keys="", draw=False)
    v.handle_key("P")
    assert v.pick_mode
    x0, y0 = v.focus_px, v.focus_py
    v.handle_key("LEFT")
    v.handle_key("UP")
    assert (v.focus_px, v.focus_py) != (x0, y0)
    v.handle_key("p")
    f_moved = v.focus
    assert f_moved > 0.0
    v.render_one()  # the pick reads the previous frame's depth
    depth = v.tracer.depth_image()
    finite = np.argwhere(np.isfinite(depth) & (np.abs(depth - f_moved) > 1e-3))
    py, px = finite[0]
    v.set_focus_pixel(int(px), int(py))
    assert v.focus > 0.0 and v.focus != f_moved
    v.set_focus_pixel(-5, 999)
    assert (v.focus_px, v.focus_py) == (0, 31)


@pytest.mark.parametrize("seed", [0, 1])
def test_blit_helpers_equal_jax(seed):
    img = np.random.RandomState(seed).rand(16, 16, 3).astype(np.float32) * 2.0
    u8 = tonemap_u8(img, exposure=2.0)
    np.testing.assert_array_equal(u8, jax_viewer.tonemap_u8(img, exposure=2.0))
    assert u8.dtype == np.uint8
    for shape in ((4, 8), (32, 20)):  # area-average, and the upscaling fallback
        small = downsample(u8.astype(np.float32), *shape)
        np.testing.assert_array_equal(small, jax_viewer.downsample(u8.astype(np.float32), *shape))
        assert small.shape == (*shape, 3)
    small = downsample(u8.astype(np.float32), 4, 8).astype(np.uint8)
    txt = ansi_halfblocks(small)
    assert txt == jax_viewer.ansi_halfblocks(small)
    assert txt.count("▀") == 2 * 8 and "38;2;" in txt
    with pytest.raises(ValueError, match="empty"):
        downsample(img, 0, 4)


def test_scripted_run_matches_jax_viewer():
    """The same scripted keys through both viewers: the same camera, the
    same frame count and accumulation, and the image within the frame gate."""
    keys = "wd"
    v = _make_viewer()
    v.run(max_frames=4, keys=keys, draw=False)
    jscene, _ = jax_scene_from_text(*jax_cornell(), use_bvh=False)
    jv = jax_viewer.Viewer(jscene, JaxSettings(**_SETTINGS), JaxCameraConfig(**_CAM),
                           out=io.StringIO())
    jv.run(max_frames=4, keys=keys, draw=False)
    assert v.camera.eye == jv.camera.eye
    assert (v.frame, v.tracer.sample_count, v._resets) == (
        jv.frame, jv.tracer.sample_count, jv._resets)
    within = (np.abs(v.tracer.image() - jv.tracer.image()).max(axis=-1) <= 1e-3).mean()
    assert within >= 0.99, within


def test_overlay_toggle_keys_and_startup_breakdown(tmp_path):
    """'b'/'n' toggle the BVH/lights overlays on the displayed frame; the
    lights overlay follows a light moved with 'l'; the startup breakdown
    records the first-frame stages."""
    v = _make_viewer(use_bvh=True)
    v.run(max_frames=1, keys="", draw=True)
    base = v.tonemapped().copy()
    v.handle_key("b")
    assert v.show_bvh
    assert (v.tonemapped() != base).any()
    v.handle_key("b")
    v.handle_key("n")
    lights = v.tonemapped()
    assert (lights != base).any()
    v.handle_key("l")
    v.handle_key("a")
    v.render_one()
    from pbr_tpu_torch.accel.visualize import overlay_lights

    at_start = overlay_lights(v.tracer.image(), v.scene, v.camera.state(focus=v.focus))
    assert (v.tonemapped() != tonemap_u8(at_start, v.exposure)).any()
    p = tmp_path / "startup.json"
    v.write_startup_breakdown(str(p))
    d = json.loads(p.read_text())
    assert d["first_frame_s"] > 0 and d["init_s"] >= 0 and d["first_draw_s"] >= 0


def test_cli_view_smoke(tmp_path):
    """tests/test_viewer.py::test_cli_view_smoke on --device cpu, with the
    key script of the card's run: 'wasd' move the camera (4 restarts), 'l'
    toggles light mode."""
    js = str(tmp_path / "s.json")
    v = app.main(["view", "--scene", "cornell", "--size", "16", "--frames", "6",
                  "--keys", "wasdl", "--no-draw", "--device", "cpu", "--startup-json", js])
    assert (v.frame, v._resets, v.tracer.sample_count, v.move_light) == (6, 4, 3, True)
    assert json.loads(open(js).read())["first_frame_s"] > 0


def test_cli_eye_center_flags(tmp_path):
    """--eye/--center replace the Cornell camera."""
    out = str(tmp_path / "e.png")
    res = app.main(["render", "--scene", "cornell", "--frames", "1", "--size", "16", "--out",
                    out, "--eye", "0.5,1.2,2.5", "--center", "0,0,1", "--device", "cpu"])
    assert res["image"].shape == (16, 16, 3)
    with pytest.raises(SystemExit, match="3 comma-separated"):
        app.main(["render", "--eye", "1,2", "--device", "cpu"])
