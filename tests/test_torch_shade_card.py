"""Kernels K11 and K12 (``pbr_tpu_torch/ops/cuda_shade.py``) on the card;
skipped without one (the kernels have no CPU mode). A file without JAX:
the CPU tests against the JAX package are tests/test_torch_shade.py.

- A frame through the kernels (no autograd) is bitwise the same frame
  through the plain versions (autograd records the scene's parameters and
  the camera),
  and only the first launches K11 and K12.
- The wrappers refuse a CUDA input of the wrong dtype, shape or device
  before any launch.

Run on the card: ``python -m pytest tests/test_torch_shade_card.py -m cuda``.
"""

import pytest
import torch

from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import counts, cuda_shade, zero_counts
from pbr_tpu_torch.ops.cuda_shade import Hit, Lanes, ShadeConfig, ShadeScene
from pbr_tpu_torch.ops.rng import PixelRng
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.parallel.mesh import leaf_camera
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import cornell_box
from pbr_tpu_torch.utils.config import RenderSettings

SETTINGS = RenderSettings(width=64, height=64, samples=1, max_depth=3, max_added_depth=5,
                          shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
                          no_transparency=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K11 and K12 have no CPU mode")
    return torch.device("cuda")


def _cornell(dev):
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    return to_torch(scene, dev), camera_to_torch(cam, dev)


@pytest.mark.cuda
def test_frame_through_the_kernels_is_the_grad_paths_frame():
    dev = _card()
    ts, ct = _cornell(dev)
    ids = torch.arange(64 * 64, dtype=torch.int32, device=dev)
    zero_counts()
    with torch.no_grad():
        got = trace_rays(ts, ct, SETTINGS, ids, 3)
    torch.cuda.synchronize()
    launched = counts()
    assert launched["K11"] == 1 and launched["K12"] == SETTINGS.max_total_depth
    ts.requires_grad_()
    zero_counts()
    ref = trace_rays(ts, leaf_camera(ct), SETTINGS, ids, 3)
    torch.cuda.synchronize()
    assert all(counts()[k] == 0 for k in ("K11", "K12", "K12 pre", "K12 post"))
    for a, b in zip((*got.color, got.focus_t), (*ref.color, ref.focus_t)):
        assert torch.equal(a.view(torch.int32), b.detach().view(torch.int32))


def _inputs(dev, n: int = 256):
    ts, _ = _cornell(dev)
    z = lambda dt=torch.float32: torch.zeros(n, dtype=dt, device=dev)  # noqa: E731
    v = lambda: Vec3(z(), z(), z())  # noqa: E731
    lanes = Lanes(v(), v(), Vec3(z() + 1, z() + 1, z() + 1), z(torch.bool) | True,
                  z(torch.bool), v(), z(torch.int32), v(), z(torch.int32) + 1)
    hit = Hit(torch.full((n,), float("inf"), device=dev), z(torch.int32) - 1,
              occluded=z(torch.bool))
    rng = PixelRng(0, torch.arange(n, dtype=torch.int32, device=dev))
    scene = ShadeScene(ts.tris, ts.materials, ts.lights)
    return ShadeConfig.of(SETTINGS, ts.lights.count), lanes, hit, rng, scene


@pytest.mark.cuda
@pytest.mark.parametrize("broken", ["t dtype", "alive shape", "material device", "px dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(broken):
    dev = _card()
    cfg, lanes, hit, rng, scene = _inputs(dev)
    with torch.no_grad():
        out, _ = cuda_shade.shade(cfg, lanes, hit, rng, 0, 0, scene)  # the valid call runs
        torch.cuda.synchronize()
        assert not bool(out.alive.any()) and bool(out.light_found.all())  # every lane missed
        zero_counts()
        with pytest.raises(ValueError):
            if broken == "t dtype":
                cuda_shade.shade(cfg, lanes, hit._replace(t=hit.t.double()), rng, 0, 0, scene)
            elif broken == "alive shape":
                cuda_shade.shade(cfg, lanes._replace(alive=lanes.alive[1:]), hit, rng, 0, 0,
                                 scene)
            elif broken == "material device":
                mats = scene.materials._replace(d=scene.materials.d.cpu())
                cuda_shade.shade(cfg, lanes, hit, rng, 0, 0, scene._replace(materials=mats))
            else:
                _, ct = _cornell(dev)
                px = torch.zeros(256, dtype=torch.float64, device=dev)
                cuda_shade.gen_rays(ct, SETTINGS, px, px.float(), rng, 0, px.float())
        assert all(v == 0 for v in counts().values())
