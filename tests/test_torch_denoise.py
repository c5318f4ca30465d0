"""The port's denoiser (pbr_tpu_torch/ops/denoise.py) against the JAX
package's (``pbr_tpu.ops.denoise`` under NumPy) on the same inputs.

Tolerances: the filter within rtol 2e-4, atol 2e-5 of NumPy's (the JAX
package's own numpy-against-jax gate, tests/test_denoise.py); the feature
pass within 1e-5 (one Moller-Trumbore re-evaluation and a normalisation,
whose sqrt is 1 ULP off NumPy's on torch's CPU); the edge shift bitwise.
"""

import numpy as np
import pytest
import torch

from pbr_tpu.ops import denoise as jd
from pbr_tpu.scene.build import scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.scene.procedural import cornell_box
from pbr_tpu.utils.config import RenderSettings
from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import denoise as td

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)


def _synthetic():
    """tests/test_denoise.py's input: two flat regions split by a normal
    and depth edge, plus noise."""
    rs = np.random.RandomState(7)
    h = w = 64
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, : w // 2] = (0.8, 0.2, 0.2)
    clean[:, w // 2:] = (0.1, 0.1, 0.9)
    noisy = clean + rs.normal(0.0, 0.15, clean.shape).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 2] = 1.0
    normal[:, w // 2:, 0] = 1.0
    depth = np.ones((h, w), np.float32)
    depth[:, w // 2:] = 3.0
    albedo = np.clip(clean + 0.05, 0.0, 1.0)
    return clean, noisy, normal, depth, albedo


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 3)])
@pytest.mark.parametrize("dy, dx", [(0, 0), (2, -3), (-4, 4), (6, 0), (0, -8)])
def test_shift2d_is_edge_clamped_like_numpy(shape, dy, dx):
    img = np.random.RandomState(1).rand(*shape).astype(np.float32)
    ref = jd._shift2d(np, img, dy, dx)
    got = td._shift2d(torch.tensor(img), dy, dx).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("with_albedo", [False, True])
@pytest.mark.parametrize("iterations", [2, 3])
def test_noise_filter_matches_numpy(with_albedo, iterations):
    _, noisy, normal, depth, albedo = _synthetic()
    alb = albedo if with_albedo else None
    ref = jd.noise_filter(np, noisy, normal, depth, alb, iterations=iterations)
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    got = td.noise_filter(t(noisy), t(normal), t(depth), t(alb), iterations=iterations)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


def test_filter_reduces_noise_and_keeps_edges():
    """tests/test_denoise.py's criteria on the port: MSE below a quarter,
    and at least 80% of the cross-edge contrast kept."""
    clean, noisy, normal, depth, _ = _synthetic()
    out = td.noise_filter(torch.tensor(noisy), torch.tensor(normal), torch.tensor(depth),
                          iterations=3).numpy()
    assert np.mean((out - clean) ** 2) < 0.25 * np.mean((noisy - clean) ** 2)
    mid = clean.shape[1] // 2
    contrast = np.abs(out[:, mid - 2].mean(axis=0) - out[:, mid + 1].mean(axis=0)).sum()
    contrast_clean = np.abs(clean[:, mid - 2].mean(axis=0) - clean[:, mid + 1].mean(axis=0)).sum()
    assert contrast > 0.8 * contrast_clean


@pytest.fixture(scope="module")
def cornell_small():
    """tests/test_denoise.py's scene: Cornell at 48²."""
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(width=48, height=48, samples=1, max_depth=3, max_added_depth=1,
                              shadow_rays=1, sky_light=(0.9, 0.9, 1.0))
    return scene, cam, settings


def test_first_hit_features_match_numpy(cornell_small):
    scene, cam, settings = cornell_small
    with np.errstate(all="ignore"):
        ref = jd.first_hit_features(np, scene, cam, settings)
    got = td.first_hit_features(to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"), settings)
    for g, r, shape in zip(got, ref, [(48, 48, 3), (48, 48), (48, 48, 3)]):
        assert tuple(g.shape) == shape == r.shape
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)
    lens = np.linalg.norm(got[0].numpy()[20:28, 20:28], axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)


def test_denoise_real_render_improves_mse(cornell_small):
    """tests/test_denoise.py's gate on the port's own frames: one noisy
    frame, denoised, is below 0.6x the MSE of the raw frame against a
    24-frame average."""
    scene, cam, settings = cornell_small
    ts, ct = to_torch(scene, "cpu"), camera_to_torch(cam, "cpu")
    w, h = settings.width, settings.height
    ids = torch.arange(w * h, dtype=torch.int32)

    def frame_avg(n):
        acc = sum(trace_rays(ts, ct, settings, ids, s).color.stack() for s in range(n))
        return (acc / n).reshape(h, w, 3)

    noisy, ref = frame_avg(1), frame_avg(24)
    den = td.denoise_render(noisy, ts, ct, settings)
    mse_noisy = float(((noisy - ref) ** 2).mean())
    mse_den = float(((den - ref) ** 2).mean())
    assert mse_den < 0.6 * mse_noisy, (mse_noisy, mse_den)
