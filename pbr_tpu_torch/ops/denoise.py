"""Feature-guided noise filter (the completed ``noise_filtering.cl``).

The counterpart of ``pbr_tpu/ops/denoise.py``, in torch ops on the
scene's device:

- **Features** come from one extra primary-hit pass
  (``first_hit_features``): first-hit shading normal, hit distance and
  diffuse albedo per pixel, from center-of-pixel pinhole rays. The search
  is the port's ``intersect_scene``, so on the card it launches the
  scene's kernel (K1 on the Cornell box, K3 on multiroom).
- **Filter** (``noise_filter``): an edge-avoiding à-trous wavelet
  transform (Dammertz et al. 2010), a 5x5 B3-spline stencil at
  power-of-two dilations with per-tap cross-bilateral weights from the
  feature buffers. Each tap is a dense shifted multiply-add over the whole
  (H, W) image; the pass is differentiable end to end.

Images are (H, W, ...) tensors with pixel row 0 first, as
``first_hit_features`` returns them (the camera's bottom row: flip rows to
match ``PathTracer.image()``, which puts the top row first).
"""

from __future__ import annotations

import numpy as np
import torch

from pbr_tpu_torch.ops.intersect import gather_vec3, geometric_normal
from pbr_tpu_torch.ops.traverse import intersect_scene
from pbr_tpu_torch.ops.vec import Vec3, f32
from pbr_tpu_torch.scene.camera import pixel_dim

# 5-tap B3-spline, the à-trous generating kernel (outer product -> 5x5).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def first_hit_features(scene, cam, settings, max_leaf=None):
    """One deterministic primary-hit pass -> ``(normal, depth, albedo)``.

    ``scene``: a ``SceneParams``; ``cam``: a ``CameraState`` of 0-d
    tensors on its device. Center-of-pixel pinhole rays (no AA jitter, no
    DoF: feature buffers must be noise-free). Returns (H, W, 3) normal,
    (H, W) depth and (H, W, 3) albedo tensors. Misses get normal 0, depth =
    the largest finite depth (at least 1) and albedo = the sky colour, so
    the sky filters as one flat region."""
    w, h = settings.width, settings.height
    ids = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    px = (ids % w).to(torch.float32)
    py = (ids // w).to(torch.float32)
    pxdim = np.float32(pixel_dim(w, h, settings.fov))

    ones = torch.ones_like(px)
    b3 = lambda v: Vec3(v.x * ones, v.y * ones, v.z * ones)  # noqa: E731
    eye, cw, cu, cv = b3(cam.eye), b3(cam.w), b3(cam.u), b3(cam.v)
    fx = f32(1.0 - w) + 2.0 * px
    fy = f32(1.0 - h) + 2.0 * py
    d = (cw + (cu * fx + cv * fy) * f32(pxdim * np.float32(0.5))).normalized()

    tris = scene.tris
    t, face = intersect_scene(eye, d, tris, mode=settings.intersector,
                              clusters=scene.clusters, bvh=scene.bvh, forest=scene.forest,
                              max_leaf=max_leaf)
    hit = torch.isfinite(t)
    face_safe = face.clamp_min(0)
    n = geometric_normal(gather_vec3(tris.e1, face_safe), gather_vec3(tris.e2, face_safe))
    # Orient toward the viewer, like the shading pass (pathtracing.cl:298).
    flip = n.dot(-d) <= 0.0
    n = Vec3(*(torch.where(flip, -c, c) for c in n))
    kd = gather_vec3(scene.materials.kd, tris.mtl[face_safe])
    sky = settings.sky_light

    zero = torch.zeros_like(px)
    normal = torch.stack([torch.where(hit, c, zero) for c in n], dim=-1)
    t_hit = torch.where(hit, t, 0.0)
    t_max = torch.clamp_min(t_hit.max(), 1.0)
    depth = torch.where(hit, t, t_max)
    albedo = torch.stack([torch.where(hit, c, f32(s)) for c, s in zip(kd, sky)], dim=-1)
    return normal.reshape(h, w, 3), depth.reshape(h, w), albedo.reshape(h, w, 3)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped 2D shift of an (H, W, ...) image by a static offset:
    ``out[i, j] = img[clamp(i + dy), clamp(j + dx)]``, the edge rows and
    columns repeated (the JAX version's slice plus ``pad(mode='edge')``)."""
    h, w = img.shape[0], img.shape[1]
    rows = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img.index_select(0, rows).index_select(1, cols)


def noise_filter(color, normal, depth, albedo=None, *, iterations: int = 3,
                 sigma_color: float = 0.35, sigma_normal: float = 64.0,
                 sigma_depth: float = 0.02):
    """Edge-avoiding à-trous filter over an (H, W, 3) radiance image.

    ``normal`` (H, W, 3) and ``depth`` (H, W) come from
    ``first_hit_features``. With ``albedo`` the filter runs on demodulated
    irradiance (color / albedo) and re-modulates at the end, so albedo
    detail is untouched while lighting noise is smoothed.

    Weights per tap q at center p:
      w = B3(q) * exp(-|c_p - c_q|^2 / sc) * max(0, n_p . n_q)^sn
                * exp(-|z_p - z_q| / (sz * z_range))
    with sc relative to the image's own RMS variation."""
    if albedo is not None:
        safe_alb = torch.clamp_min(albedo, 1e-3)
        img = color / safe_alb
    else:
        img = color
    n, z = normal, depth
    z_range = torch.clamp_min(z.max() - z.min(), 1e-6)
    mean_c = img.mean(dim=(0, 1), keepdim=True)
    rms = torch.sqrt(torch.clamp_min(((img - mean_c) ** 2).sum(dim=-1).mean(), 1e-12))
    sc = f32(sigma_color) * rms
    inv_sc = 1.0 / torch.clamp_min(2.0 * sc * sc, 1e-12)
    inv_sz = 1.0 / (f32(sigma_depth) * z_range)

    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(img)
        wsum = torch.zeros_like(z)
        for j in range(-2, 3):
            for i in range(-2, 3):
                k = f32(_B3[j + 2] * _B3[i + 2])
                cq = _shift2d(img, j * step, i * step)
                nq = _shift2d(n, j * step, i * step)
                zq = _shift2d(z, j * step, i * step)
                w_c = torch.exp(-((img - cq) ** 2).sum(dim=-1) * inv_sc)
                w_n = torch.clamp_min((n * nq).sum(dim=-1), 0.0) ** f32(sigma_normal)
                w_z = torch.exp(-(z - zq).abs() * inv_sz)
                wt = k * w_c * w_n * w_z
                acc = acc + cq * wt[..., None]
                wsum = wsum + wt
        img = acc / torch.clamp_min(wsum, 1e-8)[..., None]

    if albedo is not None:
        img = img * safe_alb
    return img


def denoise_render(color_img, scene, cam, settings, max_leaf=None, **kwargs):
    """Features from the scene, then the filter, in one call.
    ``color_img``: (H, W, 3) linear radiance in pixel-row order (row 0
    first), on the scene's device."""
    normal, depth, albedo = first_hit_features(scene, cam, settings, max_leaf=max_leaf)
    return noise_filter(color_img, normal, depth, albedo, **kwargs)
