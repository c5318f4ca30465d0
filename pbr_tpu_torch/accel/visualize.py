"""Debug visualizations: BVH leaf wireframes and light-position boxes.

The reference drew these as GL line overlays toggled from the View menu
(BVH::visualize, BVH.cpp:995-1055, drawn in GLWidget.cpp:588-605;
light boxes in GLWidget::visualizeLightPositions, GLWidget.cpp:913-989).
Headless counterpart: rasterize the same line sets over a rendered frame
with a small NumPy DDA — debug tooling, not a hot path. The port's copy of
``pbr_tpu/accel/visualize.py`` (byte-equal overlays,
tests/test_torch_app.py); it takes the port's NumPy ``Scene`` and
``CameraState``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from pbr_tpu_torch.scene.camera import pixel_dim
from pbr_tpu_torch.scene.types import CameraState, LightsSoA, LinearBVH

_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),  # bottom ring
    (4, 5), (5, 7), (7, 6), (6, 4),  # top ring
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
]


def _box_corners(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    xs = (mn[0], mx[0])
    ys = (mn[1], mx[1])
    zs = (mn[2], mx[2])
    return np.array(
        [(xs[i & 1], ys[(i >> 1) & 1], zs[(i >> 2) & 1]) for i in range(8)],
        dtype=np.float32,
    )


def _project(points: np.ndarray, cam: CameraState, width: int, height: int):
    """World → pixel coordinates using the render camera model (inverse of
    initRay, pathtracing.cl:25-48). Returns (px, py, in_front)."""
    eye = np.array([float(cam.eye.x), float(cam.eye.y), float(cam.eye.z)])
    w = np.array([float(cam.w.x), float(cam.w.y), float(cam.w.z)])
    u = np.array([float(cam.u.x), float(cam.u.y), float(cam.u.z)])
    v = np.array([float(cam.v.x), float(cam.v.y), float(cam.v.z)])
    pxdim = pixel_dim(width, height, 45.0)
    rel = points - eye
    zw = rel @ w
    in_front = zw > 1e-6
    zw = np.where(in_front, zw, 1.0)
    xu = (rel @ u) / zw
    yv = (rel @ v) / zw
    # initRay: dir ∝ w + pxdim/2 * (u(1 - W + 2x) + v(1 - H + 2y))
    px = (xu / pxdim * 2.0 + width - 1.0) * 0.5
    py = (yv / pxdim * 2.0 + height - 1.0) * 0.5
    return px, py, in_front


def _draw_line(img: np.ndarray, x0, y0, x1, y1, color) -> None:
    h, wpx = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * ts).astype(int)
    ys = np.round(y0 + (y1 - y0) * ts).astype(int)
    ok = (xs >= 0) & (xs < wpx) & (ys >= 0) & (ys < h)
    img[h - 1 - ys[ok], xs[ok]] = color


def draw_boxes(
    img: np.ndarray,
    boxes: Iterable[Tuple[np.ndarray, np.ndarray]],
    cam: CameraState,
    color=(1.0, 0.1, 0.9),
) -> np.ndarray:
    """Rasterize AABB wireframes over an (H, W, 3) float image (top-down
    rows, as produced by PathTracer.image())."""
    img = np.array(img, dtype=np.float32, copy=True)
    h, w = img.shape[:2]
    color = np.asarray(color, dtype=np.float32)
    for mn, mx in boxes:
        corners = _box_corners(np.asarray(mn), np.asarray(mx))
        px, py, ok = _project(corners, cam, w, h)
        for a, b in _EDGES:
            if ok[a] and ok[b]:
                _draw_line(img, px[a], py[a], px[b], py[b], color)
    return img


def leaf_boxes(bvh: LinearBVH):
    """Leaf AABBs (the reference visualized leaves only, BVH.cpp:1010)."""
    leaf = np.asarray(bvh.leaf_first) >= 0
    mn = bvh.bb_min.stack(np)[leaf]
    mx = bvh.bb_max.stack(np)[leaf]
    return list(zip(mn, mx))


def light_boxes(lights: LightsSoA, half: float = 0.05):
    """Small boxes marking light positions (GLWidget.cpp:913-989)."""
    pos = lights.pos.stack(np)
    return [(p - half, p + half) for p in pos]


def overlay_bvh(img, scene, cam, color=(1.0, 0.1, 0.9)):
    if scene.bvh is None:
        raise ValueError("scene has no BVH to visualize")
    return draw_boxes(img, leaf_boxes(scene.bvh), cam, color)


def overlay_lights(img, scene, cam, color=(1.0, 1.0, 0.2)):
    return draw_boxes(img, light_boxes(scene.lights), cam, color)
