"""Camera model: interactive FPS-style state + render-time basis.

Parity with the reference's ``source/Camera.{h,cpp}`` (eye/center/up/rot
state, WASD/QE moves scaled by config speed, mouse-drag rotation with ±90°
pitch clamp and spherical center/up recompute, Camera.cpp:20-241) and
``PathTracer::updateEyeBuffer`` (PathTracer.cpp:628-652: w/u/v basis) plus
``initKernelArgs``'s pixel-size computation (PathTracer.cpp:88-91).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np

from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import CameraState
from pbr_tpu_torch.utils.config import CameraConfig


def _norm3(v: Tuple[float, float, float]) -> Tuple[float, float, float]:
    n = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    if n == 0.0:
        return (0.0, 0.0, 0.0)
    return (v[0] / n, v[1] / n, v[2] / n)


def _cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def make_camera_state(
    eye: Tuple[float, float, float],
    center_dir: Tuple[float, float, float],
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
    focal_length: float = 0.035,
    aperture: float = 1.8,
    focus: float = -1.0,
    dtype=np.float32,
) -> CameraState:
    """Build the render-time camera basis.

    Matches updateEyeBuffer (PathTracer.cpp:628-652): the look-at point is
    ``eye + (cx, -cy, -cz)`` with c the normalized center direction (the
    reference's getAdjustedCenter, Camera.cpp:103-109), then
    w = normalize(c' - eye), u = normalize(w × up), v = normalize(u × w).
    """
    c = _norm3(center_dir)
    target = (eye[0] + c[0], eye[1] - c[1], eye[2] - c[2])
    w = _norm3((target[0] - eye[0], target[1] - eye[1], target[2] - eye[2]))
    u = _norm3(_cross3(w, up))
    v = _norm3(_cross3(u, w))

    s = lambda x: np.asarray(x, dtype=dtype)  # noqa: E731
    mk = lambda t: Vec3(s(t[0]), s(t[1]), s(t[2]))  # noqa: E731
    return CameraState(
        eye=mk(eye),
        w=mk(w),
        u=mk(u),
        v=mk(v),
        focal_length=s(focal_length),
        aperture=s(aperture),
        focus=s(focus),
    )


def pixel_dim(width: int, height: int, fov_deg: float) -> float:
    """Pixel footprint on the image plane at unit distance.

    Reference initKernelArgs (PathTracer.cpp:88-91):
    ``f = aspect * 2 * tan(fov/2); pxDim = f / width``.
    """
    aspect = float(width) / float(height)
    f = aspect * 2.0 * math.tan(math.radians(fov_deg) * 0.5)
    return f / float(width)


class Camera:
    """Interactive FPS-style camera (host-side, NumPy scalars).

    State and controls mirror the reference ``camera_t`` + move methods
    (Camera.h:15-21, Camera.cpp:20-94,192-241). ``on_update`` plays the role
    of GLWidget::cameraUpdate — the progressive renderer registers a callback
    that resets its sample accumulator whenever the camera changes
    (GLWidget.cpp:80-84).
    """

    def __init__(self, cfg: CameraConfig, on_update: Optional[Callable[[], None]] = None):
        self.cfg = cfg
        self.speed = cfg.speed
        self.on_update = on_update
        self.reset()

    # -- state -------------------------------------------------------------
    def reset(self) -> None:
        """Reset from config (Camera.cpp:80-94)."""
        self.eye = list(self.cfg.eye)
        self.up = [0.0, 1.0, 0.0]
        self.rot_x = 0.0
        self.rot_y = 0.0
        self.update_rotation(0, 0, _notify=False)
        self.center = list(_norm3(self.cfg.center))
        self._notify()

    def _notify(self) -> None:
        if self.on_update is not None:
            self.on_update()

    # -- moves (Camera.cpp:20-74) -----------------------------------------
    def _dir_xz(self):
        rx = math.radians(self.rot_x)
        ry = math.radians(self.rot_y)
        return math.sin(rx) * math.cos(ry), math.sin(ry), math.cos(rx) * math.cos(ry)

    def move_forward(self) -> None:
        dx, dy, dz = self._dir_xz()
        self.eye[0] += dx * self.speed
        self.eye[1] -= dy * self.speed
        self.eye[2] -= dz * self.speed
        self._notify()

    def move_backward(self) -> None:
        dx, dy, dz = self._dir_xz()
        self.eye[0] -= dx * self.speed
        self.eye[1] += dy * self.speed
        self.eye[2] += dz * self.speed
        self._notify()

    def move_left(self) -> None:
        rx = math.radians(self.rot_x)
        self.eye[0] -= math.cos(rx) * self.speed
        self.eye[2] -= math.sin(rx) * self.speed
        self._notify()

    def move_right(self) -> None:
        rx = math.radians(self.rot_x)
        self.eye[0] += math.cos(rx) * self.speed
        self.eye[2] += math.sin(rx) * self.speed
        self._notify()

    def move_up(self) -> None:
        self.eye[1] += self.speed
        self._notify()

    def move_down(self) -> None:
        self.eye[1] -= self.speed
        self._notify()

    # -- rotation (Camera.cpp:192-241) ------------------------------------
    def update_rotation(self, move_x: float, move_y: float, _notify: bool = True) -> None:
        self.rot_x -= move_x
        self.rot_y -= move_y
        if self.rot_x >= 360.0:
            self.rot_x = 0.0
        elif self.rot_x < 0.0:
            self.rot_x = 360.0
        self.rot_y = max(-90.0, min(90.0, self.rot_y))

        rx = math.radians(self.rot_x)
        ry = math.radians(self.rot_y)
        cx = math.sin(rx) - abs(math.sin(ry)) * math.sin(rx)
        cy = math.sin(ry)
        cz = math.cos(rx) - abs(math.sin(ry)) * math.cos(rx)
        self.center = [cx, cy, cz]

        # Pole handling: spherical up recompute (Camera.cpp:220-238).
        if cy == 1.0:
            self.up = [math.sin(rx), 0.0, -math.cos(rx)]
        elif cy == -1.0:
            self.up = [-math.sin(rx), 0.0, math.cos(rx)]
        else:
            self.up = [0.0, 1.0, 0.0]
        if _notify:
            self._notify()

    # -- render-time state -------------------------------------------------
    def state(self, focus: float = -1.0) -> CameraState:
        return make_camera_state(
            tuple(self.eye),
            tuple(self.center),
            tuple(self.up),
            focal_length=self.cfg.focal_length,
            aperture=self.cfg.aperture,
            focus=focus,
        )
