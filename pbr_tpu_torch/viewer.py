"""Interactive terminal viewer — the headless counterpart of the reference's
Qt render window (``Window`` + ``GLWidget``: progressive display, WASDQE/R
camera with progressive restart, F/G speed, L light-move toggle, right-click
DoF focus, FPS status bar — Window.cpp:178-242, GLWidget.cpp:432-517,791-815).

The counterpart of ``pbr_tpu/viewer.py``. Frames accumulate on the device
(the card unless the caller names another) and are blitted to the terminal
as ANSI truecolor half-blocks (two pixels per character cell, '▀' with
foreground = top pixel, background = bottom pixel). The JAX viewer's
draft-then-refine startup (a cheap program while the production one
compiles in a thread) is not ported: eager torch compiles nothing, so the
first frame is a production frame.

Controls (reference key map, Window.cpp:178-211):
    w/a/s/d     move forward/left/backward/right
    q/e         move up/down
    arrow keys  rotate (the reference used mouse drag, Window.cpp:218-242)
    r           reset camera to config
    f/g         camera speed +0.1 / -0.1 (GLWidget.cpp:432-434)
    l           toggle light-move mode: WASDQE move light 0 by 0.25
    p / o       set DoF focus to the crosshair pixel's hit distance / clear
    P           focus-pick mode (arrows move the crosshair)
    b / n       BVH-leaf / light-box overlays
    i           live per-stage times
    x           quit

Any camera or light change restarts progressive accumulation, exactly like
GLWidget::cameraUpdate → PathTracer::resetSampleCount (GLWidget.cpp:80-84).

Scriptable for tests and CI: pass ``keys`` (one key consumed per frame) and
``max_frames``; writing goes to any file-like ``out``.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.camera import Camera
from pbr_tpu_torch.scene.types import Scene
from pbr_tpu_torch.utils.config import CameraConfig, RenderSettings
from pbr_tpu_torch.utils.log import Logger
from pbr_tpu_torch.utils.profiling import synchronize

_ROT_STEP = 4.0  # degrees per arrow-key press (mouse-drag analog)
_LIGHT_STEP = 0.25  # PathTracer.cpp:544-565 (commented-out upstream)


def tonemap_u8(img: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """Clip + gamma-2.2 encode to uint8 (the GL blit displayed the raw
    float texture; a terminal needs 8-bit sRGB)."""
    x = np.clip(img / max(exposure, 1e-6), 0.0, 1.0)
    return (x ** (1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Area-average (H, W, 3) → (out_h, out_w, 3) by integer binning of a
    cropped-to-divisible region; nearest-sample fallback when upscaling."""
    h, w = img.shape[:2]
    if out_h <= 0 or out_w <= 0:
        raise ValueError("downsample: empty output")
    if out_h > h or out_w > w:
        yi = np.linspace(0, h - 1, out_h).astype(int)
        xi = np.linspace(0, w - 1, out_w).astype(int)
        return img[yi][:, xi]
    by, bx = h // out_h, w // out_w
    crop = img[: out_h * by, : out_w * bx]
    return crop.reshape(out_h, by, out_w, bx, -1).mean(axis=(1, 3))


def ansi_halfblocks(u8: np.ndarray) -> str:
    """(2R, C, 3) uint8 → R text rows of truecolor half-block cells."""
    rows = []
    h = u8.shape[0] // 2 * 2
    for y in range(0, h, 2):
        top, bot = u8[y], u8[y + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


class _RawKeys:
    """Non-blocking raw-mode key source for a real tty; optional."""

    def __init__(self, stream):
        self._stream = stream
        self._fd = stream.fileno()
        self._saved = None

    def __enter__(self):
        import termios
        import tty

        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self) -> Optional[str]:
        import select

        r, _, _ = select.select([self._fd], [], [], 0)
        if not r:
            return None
        ch = self._stream.read(1)
        if ch == "\x1b":  # arrow keys: ESC [ A/B/C/D
            r, _, _ = select.select([self._fd], [], [], 0.01)
            if r and self._stream.read(1) == "[":
                code = self._stream.read(1)
                return {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}.get(code)
            return None
        return ch


class Viewer:
    """Progressive render loop + key dispatch (the GLWidget/QTimer analog).

    ``scene``: a NumPy ``Scene``; the tracer moves it onto ``device`` (the
    card unless the caller names another device)."""

    def __init__(
        self,
        scene: Scene,
        settings: RenderSettings,
        cam_cfg: CameraConfig = CameraConfig(),
        max_leaf: int = None,
        exposure: float = 2.5,
        term_cols: int = 80,
        term_rows: int = 24,
        out=None,
        lane_order: str = "auto",
        device="cuda",
    ):
        t_ctor0 = time.perf_counter()
        from pbr_tpu_torch.models.pathtracer import PathTracer

        self.scene = scene  # the host copy the overlays draw from
        self.tracer = PathTracer(scene, settings, device=device, lane_order=lane_order,
                                 max_leaf=max_leaf)
        self._resets = 0  # progressive restarts (observable for tests);
        # set before Camera() — its reset() fires on_update immediately.
        self.camera = Camera(cam_cfg, on_update=self._on_camera_update)
        self._resets = 0
        self.settings = settings
        self.exposure = exposure
        self.term_cols = term_cols
        self.term_rows = term_rows
        self.out = out if out is not None else sys.stdout
        self.move_light = False  # GLWidget::mMoveLight (GLWidget.cpp:858-864)
        self.focus = -1.0  # DoF focus distance; -1 = off
        # Focus crosshair — the terminal analog of right-click-to-focus
        # (GLWidget.cpp:441-447): 'P' toggles pick mode (arrows move the
        # crosshair), 'p' focuses at the crosshair (defaults to center).
        self.pick_mode = False
        self.focus_px = settings.width // 2
        self.focus_py = settings.height // 2
        self.show_info = False  # 'i': live per-stage times (InfoWindow analog)
        self.stage_ms = {}
        self.frame = 0
        self.quit = False
        # Live overlay toggles — the reference's View-menu runtime toggles
        # (Window.cpp:69-106) as viewer keys 'b' (BVH leaves) / 'n'
        # (light boxes), drawn over the displayed frame each redraw.
        self.show_bvh = False
        self.show_lights = False
        # The tracer's probes and its frame step's capture (a CUDA graph on
        # the card), before the first frame, as the JAX viewer compiles its
        # step ahead of the first frame.
        t_warm0 = time.perf_counter()
        self.tracer.warmup(self.camera.state(focus=self.focus))
        # Startup breakdown: wall times of the path to the first visible
        # frame (tracer init with the warm-up, the warm-up alone, first
        # frame, first draw).
        self.startup = {"init_s": round(time.perf_counter() - t_ctor0, 3),
                        "warmup_s": round(time.perf_counter() - t_warm0, 3)}

    # ---- state hooks ----------------------------------------------------
    def _on_camera_update(self) -> None:
        self.tracer.reset_sample_count()
        self._resets += 1

    def _move_light(self, key: str) -> None:
        """Move light 0 (the completed PathTracer::moveSun) and restart."""
        dx = {"a": -_LIGHT_STEP, "d": _LIGHT_STEP}.get(key, 0.0)
        dy = {"q": _LIGHT_STEP, "e": -_LIGHT_STEP}.get(key, 0.0)
        dz = {"w": _LIGHT_STEP, "s": -_LIGHT_STEP}.get(key, 0.0)
        self.tracer.move_light(0, dx, dy, dz)
        self._resets += 1

    def handle_key(self, key: str) -> None:
        if key in ("x", "\x03"):
            self.quit = True
            return
        if key == "l":
            self.move_light = not self.move_light
            Logger.info(f"[viewer] Keyboard controls light: {int(self.move_light)}")
            return
        if self.move_light and key in "wasdqe":
            self._move_light(key)
            return
        if key == "b":
            self.show_bvh = not self.show_bvh
            Logger.info(f"[viewer] BVH overlay: {int(self.show_bvh)}")
            return
        if key == "i":
            # Live per-stage times — the InfoWindow analog (the reference
            # polled per-kernel GPU ms on a timer, InfoWindow.cpp:113-121).
            # While on, the frame step is synchronised so 'trace' is
            # device time, not the time to queue the frame's work.
            self.show_info = not self.show_info
            Logger.info(f"[viewer] Stage-times readout: {int(self.show_info)}")
            return
        if key == "n":
            self.show_lights = not self.show_lights
            Logger.info(f"[viewer] Lights overlay: {int(self.show_lights)}")
            return
        if key == "P":
            self.pick_mode = not self.pick_mode
            Logger.info(f"[viewer] Focus-pick mode: {int(self.pick_mode)}")
            return
        if self.pick_mode and key in ("LEFT", "RIGHT", "UP", "DOWN"):
            step = max(1, self.settings.width // 32)
            dx = {"LEFT": -step, "RIGHT": step}.get(key, 0)
            dy = {"UP": -step, "DOWN": step}.get(key, 0)
            self.focus_px = int(np.clip(self.focus_px + dx, 0, self.settings.width - 1))
            self.focus_py = int(np.clip(self.focus_py + dy, 0, self.settings.height - 1))
            return
        cam = self.camera
        if key == "w":
            cam.move_forward()
        elif key == "s":
            cam.move_backward()
        elif key == "a":
            cam.move_left()
        elif key == "d":
            cam.move_right()
        elif key == "q":
            cam.move_up()
        elif key == "e":
            cam.move_down()
        elif key == "r":
            cam.reset()
        elif key == "f":
            cam.speed += 0.1
        elif key == "g":
            cam.speed = max(0.0, cam.speed - 0.1)
        elif key == "LEFT":
            cam.update_rotation(-_ROT_STEP, 0)
        elif key == "RIGHT":
            cam.update_rotation(_ROT_STEP, 0)
        elif key == "UP":
            cam.update_rotation(0, -_ROT_STEP)
        elif key == "DOWN":
            cam.update_rotation(0, _ROT_STEP)
        elif key == "p":
            # Focus on the crosshair pixel's first-hit distance (right-click
            # setFocus analog, GLWidget.cpp:441-447 / PathTracer.cpp:596-602).
            self.set_focus_pixel(self.focus_px, self.focus_py)
        elif key == "o":
            self.focus = -1.0
            self._on_camera_update()

    def set_focus_pixel(self, px: int, py: int) -> None:
        """Focus the thin lens on pixel (px, py)'s first-hit distance —
        any pixel, like the reference's right-click (GLWidget.cpp:441-447)."""
        self.focus_px = int(np.clip(px, 0, self.settings.width - 1))
        self.focus_py = int(np.clip(py, 0, self.settings.height - 1))
        depth = self.tracer.depth_image()
        t = float(depth[self.focus_py, self.focus_px])
        self.focus = t if np.isfinite(t) and t > 0 else -1.0
        self._on_camera_update()

    # ---- frame loop ------------------------------------------------------
    def _stage_ms(self, name: str, dt_s: float) -> None:
        """Exponential moving average of a per-frame stage time (the live
        counterpart of InfoWindow's per-kernel ms table)."""
        ms = dt_s * 1e3
        prev = self.stage_ms.get(name)
        self.stage_ms[name] = ms if prev is None else 0.8 * prev + 0.2 * ms

    def render_one(self) -> None:
        first = self.frame == 0
        if first or self.show_info:
            t0 = time.perf_counter()
        self.tracer.render(self.camera.state(focus=self.focus), frame_seed=self.frame)
        if first or self.show_info:
            synchronize(self.tracer.device)
            if first:
                self.startup["first_frame_s"] = round(time.perf_counter() - t0, 3)
            else:
                self._stage_ms("trace", time.perf_counter() - t0)
        self.frame += 1

    def draw(self) -> None:
        t0 = time.perf_counter()
        img = self.tonemapped()
        if self.show_info:
            self._stage_ms("fetch+tonemap", time.perf_counter() - t0)
        cells_w = min(self.term_cols, self.settings.width)
        cells_h = min(self.term_rows - 1, max(1, self.settings.height // 2))
        small = downsample(img, cells_h * 2, cells_w)
        w = self.out
        t0 = time.perf_counter()
        w.write("\x1b[H\x1b[2J")  # home + clear
        w.write(ansi_halfblocks(small.astype(np.uint8)))
        w.write("\n" + self.status_line() + "\n")
        if self.show_info:
            self._stage_ms("blit", time.perf_counter() - t0)
            w.write(self.info_line() + "\n")
        w.flush()
        if "first_draw_s" not in self.startup:
            self.startup["first_draw_s"] = round(
                time.perf_counter() - self._t_run0, 3
            ) if hasattr(self, "_t_run0") else None

    def tonemapped(self) -> np.ndarray:
        img = self.tracer.image()
        if self.show_bvh or self.show_lights:
            from pbr_tpu_torch.accel.visualize import overlay_bvh, overlay_lights

            cam = self.camera.state(focus=self.focus)
            # The lights where the tracer has them ('l' moves them there).
            pos = self.tracer.scene.light_pos.detach().cpu().numpy()
            scene = self.scene._replace(lights=self.scene.lights._replace(pos=Vec3(*pos)))
            if self.show_bvh and scene.bvh is not None:
                img = overlay_bvh(img, scene, cam)
            if self.show_lights and scene.lights.count:
                img = overlay_lights(img, scene, cam)
        return tonemap_u8(img, self.exposure)

    def write_startup_breakdown(self, path: str) -> None:
        """Persist the startup-stage wall times (tracer init, first frame,
        first draw) as JSON."""
        import json

        with open(path, "w") as f:
            json.dump(self.startup, f, indent=1, sort_keys=True)
        Logger.info(f"[viewer] startup breakdown -> {path}: {self.startup}")

    def status_line(self) -> str:
        """The status-bar line (GLWidget::showFPS, GLWidget.cpp:791-815)."""
        e = self.camera.eye
        mode = "LIGHT" if self.move_light else "cam"
        return (
            f"frame {self.frame} | {self.tracer.sample_count} spp | "
            f"{self.settings.width}x{self.settings.height} | "
            f"eye ({e[0]:.2f}, {e[1]:.2f}, {e[2]:.2f}) | speed "
            f"{self.camera.speed:.1f} | {mode} | keys: wasdqe move, arrows "
            f"rotate, r reset, f/g speed, l light, i times, p/o focus, x quit"
        )

    def info_line(self) -> str:
        """Live per-stage ms readout (the InfoWindow analog). EMA-smoothed
        per-frame stage times; 'trace' is the synchronised device step,
        'fetch+tonemap' the device->host copy + tonemap, 'blit' the
        terminal write."""
        if not self.stage_ms:
            return "stages: (first reading pending)"
        parts = [f"{k} {v:7.2f} ms" for k, v in self.stage_ms.items()]
        return "stages: " + " | ".join(parts)

    def run(
        self,
        max_frames: Optional[int] = None,
        keys: Optional[str] = None,
        draw: bool = True,
        target_fps: float = 30.0,
    ) -> None:
        """Progressive loop (the QTimer at render.interval ms,
        GLWidget.cpp:30-34,833-840). ``keys``: scripted key string consumed
        one per frame (tests/CI); otherwise reads the tty when available."""
        scripted = list(keys) if keys is not None else None
        self._t_run0 = time.perf_counter()
        interval = 1.0 / max(target_fps, 1e-3)
        tty_src = None
        if scripted is None and hasattr(sys.stdin, "isatty") and sys.stdin.isatty():
            tty_src = _RawKeys(sys.stdin)
        try:
            if tty_src is not None:
                tty_src.__enter__()
            while not self.quit and (max_frames is None or self.frame < max_frames):
                t0 = time.perf_counter()
                if scripted is not None:
                    if scripted:
                        self.handle_key(scripted.pop(0))
                elif tty_src is not None:
                    k = tty_src.poll()
                    while k is not None:
                        self.handle_key(k)
                        k = tty_src.poll()
                if self.quit:
                    break
                self.render_one()
                if draw:
                    self.draw()
                if tty_src is not None:
                    dt = time.perf_counter() - t0
                    if dt < interval:
                        time.sleep(interval - dt)
        finally:
            if tty_src is not None:
                tty_src.__exit__()
