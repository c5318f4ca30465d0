"""Progressive path tracer on torch tensors.

The counterpart of ``pbr_tpu/models/pathtracer.py``: each frame traces
``samples`` paths per pixel and blends them into an accumulator that stays
on the device, with weight n/(n+1) (PathTracer.cpp:44, pt_rgb.cl:17). Only
``image()`` and ``depth_image()`` copy pixels to the host.

The compaction schedule comes from the same occupancy probe as in the JAX
version: here a plain call of ``trace_rays(..., with_stats=True)`` on a band
of rows. The host-side helpers ``probe_subset_ids`` and ``schedule_cost``
are NumPy, carried over unchanged so that both versions derive the same
schedule.

``PathTracer``'s frame step is captured once as a CUDA graph on the card
and replayed (``utils/graph.py``), the counterpart of the JAX version's
jitted step with its donated accumulator; ``render_frame`` is the eager
step itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pbr_tpu_torch.models.integrator import trace_rays
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import bvh_max_leaf, derive_static_flags
from pbr_tpu_torch.scene.device import to_torch
from pbr_tpu_torch.scene.types import CameraState, Scene
from pbr_tpu_torch.utils.config import RenderSettings
from pbr_tpu_torch.utils.graph import CapturedStep
from pbr_tpu_torch.utils.log import Logger
from pbr_tpu_torch.utils.morton import morton_pixel_ids

__all__ = [
    "FrameState", "PathTracer", "init_frame_state", "probe_compact_schedule",
    "probe_subset_ids", "render_frame", "schedule_cost",
]


class FrameState(NamedTuple):
    """Progressive accumulation state on the device."""

    rgb: Vec3  # (B,) accumulated color
    depth: torch.Tensor  # (B,) previous frame's first-hit t (DoF focus source)
    sample_count: torch.Tensor  # () int32


def init_frame_state(num_pixels: int, device) -> FrameState:
    return FrameState(
        rgb=Vec3.full((num_pixels,), (0.0, 0.0, 0.0), device),
        depth=torch.zeros((num_pixels,), dtype=torch.float32, device=device),
        sample_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def render_frame(scene, cam, settings: RenderSettings, state: FrameState,
                 pixel_ids, frame_seed, with_dropped: bool = False, max_leaf=None):
    """One progressive frame: trace, then blend (setColors, pt_rgb.cl:9-21).
    ``with_dropped`` also returns the compaction-overflow lane count (None
    when no schedule is active)."""
    res = trace_rays(scene, cam, settings, pixel_ids, frame_seed, prev_t=state.depth,
                     max_leaf=max_leaf)
    n = state.sample_count.to(torch.float32)
    weight = n / (n + 1.0)  # pixelWeight = n/(n+1), PathTracer.cpp:44
    rgb = Vec3(
        res.color.x * (1.0 - weight) + state.rgb.x * weight,
        res.color.y * (1.0 - weight) + state.rgb.y * weight,
        res.color.z * (1.0 - weight) + state.rgb.z * weight,
    )
    new_state = FrameState(rgb=rgb, depth=res.focus_t, sample_count=state.sample_count + 1)
    if with_dropped:
        return new_state, res.n_dropped
    return new_state


def _state_tensors(state: FrameState) -> tuple:
    """The five tensors of a ``FrameState``."""
    return (*state.rgb, state.depth, state.sample_count)


def _write_state(dst: FrameState, src: FrameState) -> None:
    """Copy ``src`` into the tensors of ``dst``, in place."""
    for d, s in zip(_state_tensors(dst), _state_tensors(src)):
        d.copy_(s)


def _clone(f):
    return Vec3(*(c.clone() for c in f)) if isinstance(f, Vec3) else f.clone()


def probe_subset_ids(ids: np.ndarray, block: int, target_lanes: int) -> np.ndarray:
    """Evenly strided subset of whole ``block``-aligned lane blocks of a
    pixel-id permutation, capped at about ``target_lanes`` lanes. Each
    selected block stays contiguous and aligned, so the live-row shares
    measured on the subset are at the production compaction granularity."""
    block = max(1, int(block))
    while ids.size % block:
        block //= 2  # the integrator halves until it divides; mirror it
    n_blocks = ids.size // block
    target = max(1, min(n_blocks, target_lanes // block))
    sel = np.unique(np.linspace(0, n_blocks - 1, target).round().astype(np.int64))
    return ids.reshape(n_blocks, block)[sel].reshape(-1)


def schedule_cost(schedule, max_total_depth: int) -> float:
    """Estimated total bounce width, in frame widths, under a compaction
    schedule: what the lane-order probe compares. Lower means less
    intersect and shade work over the frame's bounces."""
    total = 0.0
    for kb in range(max_total_depth):
        caps = [f for (b, f) in schedule if b <= kb]
        total += min(1.0, min(caps) if caps else 1.0)
    return total


def probe_compact_schedule(scene, cam, settings: RenderSettings, headroom: float = 1.5,
                           probe_rows: int = 64, pixel_ids=None, max_leaf=None):
    """A compaction schedule from a cheap occupancy probe: trace a band of
    rows (or, for a non-scanline lane order, a strided subset of whole
    ``compact_block`` lane blocks of ``pixel_ids``), then place a cap at
    every bounce whose live-row share (times ``headroom``) falls
    meaningfully below the previous stage's width. Same rule as the JAX
    version, so both derive the same schedule from the same occupancy."""
    w, h = settings.width, settings.height
    if pixel_ids is not None:
        ids = probe_subset_ids(np.asarray(pixel_ids, dtype=np.int32),
                               settings.compact_block, min(h, probe_rows) * w)
    else:
        n_rows = min(h, probe_rows)
        rows = np.arange(0, h, max(1, h // n_rows))[:n_rows]
        ids = (rows[:, None] * w + np.arange(w)[None, :]).reshape(-1).astype(np.int32)
    ps = settings.replace(compact_schedule=(), samples=1)
    res = trace_rays(scene, cam, ps, torch.as_tensor(ids, device=scene.device), 0,
                     with_stats=True, max_leaf=max_leaf)
    frac = res.bounce_row_live.cpu().numpy()
    schedule = []
    prev = 1.0
    for kb in range(1, settings.max_total_depth):
        f = min(1.0, float(frac[kb]) * headroom)
        if f < prev * 0.8:  # a stage pays for its gather only if it cuts width
            f = max(f, 1.0 / 512.0)
            schedule.append((kb, round(f, 4)))
            prev = f
    return tuple(schedule)


def _camera_values(cam: CameraState) -> list:
    """A ``CameraState``'s 15 floats in field order (Vec3 fields x, y, z)."""
    out = []
    for f in cam:
        out.extend(f if isinstance(f, tuple) else (f,))  # a Vec3 of either layer
    return out


def _camera_views(buf: torch.Tensor) -> CameraState:
    """A ``CameraState`` of 0-d views of the 15 floats of ``buf``."""
    it = iter(buf.unbind())
    return CameraState(*(Vec3(next(it), next(it), next(it)) if i < 4 else next(it)
                         for i in range(len(CameraState._fields))))


class PathTracer:
    """Stateful progressive renderer around ``render_frame``.

    ``scene`` is a NumPy ``Scene`` (``pbr_tpu_torch.scene.build``), moved onto
    ``device`` once (the card unless the caller names another device);
    ``render`` takes a NumPy ``CameraState`` (or one made by
    ``camera_to_torch``). ``max_leaf``: the faces a leaf of the scene's BVH
    may hold, for the tree walks; None derives it from the scene
    (``bvh_max_leaf``). ``lane_order``: 'scanline', 'morton', or 'auto',
    which probes both orders' occupancy at the first render and keeps the
    one that schedules less bounce width.

    The frame step is the JAX version's compiled step: a
    ``utils/graph.py::CapturedStep`` of one ``render_frame`` over static
    tensors (the accumulator, updated in place as JAX's donated state is;
    the camera; the frame seed), captured as a CUDA graph at the first
    ``render`` or at ``warmup``, once the probes have fixed the lane order
    and the schedule, and again only when the settings or the lanes
    change; on the CPU the same step runs eagerly. A frame with Phong
    tessellation is captured as every other frame is: its searches are
    kernels K9 and K10 (``ops/cuda_phong.py``). ``graph`` is the captured
    step (None before the first capture).
    """

    def __init__(self, scene: Scene, settings: RenderSettings, device="cuda",
                 lane_order: str = "auto", max_leaf=None):
        self.device = torch.device(device)
        # The traversal bound follows the scene's BVH (big scenes build
        # 64-face leaves, scene/build.py).
        self.max_leaf = bvh_max_leaf(scene) if max_leaf is None else max_leaf
        # Opaque-only scenes skip the refraction chain (bitwise-identical).
        settings = derive_static_flags(scene, settings)
        self.scene = to_torch(scene, self.device)
        auto_compact = settings.compact_schedule == "auto"
        if lane_order == "auto" and not auto_compact:
            # A pinned (or no) schedule was tuned on the identity order.
            lane_order = "scanline"
        if lane_order == "morton":
            perm = morton_pixel_ids(settings.width, settings.height)
        elif lane_order in ("scanline", "auto"):
            perm = None  # 'auto' may switch to morton at the probe
        else:
            raise ValueError(f"unknown lane_order {lane_order!r}")
        self.lane_order = lane_order
        self._auto_compact = auto_compact
        self.settings = settings.replace(compact_schedule=()) if auto_compact else settings
        self._set_lane_order(perm)
        # The step's static tensors: the accumulator, the frame seed (the
        # low 32 bits of an int, as JAX's uint32), and the camera's 15
        # floats, of which ``_cam_static`` holds 0-d views.
        self._state = init_frame_state(settings.width * settings.height, self.device)
        self._seed = torch.zeros((), dtype=torch.int64, device=self.device)
        self._cam_buf = torch.zeros((15,), dtype=torch.float32, device=self.device)
        self._cam_static = _camera_views(self._cam_buf)
        self._cam_vals = None  # the floats of the last NumPy camera
        self.graph = None
        self._graph_key = None
        self._warned_drop = False
        self._frame_no = -1

    def _set_lane_order(self, perm) -> None:
        """Lane i traces pixel ``perm[i]`` (identity when ``perm`` is None)."""
        self._perm = perm
        if perm is None:
            npx = self.settings.width * self.settings.height
            self.pixel_ids = torch.arange(npx, dtype=torch.int32, device=self.device)
        else:
            self.pixel_ids = torch.as_tensor(perm, device=self.device)

    @property
    def state(self) -> FrameState:
        """The accumulator: the step's static tensors. Assigning a
        ``FrameState`` (a restored checkpoint) copies it into them."""
        return self._state

    @state.setter
    def state(self, new: FrameState) -> None:
        _write_state(self._state, new)

    def _camera(self, cam: CameraState) -> CameraState:
        """The static camera, holding ``cam``'s values (a NumPy
        ``CameraState`` or one of tensors): a NumPy camera is copied to the
        device when its values change, so a steady camera costs no copy."""
        vals = _camera_values(cam)
        if isinstance(vals[0], torch.Tensor):
            self._cam_vals = None
            self._cam_buf.copy_(torch.stack([v.detach().reshape(()).to(self.device, torch.float32)
                                             for v in vals]))
        else:
            host = np.asarray(vals, dtype=np.float32)
            if self._cam_vals is None or not np.array_equal(host, self._cam_vals):
                self._cam_vals = host
                self._cam_buf.copy_(torch.from_numpy(host))
        return self._cam_static

    def _resolve_auto_compact(self, cam: CameraState) -> None:
        if not self._auto_compact:
            return
        self._auto_compact = False
        if self.lane_order == "auto":
            mperm = morton_pixel_ids(self.settings.width, self.settings.height)
            sched_s = probe_compact_schedule(self.scene, cam, self.settings,
                                             max_leaf=self.max_leaf)
            sched_m = probe_compact_schedule(self.scene, cam, self.settings, pixel_ids=mperm,
                                             max_leaf=self.max_leaf)
            depth = self.settings.max_total_depth
            cost_s = schedule_cost(sched_s, depth)
            cost_m = schedule_cost(sched_m, depth)
            if cost_m < cost_s:
                self.lane_order = "morton"
                self._set_lane_order(mperm)
                schedule = sched_m
            else:
                self.lane_order = "scanline"
                schedule = sched_s
            Logger.info(
                f"[pathtracer] lane-order probe: scanline width {cost_s:.2f}"
                f" vs morton {cost_m:.2f} -> {self.lane_order}"
            )
        else:
            schedule = probe_compact_schedule(self.scene, cam, self.settings,
                                              pixel_ids=self._perm, max_leaf=self.max_leaf)
        Logger.info(f"[pathtracer] auto compaction schedule: {schedule}")
        self.settings = self.settings.replace(compact_schedule=schedule)

    def _frame(self, seed: torch.Tensor, *_static):
        """One frame over the static tensors, folded into the accumulator
        in place; returns the compaction-overflow count (None without a
        schedule)."""
        with torch.no_grad():
            new, n_dropped = render_frame(self.scene, self._cam_static, self.settings,
                                          self._state, self.pixel_ids, seed,
                                          with_dropped=True, max_leaf=self.max_leaf)
            _write_state(self._state, new)
        return n_dropped

    def _step(self):
        """The frame step of the current settings and lanes: the captured
        one, built anew where they changed."""
        key = (self.settings, self.pixel_ids)
        if self.graph is None or self._graph_key[0] != key[0] or self._graph_key[1] is not key[1]:
            self.graph = CapturedStep(self._frame, self._seed, self._cam_buf, *_state_tensors(
                self._state), name=f"PathTracer's frame step ({self.settings.intersector})")
            self._graph_key = key
        return self.graph

    def warmup(self, cam: CameraState) -> None:
        """Resolve the probes and capture the frame step without folding a
        frame into the accumulator (the JAX version's ahead-of-time
        compile): the capture's eager run is undone. The next ``render``
        replays the graph. On the CPU only the probes run."""
        cam = self._camera(cam)
        self._resolve_auto_compact(cam)
        step = self._step()
        if self.device.type != "cuda" or step.graph is not None:
            return
        saved = FrameState(*(_clone(f) for f in self._state))
        step.capture()
        _write_state(self._state, saved)

    def reset_sample_count(self) -> None:
        """Restart progressive accumulation (PathTracer.cpp:576-578): the
        accumulator is zeroed in place."""
        for t in _state_tensors(self._state):
            t.zero_()

    def move_light(self, index: int, dx: float, dy: float, dz: float) -> None:
        """Translate light ``index`` and restart accumulation. The step
        reads the scene's position tensor in place, so it is updated there;
        the ``light_pos`` parameter handed out before is given a copy of the
        old position, which it keeps."""
        old = self.scene.light_pos
        pos = old.detach()  # the tensor the step reads
        old.data = pos.clone()
        pos[:, index] += torch.tensor((dx, dy, dz), dtype=pos.dtype, device=pos.device)
        self.scene.light_pos = torch.nn.Parameter(pos, requires_grad=old.requires_grad)
        self.reset_sample_count()

    def render(self, cam: CameraState, frame_seed: int = 0) -> None:
        """Trace one frame and fold it into the accumulator: a replay of
        the captured frame step (its capture at the first call)."""
        cam = self._camera(cam)
        self._resolve_auto_compact(cam)
        self._seed.fill_(int(frame_seed) & 0xFFFFFFFF)
        n_dropped = self._step()()
        # Compaction-overflow guard: a nonzero count means live lanes were
        # cut short, a biased render. int() syncs the host, so it is read
        # on the first frames and then every 32nd only.
        self._frame_no += 1
        if (
            n_dropped is not None
            and not self._warned_drop
            and (self._frame_no <= 2 or self._frame_no % 32 == 0)
            and int(n_dropped) > 0
        ):
            Logger.warning(
                f"[pathtracer] compaction capacity overflow: {int(n_dropped)} "
                f"live lanes terminated early this frame — raise "
                f"compact_schedule caps (or use compact_schedule='auto'); "
                f"the render is biased"
            )
            self._warned_drop = True

    @property
    def sample_count(self) -> int:
        return int(self._state.sample_count)

    def _to_pixels(self, lanes: np.ndarray) -> np.ndarray:
        """Lane order -> pixel order, then rows flipped: pixel row 0 is the
        camera-space bottom (+v is up), the image's top row comes first."""
        if self._perm is not None:
            img = np.empty_like(lanes)
            img[self._perm] = lanes  # lane i holds pixel _perm[i]
            lanes = img
        h, w = self.settings.height, self.settings.width
        return lanes.reshape(h, w, *lanes.shape[1:])[::-1]

    def image(self) -> np.ndarray:
        """The accumulated image as (H, W, 3) float32 on the host, top row
        first."""
        rgb = torch.stack([self._state.rgb.x, self._state.rgb.y, self._state.rgb.z], dim=-1)
        return self._to_pixels(rgb.detach().cpu().numpy())

    def depth_image(self) -> np.ndarray:
        return self._to_pixels(self._state.depth.detach().cpu().numpy())
