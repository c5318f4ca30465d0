"""Configuration system.

Mirrors the reference's JSON config (reference ``config.json`` and
``source/Cfg.{h,cpp}``: a singleton boost property-tree with 39 dotted keys,
e.g. ``camera.eye.x``, ``render.max_depth``), redesigned as typed dataclasses.

The crucial architectural mapping (SURVEY.md §5): everything the reference
burned into the OpenCL kernel at build time via ``#PLACEHOLDER#`` substitution
(BRDF choice, depth limits, samples, image dims, shadow rays, sky light, ...)
becomes a hashable static argument at ``jax.jit`` trace time here — the
``RenderSettings`` dataclass is hashable and frozen for exactly that reason.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

BRDF_SCHLICK = 0
BRDF_SHIRLEY_ASHIKHMIN = 1

ACCEL_NONE = -1  # brute-force all-triangles intersection (TPU-friendly for small scenes)
ACCEL_BVH = 0  # stackless linear BVH (reference ACCELSTRUCT_BVH, AccelStructure.h:4)

NI_AIR = 1.00028  # index of refraction of air (reference pt_header.cl:13)
EPSILON5 = 1.0e-5  # intersection epsilon (reference pt_header.cl:6)


@dataclass(frozen=True)
class CameraConfig:
    """Camera startup state (reference config.json "camera")."""

    eye: Tuple[float, float, float] = (0.0, 1.0, 3.0)
    center: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov: float = 45.0  # degrees (camera.perspective.fov)
    znear: float = 0.1
    zfar: float = 1000.0
    # Thin-lens model (camera.thin_lense) — aperture given as f-number.
    focal_length: float = 0.035
    aperture: float = 1.8
    speed: float = 0.2  # step distance for interactive moves


@dataclass(frozen=True)
class BVHConfig:
    """BVH build knobs (reference config.json "bvh")."""

    max_faces: int = 2  # max faces per leaf (reference restricts to [1, 2]; we allow more)
    sah_faces_limit: int = 100_000  # use full-sweep SAH up to this many faces, else mean split
    skip_ahead: bool = False  # reference "skip ahead" traversal optimization
    skip_ahead_compare: float = 0.7


@dataclass(frozen=True)
class RenderSettings:
    """Static (trace-time) render settings.

    Hashable: passed as a static argument to ``jax.jit``. The reference baked
    each of these into the kernel source (CL.cpp:626-705 ``setValues``).
    """

    width: int = 800
    height: int = 600
    fov: float = 45.0  # camera.perspective.fov; static because it fixes pxDim (PathTracer.cpp:88-91)
    brdf: int = BRDF_SHIRLEY_ASHIKHMIN  # render.brdf (config.json default: 1)
    samples: int = 1  # paths per pixel per frame (render.samples)
    max_depth: int = 3  # render.max_depth
    max_added_depth: int = 5  # render.max_added_depth (path extension budget)
    shadow_rays: int = 0  # render.shadow_rays (NEE on/off)
    anti_aliasing: float = 0.7  # render.antialiasing (sub-pixel jitter scale)
    phong_tessellation: float = 0.0  # render.phong_tessellation (0 = off)
    accel_struct: int = ACCEL_BVH
    # Intersector implementation: 'auto' (bvh if built, else brute),
    # 'brute', 'gemm' (MXU matmul), 'pallas' (fused TPU kernel), 'bvh'.
    intersector: str = "auto"
    # Bounce-loop compilation strategy (jax only): 'scan' = lax.scan over
    # bounces (~8x faster compiles), 'unroll' = Python unroll (~1.8x faster
    # runtime, XLA optimizes across bounces). Numerics are identical.
    bounce_loop: str = "scan"
    # Samples-per-pixel loop strategy (jax only): 'scan' = lax.scan over
    # the sample index (compile time stays ~flat in ``samples`` — the
    # reference's SAMPLES loop was likewise one device-side loop,
    # pathtracing.cl:251), 'unroll' = Python unroll (XLA may fuse across
    # samples; compile time scales linearly). Numerics are identical (the
    # RNG is (pixel, sample, bounce)-keyed either way).
    sample_loop: str = "scan"
    # Live-path compaction schedule: ((bounce, frac), ...) — at each listed
    # bounce index, gather the rows (groups of ``compact_block`` consecutive
    # lanes) that still contain live paths into a buffer of ``frac * batch``
    # lanes and run the following bounces at that width. The live fraction
    # collapses once the dynamic depth bound kicks in (only *extended* paths
    # survive past max_depth — integrator line "(depth+1) < max_depth +
    # depth_added"). A pure permutation (RNG is pixel-keyed): every
    # per-lane value is identical; the only theoretical deviation is float
    # summation order for a lane receiving 2+ NEE contributions after a
    # compaction point (ULP-level; bitwise-equal on the test scenes).
    # Capacity overflow terminates the excess rows' live lanes early
    # (counted by the n_dropped stat). () disables.
    compact_schedule: Tuple[Tuple[int, float], ...] = ()
    # Compaction granularity in lanes. Rows of this many consecutive lanes
    # are kept or dropped as a unit: a row gather from (R, block) lowers to
    # contiguous per-row copies on TPU, whereas a lane-granular
    # gather/scatter serializes per element (measured ~100 ms per
    # compaction point at 1M lanes — slower than just running the dead
    # lanes full-width). Image-space coherence keeps live lanes clustered,
    # so row occupancy stays close to the lane-level live fraction. 1 =
    # exact lane compaction (fine on CPU/numpy). Internally halved until it
    # divides the batch.
    compact_block: int = 128
    # Backward-pass rematerialization (jax only): 'none' lets XLA store
    # whatever residuals it likes; 'save_isect' wraps each bounce in
    # jax.checkpoint with a save_only_these_names policy that keeps ONLY the
    # intersect kernel outputs (t/face/occluded — the values that are
    # expensive to recompute and tiny to store) and recomputes all shading
    # math in the backward pass. Turns the backward from residual-bandwidth
    # bound into (cheap) recompute.
    remat: str = "none"
    # Scene-dependent constants the reference injected at kernel build time:
    # NUM_LIGHTS / SKY_LIGHT / BVH_NUM_NODES become static here too, derived
    # from the Scene at trace time (shapes are static anyway).
    sky_light: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # Scene-derived static specialization (reference #PLACEHOLDER# spirit):
    # True = every material is opaque (d == 1), so the whole per-bounce
    # refraction chain (refract_dir: Fresnel split, TIR, transmit dir —
    # ~50 VPU ops/lane/bounce) and the transmit RNG draw are statically
    # dead and skipped. Bitwise-identical output on such scenes (do_trans
    # is identically false; streams are independently keyed). Derived
    # automatically by PathTracer/bench from the scene's materials.
    no_transparency: bool = False

    @property
    def max_total_depth(self) -> int:
        """Static bound of the bounce loop: MAX_DEPTH + MAX_ADDED_DEPTH."""
        return self.max_depth + self.max_added_depth

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Config:
    """Top-level config mirroring the reference's config.json tree."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    bvh: BVHConfig = field(default_factory=BVHConfig)
    render: RenderSettings = field(default_factory=RenderSettings)
    logging_level: int = 2  # 0 none .. 4 extra verbose (config.json "logging.level")
    import_path: str = ""

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_COMMENT_RE = re.compile(r"^\s*//.*$", re.MULTILINE)


def _strip_json_comments(text: str) -> str:
    """Strip ``//`` line comments (the reference's config.json uses them)."""
    return _COMMENT_RE.sub("", text)


def _get(d: dict, path: str, default: Any) -> Any:
    cur: Any = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def load_config(path: Optional[str] = None, text: Optional[str] = None) -> Config:
    """Load a config from a JSON file using the reference's key layout.

    Unknown keys are ignored; missing keys fall back to the defaults above
    (which equal the reference's config.json defaults).
    """
    if text is None:
        if path is None:
            return Config()
        with open(path) as f:
            text = f.read()
    d = json.loads(_strip_json_comments(text))

    cam = CameraConfig(
        eye=(
            float(_get(d, "camera.eye.x", 0.0)),
            float(_get(d, "camera.eye.y", 1.0)),
            float(_get(d, "camera.eye.z", 3.0)),
        ),
        center=(
            float(_get(d, "camera.center.x", 0.0)),
            float(_get(d, "camera.center.y", 0.0)),
            float(_get(d, "camera.center.z", 1.0)),
        ),
        fov=float(_get(d, "camera.perspective.fov", 45.0)),
        znear=float(_get(d, "camera.perspective.znear", 0.1)),
        zfar=float(_get(d, "camera.perspective.zfar", 1000.0)),
        focal_length=float(_get(d, "camera.thin_lense.focal_length", 0.035)),
        aperture=float(_get(d, "camera.thin_lense.aperture", 1.8)),
        speed=float(_get(d, "camera.speed", 0.2)),
    )
    bvh = BVHConfig(
        max_faces=int(_get(d, "bvh.max_faces", 2)),
        sah_faces_limit=int(_get(d, "bvh.sah_faces_limit", 100_000)),
        skip_ahead=bool(_get(d, "bvh.skip_ahead", False)),
        skip_ahead_compare=float(_get(d, "bvh.skip_ahead_compare", 0.7)),
    )
    render = RenderSettings(
        width=int(_get(d, "window.width", 800)),
        height=int(_get(d, "window.height", 600)),
        fov=float(_get(d, "camera.perspective.fov", 45.0)),
        brdf=int(_get(d, "render.brdf", BRDF_SHIRLEY_ASHIKHMIN)),
        samples=int(_get(d, "render.samples", 1)),
        max_depth=int(_get(d, "render.max_depth", 3)),
        max_added_depth=int(_get(d, "render.max_added_depth", 5)),
        shadow_rays=int(_get(d, "render.shadow_rays", 0)),
        anti_aliasing=float(_get(d, "render.antialiasing", 0.7)),
        phong_tessellation=float(_get(d, "render.phong_tessellation", 0.0)),
        accel_struct=int(_get(d, "accel_struct", ACCEL_BVH)),
    )
    return Config(
        camera=cam,
        bvh=bvh,
        render=render,
        logging_level=int(_get(d, "logging.level", 2)),
        import_path=str(_get(d, "import_path", "")),
    )
