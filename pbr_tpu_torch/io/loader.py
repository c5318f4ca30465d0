"""Model loader façade: file path → renderer-ready Scene + settings.

The analog of the reference's ``ModelLoader`` (ModelLoader.cpp:74-88) plus
the GLWidget import pipeline (GLWidget.cpp:339-387: parse → BVH → device
buffers): one call takes an ``.obj`` path, loads its ``.mtl``/``.lights``
companions, builds the BVH, and returns the Scene along with settings fixed
up with scene-derived constants (sky light, shadow-ray gating).
"""

from __future__ import annotations

from typing import Optional, Tuple

from pbr_tpu_torch.io.obj import ObjData, parse_obj_file
from pbr_tpu_torch.scene.build import apply_scene_constants, build_scene
from pbr_tpu_torch.scene.types import Scene
from pbr_tpu_torch.utils.config import ACCEL_BVH, BVHConfig, RenderSettings
from pbr_tpu_torch.utils.log import Logger, Timer


def load_model(
    path: str,
    settings: Optional[RenderSettings] = None,
    bvh_cfg: Optional[BVHConfig] = None,
) -> Tuple[Scene, RenderSettings, ObjData]:
    """Load an OBJ scene from disk. Returns (scene, settings', objdata)."""
    settings = settings or RenderSettings()
    t = Timer()
    obj = parse_obj_file(path, load_lights=settings.shadow_rays > 0)
    use_bvh = settings.accel_struct == ACCEL_BVH
    # The Phong alpha goes to the build: a tree over flat bounds would cull
    # the patches' bulges (the JAX package's load_model does not pass it).
    scene = build_scene(obj, bvh_cfg=bvh_cfg, use_bvh=use_bvh,
                        phong_tess_alpha=settings.phong_tessellation)
    settings = apply_scene_constants(settings, obj)
    Logger.info(f"[loader] Loaded model '{path}' in {t.s():.3g} s.")
    return scene, settings, obj
