"""Parser for the reference's custom ``.lights`` format.

Reference: ``source/LightParser.{h,cpp}``. Keys: ``newlight <name>``,
``type <1|2>`` (1 = point light, 2 = orb), ``rgb r g b``, ``pos x y z``,
``radius r``. Defaults (LightParser.cpp:11-22): white pos/rgb, radius 0,
type 0. A file with zero lights makes the reference force shadow_rays off
(LightParser.cpp:116-121) — the loader mirrors that by returning an empty
set which the renderer gates on at trace time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import LightsSoA
from pbr_tpu_torch.utils.log import Logger

LIGHT_POINT = 1
LIGHT_ORB = 2


@dataclass
class LightDef:
    name: str = ""
    pos: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rgb: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    radius: float = 0.0
    type: int = 0


def lights_to_soa(lights: List[LightDef]) -> LightsSoA:
    f = lambda g: np.asarray([g(li) for li in lights], dtype=np.float32)  # noqa: E731
    return LightsSoA(
        pos=Vec3(f(lambda li: li.pos[0]), f(lambda li: li.pos[1]), f(lambda li: li.pos[2])),
        rgb=Vec3(f(lambda li: li.rgb[0]), f(lambda li: li.rgb[1]), f(lambda li: li.rgb[2])),
        radius=f(lambda li: li.radius),
        type=np.asarray([li.type for li in lights], dtype=np.int32),
    )


def parse_lights(text: str) -> List[LightDef]:
    lights: List[LightDef] = []
    light = None
    for raw in text.splitlines():
        line = raw.strip()
        if len(line) < 3 or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0]
        try:
            if key == "newlight":
                if len(parts) < 2:
                    Logger.warning("[lights] No name for <newlight>. Ignoring entry.")
                    continue
                if light is not None:
                    lights.append(light)
                light = LightDef(name=parts[1])
            elif light is None:
                continue
            elif key == "type":
                light.type = int(float(parts[1]))
            elif key == "rgb":
                light.rgb = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif key == "pos":
                light.pos = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif key == "radius":
                light.radius = float(parts[1])
        except (IndexError, ValueError):
            Logger.warning(f"[lights] Not enough/invalid parameters for <{key}>. Ignoring attribute.")
    if light is not None:
        lights.append(light)
    Logger.info(f"[lights] Loaded {len(lights)} light(s).")
    return lights


def parse_lights_file(path: str) -> List[LightDef]:
    try:
        with open(path) as fh:
            return parse_lights(fh.read())
    except OSError:
        Logger.warning(f'[lights] Could not open file "{path}". No lights loaded.')
        return []
