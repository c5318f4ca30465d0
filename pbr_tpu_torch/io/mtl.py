"""Wavefront MTL parser with the reference's custom extensions.

Reference: ``source/MtlParser.{h,cpp}``. Standard keys ``newmtl / d / Tr /
illum / Ka / Kd / Ks / Ni / Ns`` plus the custom keys ``light`` (emissive
flag), Schlick ``rough`` / ``p``, and Shirley-Ashikhmin ``nu / nv / Rs / Rd``
(MtlParser.cpp:66-225). Defaults mirror getEmptyMaterial
(MtlParser.cpp:11-35): white Ka/Kd/Ks, Ns=100, Ni=1, d=1, illum=2, light=0,
rough=1, p=1, nu=nv=0, Rs=0, Rd=1.

Reference quirks preserved on purpose (golden-parity matters more than
robustness): ``Tr`` only applies if ``d`` was never set in the whole file
(MtlParser.cpp:102 — the flag is file-global, not per-material); lines
shorter than 3 chars are skipped; out-of-range illum values reset to 2.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import MaterialsSoA
from pbr_tpu_torch.utils.log import Logger


@dataclass
class MaterialDef:
    name: str = ""
    Ka: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    Kd: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    Ks: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    Ns: float = 100.0
    Ni: float = 1.0
    d: float = 1.0
    illum: int = 2
    light: int = 0
    rough: float = 1.0
    p: float = 1.0
    nu: float = 0.0
    nv: float = 0.0
    Rs: float = 0.0
    Rd: float = 1.0


@dataclass
class MtlLibrary:
    materials: List[MaterialDef] = field(default_factory=list)

    @property
    def names(self) -> List[str]:
        return [m.name for m in self.materials]

    def index_of(self, name: str) -> int:
        """Material index by name; -1 if unknown (ObjParser.cpp:205-207)."""
        try:
            return self.names.index(name)
        except ValueError:
            return -1

    def find(self, name: str) -> Optional[MaterialDef]:
        i = self.index_of(name)
        return self.materials[i] if i >= 0 else None

    def sky_light(self) -> Optional[Tuple[float, float, float]]:
        """Kd of the magic ``sky_light`` material, if present — the reference
        baked it into the kernel as SKY_LIGHT (PathTracer.cpp:468-474)."""
        m = self.find("sky_light")
        return m.Kd if m is not None else None

    def to_soa(self) -> MaterialsSoA:
        """Pack into the renderer's SoA arrays (PathTracer.cpp:448-518)."""
        mats = self.materials or [MaterialDef()]
        f = lambda g: np.asarray([g(m) for m in mats], dtype=np.float32)  # noqa: E731
        v = lambda g: Vec3(  # noqa: E731
            f(lambda m: g(m)[0]), f(lambda m: g(m)[1]), f(lambda m: g(m)[2])
        )
        return MaterialsSoA(
            d=f(lambda m: m.d),
            Ni=f(lambda m: m.Ni),
            rough=f(lambda m: m.rough),
            p=f(lambda m: m.p),
            nu=f(lambda m: m.nu),
            nv=f(lambda m: m.nv),
            Rs=f(lambda m: m.Rs),
            Rd=f(lambda m: m.Rd),
            kd=v(lambda m: m.Kd),
            ks=v(lambda m: m.Ks),
            light=np.asarray([m.light for m in mats], dtype=np.int32),
        )


def parse_mtl(text: str) -> MtlLibrary:
    lib = MtlLibrary()
    mtl: Optional[MaterialDef] = None
    transparency_was_set = False  # file-global, like the reference's flag

    def _f3(parts):
        return (float(parts[1]), float(parts[2]), float(parts[3]))

    for raw in text.splitlines():
        line = raw.strip()
        if len(line) < 3 or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0]
        try:
            if key == "newmtl":
                if len(parts) < 2:
                    Logger.warning("[mtl] No name for <newmtl>. Ignoring entry.")
                    continue
                if mtl is not None:
                    lib.materials.append(mtl)
                mtl = MaterialDef(name=parts[1])
            elif mtl is None:
                continue
            elif key == "d":
                mtl.d = float(parts[1])
                transparency_was_set = True
            elif key == "Tr" and not transparency_was_set:
                mtl.d = 1.0 - float(parts[1])
            elif key == "illum":
                illum = int(float(parts[1]))
                mtl.illum = illum if 0 <= illum <= 10 else 2
            elif key == "Ka":
                mtl.Ka = _f3(parts)
            elif key == "Kd":
                mtl.Kd = _f3(parts)
            elif key == "Ks":
                mtl.Ks = _f3(parts)
            elif key == "Ni":
                mtl.Ni = float(parts[1])
            elif key == "Ns":
                mtl.Ns = float(parts[1])
            elif key == "light":
                mtl.light = int(float(parts[1]))
            elif key == "rough":
                mtl.rough = float(parts[1])
            elif key == "p":
                mtl.p = float(parts[1])
            elif key == "nu":
                mtl.nu = float(parts[1])
            elif key == "nv":
                mtl.nv = float(parts[1])
            elif key == "Rs":
                mtl.Rs = float(parts[1])
            elif key == "Rd":
                mtl.Rd = float(parts[1])
        except (IndexError, ValueError):
            Logger.warning(f"[mtl] Not enough/invalid parameters for <{key}>. Ignoring attribute.")
    if mtl is not None:
        lib.materials.append(mtl)
    Logger.info(f"[mtl] Loaded {len(lib.materials)} material(s).")
    return lib


def parse_mtl_file(path: str) -> MtlLibrary:
    try:
        with open(path) as fh:
            return parse_mtl(fh.read())
    except OSError:
        Logger.warning(f'[mtl] Could not open file "{path}". No materials loaded.')
        return MtlLibrary()
