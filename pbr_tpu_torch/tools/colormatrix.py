"""Offline XYZ<->RGB color-matrix generator.

Counterpart of the reference's dev tool (``source/tools/colormatrix.py``,
SURVEY.md §2.4 L9), which derived the conversion matrix for several color
systems by hand-expanded 3x3 determinants and printed constants to paste
into the (since-removed) spectral pipeline. Re-designed here around
``numpy.linalg`` and kept as a library + CLI:

- ``rgb_to_xyz_matrix(system)`` / ``xyz_to_rgb_matrix(system)`` return the
  standard colorimetric matrices (white point normalized to Y = 1).
- The reference printed the *unnormalized* inverse (white scaled by its
  chromaticity row sums instead of luminance); that equals the standard
  XYZ->RGB matrix divided by the white point's y — exposed as
  ``legacy_scale`` for byte-compatibility checks against its comments.

The port's copy of ``pbr_tpu/tools/colormatrix.py`` (equal matrices,
tests/test_torch_app.py).

Usage: ``python -m pbr_tpu_torch.tools.colormatrix [NTSC|EBU|SMPTE|HDTV|CIE|Rec709]``.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np

# (xr, yr), (xg, yg), (xb, yb), (xw, yw) chromaticities per color system —
# same systems the reference tool shipped (colormatrix.py:10-16).
ILLUMINANT_C = (0.3101, 0.3162)
ILLUMINANT_D65 = (0.3127, 0.3291)
ILLUMINANT_E = (1.0 / 3.0, 1.0 / 3.0)

COLOR_SYSTEMS: Dict[str, Tuple[Tuple[float, float], ...]] = {
    "NTSC": ((0.67, 0.33), (0.21, 0.71), (0.14, 0.08), ILLUMINANT_C),
    "EBU": ((0.64, 0.33), (0.29, 0.60), (0.15, 0.06), ILLUMINANT_D65),
    "SMPTE": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070), ILLUMINANT_D65),
    "HDTV": ((0.670, 0.330), (0.210, 0.710), (0.150, 0.060), ILLUMINANT_D65),
    "CIE": ((0.7355, 0.2645), (0.2658, 0.7243), (0.1669, 0.0085), ILLUMINANT_E),
    "Rec709": ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06), ILLUMINANT_D65),
}


def _primaries_xyz(system: str) -> Tuple[np.ndarray, np.ndarray]:
    prims = COLOR_SYSTEMS[system]
    cols = []
    for x, y in prims[:3]:
        cols.append([x / y, 1.0, (1.0 - x - y) / y])
    xw, yw = prims[3]
    white = np.array([xw / yw, 1.0, (1.0 - xw - yw) / yw], dtype=np.float64)
    return np.array(cols, dtype=np.float64).T, white  # (3,3) columns=R,G,B


def rgb_to_xyz_matrix(system: str = "Rec709") -> np.ndarray:
    """M such that ``XYZ = M @ RGB``; white (1,1,1) maps to Y = 1."""
    p, white = _primaries_xyz(system)
    scale = np.linalg.solve(p, white)  # per-primary luminance scales
    return p * scale[None, :]


def xyz_to_rgb_matrix(system: str = "Rec709") -> np.ndarray:
    """M such that ``RGB = M @ XYZ`` (inverse of rgb_to_xyz_matrix)."""
    return np.linalg.inv(rgb_to_xyz_matrix(system))


def legacy_scale(system: str = "Rec709") -> float:
    """Factor mapping the standard XYZ->RGB matrix onto the constants the
    reference tool printed (it skipped the white-luminance normalization):
    ``reference_matrix = xyz_to_rgb_matrix(system) / yw``."""
    return 1.0 / COLOR_SYSTEMS[system][3][1]


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    system = args[0] if args else "Rec709"
    if system not in COLOR_SYSTEMS:
        sys.exit(f"unknown color system {system!r}; pick from {sorted(COLOR_SYSTEMS)}")
    m_fwd = rgb_to_xyz_matrix(system)
    m_inv = xyz_to_rgb_matrix(system)
    print(f"# {system}: RGB -> XYZ")
    for row in m_fwd:
        print("  %+.6f %+.6f %+.6f" % tuple(row))
    print(f"# {system}: XYZ -> RGB")
    for row in m_inv:
        print("  %+.6f %+.6f %+.6f" % tuple(row))


if __name__ == "__main__":
    main()
