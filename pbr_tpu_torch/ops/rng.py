"""Counter-based RNG, bitwise-equal to ``pbr_tpu/ops/rng.py``.

Every uniform is a pure function of ``(frame_seed, pixel_id, sample,
bounce, stream)`` through a chain of lowbias32 hashes, so the port draws the
very numbers the JAX package and its NumPy oracle draw — which is what lets
the tests compare renders pixel by pixel.

torch has no right shift and no comparisons on ``uint32``, so the hash runs
in ``int64`` holding values in ``[0, 2**32)``. A 32-bit product is formed
from the constant's two 16-bit halves (``_mul32``): every intermediate stays
below ``2**49``, so no signed product overflows on any device, and the low
32 bits are exact. ``(h >> 8)`` is below ``2**24`` and converts to float32
exactly.
"""

from __future__ import annotations

import torch

# Stream ids — one per distinct random decision in the integrator (the same
# numbering as pbr_tpu/ops/rng.py, which the bitwise parity depends on).
S_AA_R = 0
S_AA_PHI = 1
S_DOF_R = 2
S_DOF_PHI = 3
S_TRANS = 4
S_REFR = 5
S_BRDF_A = 6
S_BRDF_B = 7
S_BRDF_C = 8
S_EXTEND = 9
S_RR = 10

_MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_INV_2_24 = 1.0 / (1 << 24)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in [0, 2**32)."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _MASK


def _as_u32(v):
    """A Python int, or an integer tensor as int64 in [0, 2**32)."""
    if isinstance(v, int):
        return v & _MASK
    return v.to(torch.int64) & _MASK


def lowbias32(x):
    """Integer finalizer hash (public-domain 'lowbias32' constants)."""
    if isinstance(x, int):
        x &= _MASK
        x ^= x >> 16
        x = (x * _M1) & _MASK
        x ^= x >> 15
        x = (x * _M2) & _MASK
        x ^= x >> 16
        return x
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def fold(h, v):
    """Fold a value into a hash state (boost::hash_combine-style)."""
    vg = (v * _GOLDEN) & _MASK if isinstance(v, int) else _mul32(v, _GOLDEN)
    return lowbias32(h ^ vg)


def _to_uniform(h) -> torch.Tensor:
    if isinstance(h, int):
        h = torch.tensor(h, dtype=torch.int64)
    return (h >> 8).to(torch.float32) * _INV_2_24


def uniform(frame_seed, pixel_id, sample, bounce, stream):
    """Uniform float32 in [0, 1) for the given counter coordinates.

    Each argument is a Python int or an integer tensor (they broadcast).
    """
    h = lowbias32(_as_u32(frame_seed))
    for v in (pixel_id, sample, bounce, stream):
        h = fold(h, _as_u32(v))
    return _to_uniform(h)


class BounceRng:
    """Per-(sample, bounce) bound RNG state (see PixelRng.at)."""

    __slots__ = ("_h",)

    def __init__(self, h):
        self._h = h

    def u(self, stream):
        return _to_uniform(fold(self._h, _as_u32(stream)))


class PixelRng:
    """Binds (frame_seed, pixel_id) once; ``frame_seed`` may be a Python int
    or a 0-d integer tensor, ``pixel_id`` an integer tensor."""

    def __init__(self, frame_seed, pixel_id):
        self._base = fold(lowbias32(_as_u32(frame_seed)), _as_u32(pixel_id))

    def u(self, sample, bounce, stream):
        return self.at(sample, bounce).u(stream)

    def at(self, sample, bounce) -> BounceRng:
        """Hoist the shared ``fold(sample); fold(bounce)`` prefix of a
        bounce's draws (bitwise-identical uniforms)."""
        return BounceRng(fold(fold(self._base, _as_u32(sample)), _as_u32(bounce)))

    def gather_rows(self, src, block: int, base=None) -> "PixelRng":
        """A PixelRng for a row-compacted sub-batch: rows of ``block``
        consecutive lanes gathered by row index ``src``. ``base``: those
        rows' keys already gathered (the integrator's stage gather, kernel
        K13 on the card, takes them with the stage's other fields); None
        gathers them here."""
        r = object.__new__(PixelRng)
        r._base = self._base.reshape(-1, block)[src].reshape(-1) if base is None else base
        return r
