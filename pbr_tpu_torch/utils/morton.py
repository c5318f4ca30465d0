"""Morton (Z-curve) pixel→lane ordering.

The integrator is layout-agnostic (`pixel_ids` maps lanes to pixels; RNG,
AA jitter, and the accumulator are all id-keyed), but two subsystems key on
LANE adjacency:

- row compaction gathers blocks of ``compact_block`` consecutive lanes
  (models/integrator.py): with scanline order a 128-lane block is a 128x1
  pixel strip, and on object-against-sky scenes (suzanne, soups) the
  survivors of bounce 1+ are scattered enough that nearly every strip
  stays live (measured row-live ~1.0 through bounce 4 on suzanne while
  lane-live is ~0.3) — compaction never engages;
- the cull stages frustum-group consecutive lanes (ops/cull.py): a strip's
  origin box is long and thin.

Morton order makes ``2^k``-lane blocks square-ish pixel PATCHES (a
128-lane block = 16x8 pixels): spatially-clustered deaths empty whole
blocks, and bounce-ray origin boxes per group shrink. One host-side
permutation at tracer construction; per-frame cost zero (the lanes→pixels
scatter at display time replaces a reshape).

The reference had no analog — its GPU work-items were scanline-indexed
(pathtracing.cl:241-249) because per-thread divergence, not per-block
occupancy, governed its cost model.
"""

from __future__ import annotations

import numpy as np


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread 16 bits over 32 (Morton interleave helper)."""
    x = x.astype(np.uint32) & np.uint32(0xFFFF)
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


def morton_pixel_ids(width: int, height: int) -> np.ndarray:
    """Permutation of ``arange(width*height)`` in Z-curve order.

    Works for any (non-power-of-two) frame: codes are computed for the
    actual pixel coordinates and stably argsorted, so the result is always
    a true permutation of exactly the frame's pixels.
    """
    ys, xs = np.mgrid[0:height, 0:width]
    code = _part1by1(xs) | (_part1by1(ys) << np.uint32(1))
    ids = (ys * width + xs).reshape(-1)
    order = np.argsort(code.reshape(-1), kind="stable")
    return ids[order].astype(np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv
