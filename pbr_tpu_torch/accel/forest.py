"""BVH forest builder: big scenes partitioned into VMEM-sized sub-BVHs.

The port's copy of ``pbr_tpu/accel/forest.py`` (only the imports differ,
``tests/test_torch_bvh_host.py`` holds the two byte-equal). The TPU
reasons below are why the forest has this shape; on the card it is walked
by kernel K6's seeded instances (``ops/cuda_bvh.py::intersect_bvh_forest``).

The single packet-traversal kernel (ops/pallas_bvh.py) holds its node and
triangle tables resident in VMEM, which caps it at ``PALLAS_BVH_MAX_ROWS``
(rows, 16)-f32 rows ≈ 10k triangles. The reference's answer to big scenes
was one deep GPU BVH (BVH.cpp:1-1177 + pt_bvh.cl:82-123); the TPU answer
here is a *forest*: the main BVH's leaf order (a SAH preorder, hence
spatially compact in contiguous runs) is cut into K chunks of
``FOREST_CHUNK`` faces, each chunk gets its own shallow sub-BVH, and every
sub-tree — nodes AND triangles — fits the proven VMEM kernel. Traversal
(ops/pallas_bvh.py::intersect_bvh_forest) walks all K sub-trees per ray
tile and min-combines; a tile that misses a sub-root AABB exits that walk
after a single node step, so the extra cost over one big tree is ~K root
tests, while every leaf visit stays in VMEM with zero DMA — the structure
this environment's Mosaic actually compiles (docs/PERF.md "Big-scene
intersector status" documents why the DMA-in-while HBM-slab kernel cannot
be used here).

All host-side NumPy; runs once at scene build.
"""

from __future__ import annotations

import numpy as np

from pbr_tpu_torch.accel.bvh import build_bvh
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import BVHForest, LinearBVH, TrianglesSoA
from pbr_tpu_torch.utils.config import BVHConfig

# Faces per chunk. Worst-case sub-tree node count is 2*FOREST_CHUNK - 1
# (all 1-face leaves), and FOREST_CHUNK + (2*FOREST_CHUNK - 1) = 24575
# rows <= PALLAS_BVH_MAX_ROWS (24576): a chunk ALWAYS fits the kernel's
# VMEM row budget, no rebuild-on-overflow path needed.
FOREST_CHUNK = 8192

# Sub-BVH leaf size. The packet kernel unrolls ``max_leaf`` masked
# Möller-Trumbore tests per node step (inner nodes waste them), so bigger
# leaves trade per-step waste for a shallower walk; 4 halves the node count
# of the reference-style 2-face leaves while keeping the per-step waste
# bounded.
FOREST_MAX_LEAF = 4


def _pad_bvh(bvh: LinearBVH, n: int) -> LinearBVH:
    """Pad node arrays to length ``n`` so every sub-BVH shares one shape
    (one compiled kernel serves all chunks).

    Padding nodes carry an inverted AABB (min=+inf, max=-inf) and exit = n.
    The kernel's slab test would flip an inverted box into an unconditional
    hit (min/max(a, b) per axis), so it guards with ``rec[0] <= rec[3]``
    (pallas_bvh.py::_traverse_tile): the first padding node misses, its
    exit = n ends the walk — one wasted step per tile, never a wrong
    result.
    """
    pad = n - bvh.count
    if pad == 0:
        return bvh
    inf = np.full((pad,), np.inf, dtype=np.float32)
    return LinearBVH(
        bb_min=Vec3(*(np.concatenate([c, inf]) for c in bvh.bb_min)),
        bb_max=Vec3(*(np.concatenate([c, -inf]) for c in bvh.bb_max)),
        leaf_first=np.concatenate(
            [bvh.leaf_first, np.full((pad,), -1, dtype=np.int32)]
        ),
        leaf_count=np.concatenate(
            [bvh.leaf_count, np.zeros((pad,), dtype=np.int32)]
        ),
        exit=np.concatenate([bvh.exit, np.full((pad,), n, dtype=np.int32)]),
    )


def build_forest(
    tris: TrianglesSoA,
    chunk: int = FOREST_CHUNK,
    max_faces: int = FOREST_MAX_LEAF,
) -> BVHForest:
    """Build a BVHForest over main-order triangles (already in the main
    BVH's leaf order — scene/build.py permutes before calling).

    Each chunk's sub-BVH build re-permutes the chunk internally; the main
    ``Scene.tris`` stays untouched (the main BVH's leaf ranges remain
    valid) and the forest carries its own forest-ordered geometry copy plus
    ``face_ids`` back-references — ~36 B/face of duplication for a layout
    where every sub-table is kernel-resident.
    """
    v0 = tris.v0.stack(np)
    v1 = (tris.v0 + tris.e1).stack(np)
    v2 = (tris.v0 + tris.e2).stack(np)
    nf = v0.shape[0]
    k = (nf + chunk - 1) // chunk
    cfg = BVHConfig(max_faces=max_faces)

    bvhs = []
    ids = np.zeros((k * chunk,), dtype=np.int32)
    for i in range(k):
        lo = i * chunk
        hi = min(lo + chunk, nf)
        sub = None
        if hi - lo >= 4096:
            try:
                from pbr_tpu_torch.accel.native import build_bvh_native

                sub, order = build_bvh_native(v0[lo:hi], v1[lo:hi], v2[lo:hi], cfg)
            except RuntimeError:
                sub = None
        if sub is None:
            sub, order, _ = build_bvh(v0[lo:hi], v1[lo:hi], v2[lo:hi], cfg)
        bvhs.append(sub)
        ids[lo : lo + (hi - lo)] = lo + np.asarray(order, dtype=np.int32)

    max_nodes = max(b.count for b in bvhs)
    bvhs = tuple(_pad_bvh(b, max_nodes) for b in bvhs)

    def gather_pad(a: np.ndarray) -> np.ndarray:
        out = np.zeros((k * chunk,), dtype=np.float32)
        out[:nf] = a[ids[:nf]]
        return out

    # Forest-ordered geometry; padding slots stay zero rows → degenerate
    # faces (det == 0) that can never win a hit.
    fv0 = Vec3(*(gather_pad(v0[:, c]) for c in range(3)))
    fe1 = Vec3(*(gather_pad((v1 - v0)[:, c]) for c in range(3)))
    fe2 = Vec3(*(gather_pad((v2 - v0)[:, c]) for c in range(3)))
    return BVHForest(bvhs=bvhs, v0=fv0, e1=fe1, e2=fe2, face_ids=ids)
