"""Face-cluster build for the cull-and-sweep intersector (ops/pallas_cull.py).

The TPU-native replacement for deep per-ray BVH traversal
(pt_bvh.cl:82-123): instead of walking a tree with data-dependent control
flow (which a TPU serializes into one scalar cursor per ray *tile* — the
measured reason the packet kernel loses to brute force everywhere it fits,
docs/PERF.md), the scene is cut into spatially-compact *clusters* of
``size`` faces — contiguous runs of the main BVH's leaf order, which is a
SAH preorder — and intersection becomes two dense stages:

1. **cull** (ops/cull.py, plain XLA): a conservative interval-frustum test
   of every ray tile against every cluster AABB — one (T, C) vectorized
   slab test, no serial walk — selecting each tile's candidate clusters;
2. **sweep** (ops/pallas_cull.py): a Pallas kernel that tests only the
   candidate clusters, with each cluster's Möller-Trumbore coefficient
   block streamed from HBM by the Pallas pipeline (scalar-prefetch-driven
   block indexing — no manual DMA, no VMEM residency cap on scene size)
   and the ray x face cross product evaluated as thin-K MXU matmuls in the
   hoisted linear form (ops/pallas_intersect.py::_sweep_lin).

Host-side NumPy; runs once at scene build.

Coefficient layout (the kernel contract)
----------------------------------------
Per cluster, one ``(K_ROWS, 4*size)`` f32 block, face ``j`` in lane ``j``
of each of the four ``size``-lane output groups ``[det | tnum | unum |
vnum]``. Contracted against the per-ray feature vector
``R = [o, d, c=o x d, 1]`` (rows 0-9 of K_ROWS=16; rest zero) it yields
exactly ``_sweep_lin``'s quantities:

    det  =  d.m                      m  = e2 x e1
    tnum =  km - o.m                 km = v0.m
    unum =  c.e2 - d.w               w  = e2 x v0
    vnum = -c.e1 - d.q               q  = v0 x e1

then t/u/v = num / det with the standard validity gates. Zero-padded faces
have det = 0 -> t = NaN -> never valid.
"""

from __future__ import annotations

import numpy as np

from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import ClusterSet, TrianglesSoA

# Rows of the coefficient block / ray feature vector (f32 sublane tile = 8;
# 16 leaves room for the shadow-ray t_limit row and future features).
K_ROWS = 16

# Ray-feature row indices (shared with ops/pallas_cull.py / ops/cull.py).
R_O = 0  # rows 0-2: ray origin
R_D = 3  # rows 3-5: ray direction
R_C = 6  # rows 6-8: o x d (Pluecker moment)
R_ONE = 9  # row 9: constant 1
R_TLIM = 10  # row 10: shadow-ray t_limit (any-hit variant only)
# Coefficient-block row 11, lanes 0-5: the cluster's own AABB
# [min.xyz, max.xyz] — the sweep kernel's per-step box gate reads it as
# static-lane scalars. Ray-feature row 11 is zero, so the extra data
# cannot perturb the matmul.
R_BB = 11

# Fine clusters per supercluster. The cull stage enumerates and orders
# only SUPERclusters ((T, C/SUPER) work — the (T, C) argsort was measured
# to dominate the whole intersect at 100k faces); fine candidates expand
# arithmetically and the kernel box-gates each fine cluster itself.
SUPER = 16

# Row-sweep (ops/pallas_sweep.py) lin-cluster face count: one full f32 lane
# row, so every vector op in the VPU-form kernel runs at native width with
# zero lane padding. Independent of the fine ``size`` above.
LIN_SIZE = 128

# Rows of the lin coefficient block: the 16 hoisted linear-form constants
# (_lin_table order, ops/pallas_intersect.py): m(3), km, w(3), q(3), e1(3),
# e2(3).
LIN_ROWS = 16


def build_clusters(
    tris: TrianglesSoA, size: int = 128, face_min=None, face_max=None
) -> ClusterSet:
    """Build a ClusterSet over main-order triangles (already in BVH leaf
    order — scene/build.py permutes before calling).

    ``size`` must be a multiple of 32 so the 4*size-lane coefficient blocks
    stay 128-lane aligned. ``face_min``/``face_max`` ((F, 3) arrays):
    optional per-face AABB override — Phong-tessellation scenes pass
    curved-patch-inflated bounds (ops/phongtess.py::phongtess_face_aabbs)
    so cluster/super AABBs stay conservative for the patches.
    """
    if size % 32:
        raise ValueError(f"cluster size must be a multiple of 32, got {size}")
    v0 = tris.v0.stack(np).astype(np.float32)
    e1 = tris.e1.stack(np).astype(np.float32)
    e2 = tris.e2.stack(np).astype(np.float32)
    nf = v0.shape[0]
    c = max(1, (nf + size - 1) // size)
    # Pad the cluster count to a SUPER multiple so superclusters tile it
    # exactly; padding clusters are all-zero (det = 0) with inverted AABBs
    # (the kernel's box gate rejects them).
    c = -(-c // SUPER) * SUPER
    pad = c * size - nf
    if pad:
        z = np.zeros((pad, 3), dtype=np.float32)
        v0p, e1p, e2p = (np.concatenate([a, z]) for a in (v0, e1, e2))
    else:
        v0p, e1p, e2p = v0, e1, e2

    # Per-face linear-form constants (see module docstring).
    m = np.cross(e2p, e1p)
    km = np.einsum("fi,fi->f", v0p, m)
    w = np.cross(e2p, v0p)
    q = np.cross(v0p, e1p)

    coeffs = np.zeros((c, K_ROWS, 4 * size), dtype=np.float32)

    def put(group, row, vals):
        coeffs[:, row, group * size : (group + 1) * size] = vals.reshape(c, size)

    for ax in range(3):
        put(0, R_D + ax, m[:, ax])  # det  = d.m
        put(1, R_O + ax, -m[:, ax])  # tnum = km - o.m
        put(2, R_C + ax, e2p[:, ax])  # unum = c.e2 - d.w
        put(2, R_D + ax, -w[:, ax])
        put(3, R_C + ax, -e1p[:, ax])  # vnum = -c.e1 - d.q
        put(3, R_D + ax, -q[:, ax])
    put(1, R_ONE, km)
    # Padding faces need no special guard: their m and km are both zero, so
    # det = 0 and t = 0 * inf = NaN — never valid.

    # Cluster AABBs over member-face vertices; padded faces are excluded by
    # construction (v0 = 0 rows would otherwise drag AABBs to the origin).
    # Padding clusters keep inverted boxes (min=+inf > max=-inf): the cull
    # stage and the kernel's box gate both reject them explicitly.
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (nf, 3, 3)
    f_min = face_min if face_min is not None else verts.min(axis=1)
    f_max = face_max if face_max is not None else verts.max(axis=1)
    bb_min = np.full((c, 3), np.inf, dtype=np.float32)
    bb_max = np.full((c, 3), -np.inf, dtype=np.float32)
    for i in range(c):
        lo, hi = i * size, min((i + 1) * size, nf)
        if hi > lo:
            bb_min[i] = f_min[lo:hi].min(axis=0)
            bb_max[i] = f_max[lo:hi].max(axis=0)
    # Kernel-readable AABB: coefficient row R_BB, lanes 0-5.
    coeffs[:, R_BB, 0:3] = bb_min
    coeffs[:, R_BB, 3:6] = bb_max

    # Supercluster AABBs (the cull stage's test/order targets).
    c2 = c // SUPER
    s_min = bb_min.reshape(c2, SUPER, 3).min(axis=1)
    s_max = bb_max.reshape(c2, SUPER, 3).max(axis=1)

    # --- Row-sweep (VPU-form) lin tables --------------------------------
    # Lin clusters are fixed LIN_SIZE-face contiguous runs of the same
    # leaf-order face array. Each supercluster covers exactly
    # lps = SUPER*size/LIN_SIZE of them, so the cull stage's supercluster
    # ordering serves both kernel families; the lin count is padded to a
    # multiple of lps (padding blocks are all-zero -> det 0 -> never valid,
    # with inverted AABBs the frustum test rejects).
    lps = max(1, (SUPER * size) // LIN_SIZE)
    cl = -(-max(1, -(-nf // LIN_SIZE)) // lps) * lps
    pad_l = cl * LIN_SIZE - nf
    if pad_l:
        z = np.zeros((pad_l, 3), dtype=np.float32)
        v0l, e1l, e2l = (np.concatenate([a, z]) for a in (v0, e1, e2))
    else:
        v0l, e1l, e2l = v0, e1, e2
    ml = np.cross(e2l, e1l)
    kml = np.einsum("fi,fi->f", v0l, ml)
    wl = np.cross(e2l, v0l)
    ql = np.cross(v0l, e1l)
    lin = np.zeros((cl, LIN_ROWS, LIN_SIZE), dtype=np.float32)

    def putl(row, vals):
        lin[:, row, :] = vals.reshape(cl, LIN_SIZE)

    for ax in range(3):
        putl(0 + ax, ml[:, ax])
        putl(4 + ax, wl[:, ax])
        putl(7 + ax, ql[:, ax])
        putl(10 + ax, e1l[:, ax])
        putl(13 + ax, e2l[:, ax])
    putl(3, kml)

    lbb_min = np.full((cl, 3), np.inf, dtype=np.float32)
    lbb_max = np.full((cl, 3), -np.inf, dtype=np.float32)
    for i in range(cl):
        lo, hi = i * LIN_SIZE, min((i + 1) * LIN_SIZE, nf)
        if hi > lo:
            lbb_min[i] = f_min[lo:hi].min(axis=0)
            lbb_max[i] = f_max[lo:hi].max(axis=0)

    scene_min = f_min.min(axis=0).astype(np.float32)
    scene_max = f_max.max(axis=0).astype(np.float32)
    # Both cluster families tile the same supercluster grid exactly
    # (ceil(ceil(n/a)/b) == ceil(n/(a*b))).
    assert cl == c2 * lps, (cl, c2, lps)
    return ClusterSet(
        bb_min=Vec3(*(bb_min[:, i].copy() for i in range(3))),
        bb_max=Vec3(*(bb_max[:, i].copy() for i in range(3))),
        coeffs=coeffs,
        scene_min=Vec3(*(scene_min[i] for i in range(3))),
        scene_max=Vec3(*(scene_max[i] for i in range(3))),
        sup_min=Vec3(*(s_min[:, i].copy() for i in range(3))),
        sup_max=Vec3(*(s_max[:, i].copy() for i in range(3))),
        lin=lin,
        lbb_min=Vec3(*(lbb_min[:, i].copy() for i in range(3))),
        lbb_max=Vec3(*(lbb_max[:, i].copy() for i in range(3))),
    )
