"""Host-side SAH BVH builder → stackless linear layout.

Reproduces the reference builder's capabilities (``source/accelstructures/
BVH.{h,cpp}``, 1,177 LoC): binary BVH with **full-sweep surface-area
heuristic** splits (sort by centroid per axis, prefix/suffix surface-area
sweeps, cost = SA_L·N_L + SA_R·N_R — BVH.cpp:502-553,807-851) falling back to
**mean-split** with a 50:50 median fallback for nodes above
``sah_faces_limit`` (BVH.cpp:255-272,862-935), small leaves
(``max_faces``, BVH.cpp:759-763), the larger-surface-area child ordered first
(BVH.cpp:318-352 combineNodes), and **worst-case traversal-order
linearization with escape indices** (BVH.cpp:671-729 orderNodesByTraversal →
the stackless encoding consumed by pt_bvh.cl:93-102).

Differences by design (TPU-first, see SURVEY.md §7):

- vectorized NumPy instead of per-node C++ recursion over glm vec3s; a
  native C++ builder with the same contract lives in ``csrc/`` for large
  scenes (``pbr_tpu_torch.accel.native``);
- typed int32 fields instead of float-punned ``.w`` slots;
- leaves may hold up to ``max_faces`` (not hard-capped at 2), since the
  SoA leaf encoding stores (first, count) rather than two ``.w`` puns;
- one global tree over all objects rather than per-object subtrees merged by
  mean split (BVH.cpp:203-245): a single SAH build over the whole face set
  produces a strictly better tree and identical traversal semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import LinearBVH
from pbr_tpu_torch.utils.config import BVHConfig
from pbr_tpu_torch.utils.log import Logger, Timer


@dataclass
class BuildStats:
    num_nodes: int = 0
    num_leaves: int = 0
    max_depth: int = 0
    build_ms: float = 0.0
    num_skipped: int = 0  # inner left children elided by skip-ahead


class _Node:
    __slots__ = (
        "bb_min", "bb_max", "faces", "left", "right", "depth", "size",
        "skip", "esize",
    )

    def __init__(self, bb_min, bb_max, faces, depth):
        self.bb_min = bb_min
        self.bb_max = bb_max
        self.faces = faces  # np.ndarray of face ids for leaves, else None
        self.left = None
        self.right = None
        self.depth = depth
        self.size = 1  # subtree node count, filled after children exist
        self.skip = False  # elide this node's record from the linear stream
        self.esize = 1  # emitted subtree size (records actually serialized)


def _surface_area(bb_min: np.ndarray, bb_max: np.ndarray) -> np.ndarray:
    """AABB surface area (reference MathHelp::getSurfaceArea,
    MathHelp.cpp:95-101). Works on (..., 3) arrays."""
    d = bb_max - bb_min
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 0] * d[..., 2])


def _sweep_sah(
    fmin: np.ndarray, fmax: np.ndarray, order: np.ndarray
) -> tuple:
    """Full-sweep SAH along one pre-sorted axis.

    Returns (best_cost, best_split) where the left side takes
    ``order[:best_split]``. Prefix/suffix running AABBs vectorized via
    np.minimum/maximum.accumulate (the reference's growAABBsForSAH,
    BVH.cpp:502-553).
    """
    n = order.shape[0]
    mn = fmin[order]
    mx = fmax[order]
    # Left prefix AABBs for splits 1..n-1
    lmin = np.minimum.accumulate(mn, axis=0)[: n - 1]
    lmax = np.maximum.accumulate(mx, axis=0)[: n - 1]
    # Right suffix AABBs for splits 1..n-1
    rmin = np.minimum.accumulate(mn[::-1], axis=0)[::-1][1:]
    rmax = np.maximum.accumulate(mx[::-1], axis=0)[::-1][1:]
    counts_l = np.arange(1, n, dtype=np.float64)
    counts_r = np.arange(n - 1, 0, -1, dtype=np.float64)
    cost = _surface_area(lmin, lmax) * counts_l + _surface_area(rmin, rmax) * counts_r
    i = int(np.argmin(cost))
    return float(cost[i]), i + 1


def build_bvh(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, cfg: BVHConfig = BVHConfig(),
    face_min: np.ndarray = None, face_max: np.ndarray = None,
) -> tuple:
    """Build a linear BVH over triangles given by vertex arrays (F, 3) each.

    Returns ``(LinearBVH, leaf_order, BuildStats)`` where ``leaf_order`` is
    the permutation putting triangles into leaf order
    (``tris_leaf = permute_triangles(tris, leaf_order)``).

    ``face_min``/``face_max`` (F, 3) override the per-face AABBs — used for
    Phong tessellation, where curved-patch leaves must be inflated by
    thickness + sidedrop so the patch never escapes its box (the analog of
    the reference building its tree from triCalcAABB's inflated bounds,
    MathHelp.cpp:250-310; see ``ops.phongtess.phongtess_face_aabbs``).
    """
    t = Timer()
    v0 = np.asarray(v0, dtype=np.float32)
    v1 = np.asarray(v1, dtype=np.float32)
    v2 = np.asarray(v2, dtype=np.float32)
    nf = v0.shape[0]
    if nf == 0:
        raise ValueError("build_bvh: empty triangle set")

    if face_min is not None:
        fmin = np.asarray(face_min, dtype=np.float32)
        fmax = np.asarray(face_max, dtype=np.float32)
    else:
        fmin = np.minimum(np.minimum(v0, v1), v2)
        fmax = np.maximum(np.maximum(v0, v1), v2)
    # Conservative epsilon padding (absolute + relative): the Möller-Trumbore
    # acceptance region computed in f32 can exceed the exact triangle bounds
    # by ULPs, and rays lying exactly in a face plane probe the box surface
    # itself. Padding keeps traversal a strict superset of brute force (the
    # equivalence the tests assert bitwise); it also removes zero-extent
    # axes. The reference instead relied on its closeOrigin shift + OpenCL
    # NaN semantics and could drop such hits (pt_intersect.cl:96-97).
    pad = np.float32(1e-6) + np.float32(1e-5) * np.maximum(np.abs(fmin), np.abs(fmax))
    fmin = fmin - pad
    fmax = fmax + pad
    centroid = (fmin + fmax) * 0.5

    max_faces = max(1, int(cfg.max_faces))
    stats = BuildStats()

    def make_node(face_ids: np.ndarray, depth: int) -> _Node:
        bb_min = fmin[face_ids].min(axis=0)
        bb_max = fmax[face_ids].max(axis=0)
        node = _Node(bb_min, bb_max, None, depth)
        stats.max_depth = max(stats.max_depth, depth)

        n = face_ids.shape[0]
        if n <= max_faces:
            node.faces = face_ids
            stats.num_leaves += 1
            return node

        split_sets = None
        if n <= cfg.sah_faces_limit:
            # Full-sweep SAH on all three axes (BVH.cpp:283-316,807-851).
            best = None
            for axis in range(3):
                order = face_ids[np.argsort(centroid[face_ids, axis], kind="stable")]
                cost, split = _sweep_sah(fmin, fmax, order)
                if best is None or cost < best[0]:
                    best = (cost, order, split)
            _, order, split = best
            split_sets = (order[:split], order[split:])
        else:
            # Mean split on the longest-extent winner of all three axes
            # (BVH.cpp:255-272 buildWithMeanSplit / splitFaces).
            best = None
            for axis in range(3):
                mid = 0.5 * (bb_min[axis] + bb_max[axis])
                go_left = centroid[face_ids, axis] < mid
                nl = int(go_left.sum())
                if nl == 0 or nl == n:
                    continue
                # Score = SAH of the induced split, cheap version.
                l_ids = face_ids[go_left]
                r_ids = face_ids[~go_left]
                sa_l = _surface_area(fmin[l_ids].min(0), fmax[l_ids].max(0))
                sa_r = _surface_area(fmin[r_ids].min(0), fmax[r_ids].max(0))
                # f64 cost accumulation (the native builder mirrors this).
                cost = np.float64(sa_l) * nl + np.float64(sa_r) * (n - nl)
                if best is None or cost < best[0]:
                    best = (cost, l_ids, r_ids)
            if best is None:
                # All centroids identical: 50:50 fallback (BVH.cpp:923-932).
                half = n // 2
                split_sets = (face_ids[:half], face_ids[half:])
            else:
                split_sets = (best[1], best[2])

        left_ids, right_ids = split_sets
        left = make_node(left_ids, depth + 1)
        right = make_node(right_ids, depth + 1)
        # Larger-surface-area child first (BVH.cpp:318-352): it is likelier
        # to be hit, and first-in-memory is the "descend" direction.
        sa_left = _surface_area(left.bb_min, left.bb_max)
        sa_right = _surface_area(right.bb_min, right.bb_max)
        if sa_right > sa_left:
            left, right = right, left
        node.left, node.right = left, right
        node.size = 1 + left.size + right.size
        # Skip-ahead (reference BVH::skipAheadOfNodes, BVH.cpp:770-795 +
        # serialization-time elision, PathTracer.cpp:250-257,271-273): an
        # *inner* left child whose surface area is >= ``skip_ahead_compare``
        # of this node's is elided from the linear stream — its AABB test
        # would almost always repeat the parent's verdict, so the "hit ⇒
        # next in memory" descent lands directly on its own left child.
        if cfg.skip_ahead and left.faces is None:
            sa_node = _surface_area(node.bb_min, node.bb_max)
            sa_first = _surface_area(left.bb_min, left.bb_max)
            if sa_node > 0.0 and sa_first / sa_node >= cfg.skip_ahead_compare:
                left.skip = True
                stats.num_skipped += 1
        contrib_l = left.esize - (1 if left.skip else 0)
        node.esize = 1 + contrib_l + right.esize
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10_000))
    try:
        root = make_node(np.arange(nf, dtype=np.int64), 0)
    finally:
        sys.setrecursionlimit(old_limit)

    # ---- preorder linearization with escape indices --------------------
    # (the reference's orderNodesByTraversal + right-sibling escape
    # computation, BVH.cpp:671-729 / PathTracer.cpp:278-307; skip-marked
    # left children are elided here exactly as the reference's serializer
    # drops them, PathTracer.cpp:253-257)
    total = root.esize
    bb_min = np.zeros((total, 3), dtype=np.float32)
    bb_max = np.zeros((total, 3), dtype=np.float32)
    leaf_first = np.full((total,), -1, dtype=np.int32)
    leaf_count = np.zeros((total,), dtype=np.int32)
    exit_idx = np.zeros((total,), dtype=np.int32)
    leaf_order: list = []

    # Iterative preorder DFS carrying each subtree's escape index. An
    # elided node emits no record of its own; its children take its place
    # (the left one inherits the current position, the right one the
    # elided node's escape), so ``i`` does not advance for it.
    stack = [(root, total, False)]
    i = 0
    while stack:
        node, escape, elide = stack.pop()
        if not elide:
            bb_min[i] = node.bb_min
            bb_max[i] = node.bb_max
            exit_idx[i] = escape
            if node.faces is not None:
                leaf_first[i] = len(leaf_order)
                leaf_count[i] = node.faces.shape[0]
                leaf_order.extend(node.faces.tolist())
                i += 1
                continue
            i += 1
        left, right = node.left, node.right
        right_start = i + left.esize - (1 if left.skip else 0)
        stack.append((right, escape, False))
        stack.append((left, right_start, left.skip))
    assert i == total

    stats.num_nodes = total
    stats.build_ms = t.ms()
    Logger.debug(
        f"[bvh] Built BVH: {stats.num_nodes} nodes, {stats.num_leaves} leaves, "
        f"max depth {stats.max_depth}, {stats.build_ms:.1f} ms."
        + (
            f" Skip-ahead elided {stats.num_skipped} left child nodes."
            if cfg.skip_ahead
            else ""
        )
    )

    lin = LinearBVH(
        bb_min=Vec3.from_array(bb_min),
        bb_max=Vec3.from_array(bb_max),
        leaf_first=leaf_first,
        leaf_count=leaf_count,
        exit=exit_idx,
    )
    return lin, np.asarray(leaf_order, dtype=np.int64), stats
