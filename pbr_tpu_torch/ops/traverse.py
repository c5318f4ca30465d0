"""Scene intersection: the sweeps, the BVH walks, and their dispatch.

The counterpart of ``pbr_tpu/ops/traverse.py`` for the intersectors the
port has so far:

- ``intersect_brute``: the plain all-faces sweep in torch ops (any device);
- ``intersect_bvh`` and ``intersect_bvh_chunked``: the per-ray stackless
  BVH walk in torch ops (kernel K8's plain version,
  ``ops/cuda_bvh.py::walk_plain``), with the exact ``tests``/``visits``
  counters; the chunked form sorts the rays and walks them a chunk at a
  time, bitwise equal to the unchunked walk;
- ``intersect_scene``: the dispatch the integrator calls, with the JAX
  version's contract (detached search, differentiable re-evaluation of the
  winner, fused NEE leg, ``alive`` mask, ``(tests, visits)`` counters);
  ``occluded_scene`` is its any-hit form, the shadow leg of the modes
  without a fused one.
  Modes: ``pallas`` is kernel K1 (``ops/cuda_intersect.py``); ``gated`` is
  kernel K3 (``ops/cuda_gated.py``) over the scene's cluster verdicts;
  ``cull`` is kernel K4 (more than 48 clusters) or K4m
  (``ops/cuda_cull.py``) over the scene's candidate lists; ``sweep`` is
  kernel K5 (more than 48 lin clusters) or K5m (``ops/cuda_sweep.py``)
  over the per-row lists and verdict words; ``bvh`` is
  kernel K8, ``pallas_bvh`` kernel K6, ``pallas_bvh_forest`` K6's seeded
  chain over the scene's forest and ``pallas_bvh_hbm`` kernel K7
  (``ops/cuda_bvh.py``); ``brute`` is the plain sweep for CPU tensors only
  (on a card the sweep is K1); ``gemm`` is the sweep as one matrix
  product a chunk of rays (``ops/gemm_intersect.py``: ``torch.matmul`` in
  full float32 on either device, no kernel of the port's own). On a CPU
  tensor every kernel's wrapper runs its plain version.
- ``auto`` is the H100's measured policy (``AUTO_BANDS``, from the band
  table ``docs/BAND_TABLE_H100.json``), the same on either device so that
  the CPU runs the algorithm the card runs: a scene with clusters takes K1
  up to 1,025 faces, ``gated`` up to 12,288 and ``bvh`` (K8) above; a
  scene without clusters takes K1 up to 10,000 faces and above it the
  forest where it has one, else ``bvh`` where it has a BVH, else K1. On a
  CPU tensor K1 is the plain sweep. ``auto`` never picks ``cull``,
  ``sweep``, ``gemm`` or the packet walks: each stays an explicit mode.
- The tree walks test at most ``max_leaf`` faces of a leaf; the dispatch
  and every walk take the tree's own bound where the caller gives none
  (``leaf_bound``, from ``ops/cuda_bvh.py``), and a bound below the tree's
  largest leaf raises.
"""

from __future__ import annotations

import torch

from pbr_tpu_torch.accel.forest import FOREST_MAX_LEAF
from pbr_tpu_torch.ops import cuda_bvh, cuda_cull, cuda_gated, cuda_intersect, cuda_sweep
from pbr_tpu_torch.ops.cuda_bvh import leaf_bound
from pbr_tpu_torch.ops.cull import coherence_keys
from pbr_tpu_torch.ops.gemm_intersect import intersect_gemm
from pbr_tpu_torch.ops.intersect import INF, gather_vec3, moller_trumbore
from pbr_tpu_torch.ops.vec import Vec3

_TREE_MODES = ("bvh", "pallas_bvh", "pallas_bvh_forest", "pallas_bvh_hbm")

# The bands of ``auto``: per class of scene ("clusters": the scene has a
# ClusterSet; "plain": it has none), (largest face count or None, mode)
# in rising face count; "tree" walks the forest where the scene has one,
# else its BVH (K8), else K1. They are band_policy of the H100's band
# table, docs/BAND_TABLE_H100.json (pbr_tpu_torch/tools/band_table.py;
# NVIDIA H100 80GB HBM3 at 700 W; a mode takes a row where it beats the
# incumbent in all 3 rounds on ms/frame, device ms and ms/step), and
# tests/test_torch_band_policy.py holds them equal.
AUTO_BANDS = {
    "clusters": (
        # K1 beats K3 on soup:1025 in every round; the rounds disagree on
        # multiroom:3,3,10 (1,428 faces), so K3 holds from there.
        (1_025, "pallas"),
        # K3 holds soup:12288 (the rounds disagree); K8 beats K4 on every
        # row above: soup:12289 to soup:100000 and multiroom:6,6,30 to
        # 10,10,40.
        (12_288, "gated"),
        (None, "bvh"),
    ),
    "plain": (
        # No cluster-less row lies between Cornell (34 faces: K1) and
        # soup:10001 without clusters, where K8 beats K1 in every round and
        # holds against K6 and K7 (the rounds disagree): the edge stays
        # where it was.
        (10_000, "pallas"),
        (None, "tree"),
    ),
}
# Rays a chunk of intersect_bvh_chunked (pbr_tpu/ops/traverse.py:170).
BVH_CHUNK = 8_192


def detach_tris(tris):
    """The triangle SoA with every tensor detached from autograd."""
    return type(tris)(*(f.detach() for f in tris))


def intersect_brute(o: Vec3, d: Vec3, tris):
    """Nearest hit over all triangles, in plain torch ops.

    Rays are (B,), triangles (F,). Returns ``(t, face)`` with t = +inf and
    face = -1 on a miss; the first face in memory order wins ties."""
    return cuda_intersect.intersect_fused_plain(o, d, cuda_intersect.face_table(tris))


def intersect_bvh(o: Vec3, d: Vec3, bvh, tris, max_leaf=None, with_counts: bool = False):
    """Nearest hit via the stackless linear BVH, in torch ops
    (``pbr_tpu.ops.traverse.intersect_bvh``; kernel K8's plain version).

    ``bvh``: a ``BVHTables``; ``max_leaf``: the faces a leaf may hold
    (``leaf_bound``: None takes the tree's own, a bound below its largest
    leaf raises).
    Returns ``(t, face)``, or ``(t, face, tests, visits)``: the exact
    per-ray int32 counters of ray-face tests and node steps (the
    reference's debug channels, pt_bvh.cl:23 and :89)."""
    t, face, _, tests, visits = cuda_bvh.walk_plain(o, d, bvh, cuda_intersect.face_table(tris),
                                                    leaf_bound(bvh, max_leaf))
    return (t, face, tests, visits) if with_counts else (t, face)


def intersect_bvh_chunked(o: Vec3, d: Vec3, bvh, tris, max_leaf=None,
                          chunk: int = BVH_CHUNK, with_counts: bool = False):
    """``intersect_bvh`` over the rays sorted by the coherence key of the
    root box (``pbr_tpu.ops.traverse._coherence_keys``; the formula of
    ``ops/cull.py::coherence_keys``), ``chunk`` rays at a time: a bounded
    working set (chip_smoke.py holds K8 to it on a million rays). Results
    are per ray, so it is bitwise equal to the unchunked walk."""
    n = o.x.shape[0]
    max_leaf = leaf_bound(bvh, max_leaf)
    perm = torch.argsort(coherence_keys(o, d, *bvh.root), stable=True)
    table = cuda_intersect.face_table(tris)
    outs = []
    for lo in range(0, max(n, 1), chunk):
        p = perm[lo:lo + chunk]
        t, face, _, tests, visits = cuda_bvh.walk_plain(
            Vec3(o.x[p], o.y[p], o.z[p]), Vec3(d.x[p], d.y[p], d.z[p]), bvh, table, max_leaf)
        outs.append((t, face, tests, visits))
    res = []
    for j in range(4 if with_counts else 2):
        a = torch.cat([c[j] for c in outs])
        out = torch.empty_like(a)
        out[perm] = a
        res.append(out)
    return tuple(res)


def band_mode(bands, n_faces: int, has_bvh: bool = False, has_forest: bool = False) -> str:
    """The mode of the band of ``bands`` (``AUTO_BANDS``' form) that holds
    ``n_faces``, "tree" resolved for a scene with or without a BVH and a
    forest."""
    for top, mode in bands:
        if top is None or n_faces <= top:
            if mode == "tree":
                return "pallas_bvh_forest" if has_forest else "bvh" if has_bvh else "pallas"
            return mode
    raise ValueError("the last band must have no upper edge")


def resolve_mode(mode: str, device, n_faces: int = 0, has_clusters: bool = False,
                 has_bvh: bool = False, has_forest: bool = False) -> str:
    """What the ``RenderSettings.intersector`` value ``mode`` runs on
    ``device`` for a scene of ``n_faces`` faces with or without cluster
    tables, a BVH and a forest: 'gated' (kernel K3), 'cull' (kernel K4 or
    K4m), 'sweep' (kernel K5 or K5m; never picked by 'auto'), 'pallas'
    (kernel K1, the port of the TPU kernel of that name),
    'bvh' (K8), 'pallas_bvh' (K6), 'pallas_bvh_forest' (K6 seeded),
    'pallas_bvh_hbm' (K7) — on a CPU tensor their wrappers run the plain
    versions — 'gemm' (the sweep as a matrix product, either device; never
    picked by 'auto') or 'brute' (the plain sweep, CPU tensors only: on a
    card the sweep is K1). Raises for unknown modes."""
    if mode == "auto":
        mode = band_mode(AUTO_BANDS["clusters" if has_clusters else "plain"], n_faces, has_bvh,
                         has_forest)
        return "brute" if mode == "pallas" and device.type == "cpu" else mode
    if mode == "brute" and device.type != "cpu":
        raise ValueError(
            f"intersector 'brute' is the plain sweep for CPU tensors; on a "
            f"{device.type} device use 'auto' or 'pallas' (kernel K1)"
        )
    if mode in ("brute", "pallas", "gated", "cull", "sweep", "gemm", *_TREE_MODES):
        return mode
    raise ValueError(f"unknown intersector mode {mode!r}")


def intersect_scene(o: Vec3, d: Vec3, tris, mode: str = "auto",
                    light_pos=None, alive=None, clusters=None,
                    with_counts: bool = False, bvh=None, forest=None, max_leaf=None):
    """Nearest-hit dispatch (``pbr_tpu.ops.traverse.intersect_scene``).

    The search for the nearest face runs detached; the winner's ``t`` is
    then re-evaluated with one Möller-Trumbore on live ``o``/``d`` and
    detached geometry, which is where gradients flow.

    ``light_pos`` (a Vec3 of 0-d tensors, light 0) asks for the NEE shadow
    any-hit fused into the search. Returns ``(t, face, occluded)``, where
    ``occluded`` is None when the mode has no fused leg (the plain sweep
    and ``bvh``): the caller then traces the shadow ray itself.

    ``alive``: optional (B,) bool liveness. The gated sweep, the
    cull-and-sweep, the row sweep and the tree walks close dead lanes out
    (they cost nothing and return face -1); the full sweeps ignore it.
    ``clusters``: the scene's ``scene.ClusterTables`` or None ('gated',
    'cull' and 'sweep' need them, 'sweep' with its lin tables);
    ``bvh``/``forest``: its ``BVHTables``/``ForestTables`` or None
    (the tree walks need them); ``max_leaf``: the faces a leaf may hold
    (``leaf_bound``: None takes the BVH's own); the forest's sub-trees have
    their own, ``FOREST_MAX_LEAF``.

    ``with_counts``: also return ``(tests, visits)`` last, per-ray int32
    counters, as in the JAX package: ``tests`` is F, or 2F with the fused
    shadow leg, on the full sweeps (F on 'gemm', which has no fused leg),
    the exact executed real-face tests on 'gated', and on 'sweep' the
    faces its rows' verdicts ask for (``cuda_sweep.intersect_sweep``, both
    passes; early-out savings not subtracted); on 'bvh' both are exact
    (the reference's two debug channels); a sweep visits no nodes, so its
    ``visits`` is None; 'cull', the packet walks and the forest count
    nothing (None, None): their tile- or warp-dynamic work is not a
    per-ray count.
    """
    mode = resolve_mode(mode, o.x.device, int(tris.mtl.shape[0]), clusters is not None,
                        bvh is not None, forest is not None)
    o_s, d_s, tris_s = o.detach(), d.detach(), detach_tris(tris)
    light_s = None if light_pos is None else light_pos.detach()
    occ = counts = visits = None
    if mode in _TREE_MODES and (bvh is None or (mode == "pallas_bvh_forest" and forest is None)):
        what = "a BVH forest" if bvh is not None else "a BVH"
        raise ValueError(
            f"mode={mode!r} needs a scene with {what}; this scene has none (a BVH is "
            f"built with use_bvh=True; forests are built only when the single-tree "
            f"packet walk cannot hold a scene without clusters — scene/build.py — or "
            f"explicitly via accel.forest.build_forest)"
        )
    if mode == "bvh":
        out = cuda_bvh.intersect_bvh_walk(o_s, d_s, bvh, tris_s, max_leaf=max_leaf,
                                          alive=alive, with_counts=with_counts)
        face = out[1]
        if with_counts:
            counts, visits = out[2], out[3]
    elif mode in ("pallas_bvh", "pallas_bvh_hbm", "pallas_bvh_forest"):
        if mode == "pallas_bvh_forest":
            out = cuda_bvh.intersect_bvh_forest(o_s, d_s, forest, bvh, FOREST_MAX_LEAF,
                                                light_pos=light_s, alive=alive)
        else:
            walk = (cuda_bvh.intersect_bvh_packet if mode == "pallas_bvh"
                    else cuda_bvh.intersect_bvh_packet_hbm)
            out = walk(o_s, d_s, bvh, tris_s, max_leaf=max_leaf, light_pos=light_s, alive=alive)
        face = out[1]
        if light_pos is not None:
            occ = out[2]
    elif mode == "gated":
        if clusters is None:
            raise ValueError(
                "mode='gated' needs a scene with clusters (the fine AABBs are "
                "the gate targets); build the scene with use_bvh=True "
                "(scene/build.py attaches a ClusterSet above 256 faces)"
            )
        out = cuda_gated.intersect_gated(
            o_s, d_s, tris_s, clusters, alive=alive, with_counts=with_counts,
            light_pos=light_s,
        )
        face = out[1]
        if light_pos is not None:
            occ = out[2]
        if with_counts:
            counts = out[-1]
    elif mode == "cull":
        if clusters is None:
            raise ValueError(
                "mode='cull' needs a scene with clusters (the candidate lists and "
                "coefficient blocks); build the scene with use_bvh=True "
                "(scene/build.py attaches a ClusterSet above 256 faces)"
            )
        out = cuda_cull.intersect_cull(o_s, d_s, clusters, alive=alive, light_pos=light_s)
        face = out[1]
        if light_pos is not None:
            occ = out[2]
    elif mode == "sweep":
        out = cuda_sweep.intersect_sweep(o_s, d_s, clusters, light_pos=light_s, alive=alive,
                                         with_counts=with_counts)
        face = out[1]
        if light_pos is not None:
            occ = out[2]
        if with_counts:
            counts = out[-1]
    elif mode == "gemm":
        _, face = intersect_gemm(o_s, d_s, tris_s)
    elif mode == "pallas":
        if light_pos is not None:
            _, face, occ = cuda_intersect.intersect_fused(o_s, d_s, tris_s, light_pos=light_s)
        else:
            _, face = cuda_intersect.intersect_fused(o_s, d_s, tris_s)
    else:
        _, face = intersect_brute(o_s, d_s, tris_s)

    safe = face.clamp_min(0)
    t_re, _ = moller_trumbore(
        o, d, gather_vec3(tris_s.v0, safe), gather_vec3(tris_s.e1, safe),
        gather_vec3(tris_s.e2, safe),
    )
    t = t_re.masked_fill(face < 0, INF)
    out = [t, face]
    if light_pos is not None:
        out.append(occ)
    if with_counts:
        if mode in ("brute", "pallas", "gemm"):  # every face, twice with a fused NEE leg
            counts = face.new_full(face.shape, int(tris.mtl.shape[0]) * (2 if occ is not None else 1))
        out.append((counts, visits))
    return tuple(out)


def occluded_scene(o: Vec3, d: Vec3, t_limit: torch.Tensor, tris, mode: str = "auto",
                   alive=None, clusters=None, bvh=None, forest=None, max_leaf=None):
    """Any-hit dispatch: the NEE shadow leg of the modes that have no fused
    one (``intersect_scene`` returns ``occluded`` None for them), the bit
    ``t_sh < t_light`` of ``pbr_tpu/models/integrator.py:352-353``: True
    where some face lies closer along the ray than ``t_limit`` (B,).

    ``alive``: the lanes whose bit the caller reads; the others may hold
    any value. ``bvh`` runs kernel K8's any-hit instance on those lanes
    only (``cuda_bvh.occluded_bvh_walk``: False on the others); every other
    mode, as the JAX package does, runs the nearest search of
    ``intersect_scene`` on every lane and compares its t. Detached: a bit
    has no gradient. Arguments as ``intersect_scene``."""
    n_faces = int(tris.mtl.shape[0])
    if bvh is not None and resolve_mode(mode, o.x.device, n_faces, clusters is not None, True,
                                        forest is not None) == "bvh":
        return cuda_bvh.occluded_bvh_walk(o.detach(), d.detach(), t_limit.detach(), bvh,
                                          detach_tris(tris), max_leaf, alive=alive)
    t_sh, _ = intersect_scene(o, d, tris, mode=mode, clusters=clusters, bvh=bvh, forest=forest,
                              max_leaf=max_leaf)
    return t_sh < t_limit
