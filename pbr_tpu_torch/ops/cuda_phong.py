"""Kernels K9 and K10: the Phong-tessellation searches, CUDA for Hopper, and
their plain PyTorch versions.

The JAX package runs its two Phong searches as device loops in XLA, the
same class as ``traverse.py``'s walk whose port is K8:

- **K9** (``csrc/phong_walk.cu``, ``intersect_walk``) is the per-ray
  stackless walk of the Phong tree (built over ``phongtess_face_aabbs``),
  ``pbr_tpu/ops/phongtess.py::intersect_bvh_phongtess`` (the
  ``jax.lax.while_loop`` at :458 over the step at :414-452), each leaf's
  curved tests dealt over the warp. Its plain version is
  ``ops/phongtess.py::intersect_bvh_phongtess``. Its any-hit instance
  (``occluded_walk``, "K9 any-hit") is the Phong shadow leg: the bit
  ``t_sh < t_light`` that the JAX package takes from a nearest search
  (``pbr_tpu/models/integrator.py:339-353``), with the plain version
  ``ops/phongtess.py::occluded_bvh_phongtess``;
- **K10** (``csrc/phong_clusters.cu``, ``intersect_clusters``) is the
  cluster search, ``intersect_clusters_phongtess`` (the while_loop at :730
  over ``cond`` and ``body`` at :681-728): the rays sorted into coherent
  128-ray tiles (``cluster_order``), one block a tile, the tile's rounds
  over its near-to-far list (``ops/cull.py::candidates_fine``, torch ops
  here as JAX keeps it outside its loop), each ray culling the round's
  cluster by its box and closing on its own, a round's (ray, face) tests
  dealt over the block. Its plain version is ``ops/phongtess.py::
  intersect_clusters_phongtess``, which takes the same per-ray rules.

Both read the scene's Phong face table (``ops/phongtess.py::
phong_records``, 20 floats a face in five 16-byte words, which
``scene/device.py::to_torch`` builds once a scene with curved faces) and
share ``csrc/phong.cuh``, the patch test. The searches are detached, as in
JAX (``pbr_tpu/ops/phongtess.py:475-483``): neither kernel has a backward.

K9's wrappers launch the rays as given: on the card's table
(``tools/k9_walk.py``, ``docs/K9_ORDER_H100.json``) the sort by octant and
Morton code of the origin (``cuda_bvh.ray_order``) lost to that order on
every kind of pass a Phong frame makes.

A wrapper checks device, type, shape and contiguity; on a CUDA tensor it
launches its kernel or raises, on a CPU tensor (and only there) it runs the
plain version. ``launches`` counts kernel launches ("K9", "K9 any-hit",
"K10"); a launch under capture counts at its graph's replays
(``ops.counts``).

The bounds of chip_smoke.py count the operations of the functions as
written (``OPS_NODE`` a node step, ``OPS_MT`` a flat face test,
``OPS_PATCH`` a curved one, ``OPS_RAY`` a ray) over the work of the run's
data: the walk's node steps and face tests (``intersect_bvh_phongtess``'s
``work``; the any-hit walk's up to each ray's occluder,
``occluded_bvh_phongtess``'s); for the cluster search (``cluster_tests``)
both the tests of the JAX loop's rule (every real face of the rounds a
tile runs under it, against each live ray of the tile: the yardstick) and
the tests K10 runs (the real faces of a round's cluster against its active
rays), with its slab tests (``OPS_NODE`` each).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pbr_tpu_torch.ops import count_launch, phongtess
from pbr_tpu_torch.ops.cuda_intersect import check_rays, load
from pbr_tpu_torch.ops.cull import coherence_keys
from pbr_tpu_torch.ops.traverse import leaf_bound
from pbr_tpu_torch.ops.vec import Vec3, f32

# Kernel launches. CPU calls and launches under capture do not count.
launches = {"K9": 0, "K9 any-hit": 0, "K10": 0}

# K10's tile: rays a block (kTile of csrc/phong_clusters.cu), and the
# largest cluster it stages (kMaxSize).
TILE = 128
MAX_CLUSTER = 128
# The candidate lists are built this many (tile, cluster) pairs at a time.
_CAND_ELEMS = 1 << 22

# Operations of one test, for the bounds: a node step's slab test as the
# tree walks count it (chip_smoke.py's OPS_SLAB), classic Moller-Trumbore
# (chip_smoke.py's OPS_CLASSIC), and ``phongtess_patch_intersect`` as
# written, each elementwise op of the plain version one operation: its ray
# planes and dominant axis once a ray (``OPS_RAY``), and a curved face's test
# without its two solves and its tessellated points (``OPS_PATCH``). The
# solves' branches and the points of the roots that pass depend on the data
# and are left out, so the bound lies below the least work.
# tests/test_torch_phong_kernels.py counts both from the plain version.
OPS_NODE = 25
OPS_MT = 51
OPS_RAY = 65
OPS_PATCH = 578

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# rays (6), order, alive, t_limit, n, node records, n_nodes, faces, max_leaf,
# alpha, 1 - alpha, t_out, f_out, u_out, v_out, occ_out, stream
_WALK_ARGTYPES = [_P] * 9 + [_I, _P, _I, _P, _I, _F, _F] + [_P] * 6
# rays (6), alive, order, n, faces, size, boxes, cand, cnt, tent, n_cand,
# alpha, 1 - alpha, f_out, u_out, v_out, rounds_out, stream
_CLUSTER_ARGTYPES = [_P] * 8 + [_I, _P, _I, _P, _P, _P, _P, _I, _F, _F] + [_P] * 5


def _alphas(alpha: float) -> tuple:
    """float32(alpha) and float32(1 - float32(alpha)), as the plain
    version rounds them."""
    a = f32(alpha)
    return a, f32(1.0 - a)


def _check(who: str, o: Vec3, d: Vec3, faces: torch.Tensor, rows: Optional[int], alive) -> None:
    check_rays(who, o, d)
    dev, n = o.x.device, o.x.shape[0]
    if (faces.device != dev or faces.dtype != torch.float32 or faces.dim() != 2
            or faces.shape[1] != phongtess.PHONG_RECORD or not faces.is_contiguous()
            or (rows is not None and faces.shape[0] != rows)):
        raise ValueError(f"{who}: the face table must be contiguous ({rows or 'F'}, "
                         f"{phongtess.PHONG_RECORD}) float32 on {dev} (phong_records), got "
                         f"{faces.dtype} {tuple(faces.shape)} on {faces.device}")
    if alive is not None and (alive.device != dev or alive.dtype != torch.bool
                              or alive.shape != (n,) or not alive.is_contiguous()):
        raise ValueError(f"{who}: alive must be a contiguous ({n},) bool tensor on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on CUDA or CPU tensors, not {dev}")


def _check_walk(who: str, o: Vec3, d: Vec3, bvh, faces, max_leaf, alive) -> int:
    """The walk's checks (``_check``, the leaf bound, on a card the packed
    node records); returns the leaf bound."""
    max_leaf = leaf_bound(bvh, max_leaf)
    _check(who, o, d, faces, None, alive)
    dev = o.x.device
    rec = bvh.node_records
    if dev.type == "cuda" and (rec is None or rec.device != dev
                               or tuple(rec.shape) != (bvh.count, 8) or not rec.is_contiguous()):
        raise ValueError(f"{who}: the tree needs its packed node records, contiguous "
                         f"({bvh.count}, 8) float32 on {dev} (to_torch builds them)")
    return max_leaf


def intersect_walk(o: Vec3, d: Vec3, bvh, faces: torch.Tensor, alpha: float,
                   max_leaf: Optional[int] = None, alive=None):
    """Nearest hit by the per-ray Phong walk, kernel K9
    (``intersect_bvh_phongtess``'s contract). ``bvh``: the scene's
    ``BVHTables`` (with its node records), built over the inflated bounds;
    ``faces``: its ``phong_records`` table; ``max_leaf``: the faces a leaf
    may hold (``leaf_bound``: None takes the tree's own, and a bound below
    the tree's largest leaf raises); ``alive`` (B,) bool: a dead lane walks
    nothing. The rays launch as given. Returns ``(t, face, u, v)``."""
    max_leaf = _check_walk("K9", o, d, bvh, faces, max_leaf, alive)
    if o.x.device.type == "cpu":
        return phongtess.intersect_bvh_phongtess(o, d, bvh, None, alpha, max_leaf, alive=alive,
                                                 faces=faces)
    return walk_kernel(o, d, bvh, faces, alpha, max_leaf, alive, None)


def occluded_walk(o: Vec3, d: Vec3, t_limit: torch.Tensor, bvh, faces: torch.Tensor,
                  alpha: float, max_leaf: Optional[int] = None, alive=None):
    """Any hit closer than ``t_limit`` by the per-ray Phong walk, K9's
    any-hit instance (``occluded_bvh_phongtess``'s contract): a ray is
    occluded iff some valid face has t < ``t_limit``, the bit the nearest
    search gives as t < ``t_limit``. Arguments as ``intersect_walk``;
    ``t_limit`` (B,) float32. Returns the (B,) bool ``occluded`` (False on
    a dead lane)."""
    max_leaf = _check_walk("K9 any-hit", o, d, bvh, faces, max_leaf, alive)
    n, dev = o.x.shape[0], o.x.device
    if (t_limit.device != dev or t_limit.dtype != torch.float32 or t_limit.shape != (n,)
            or not t_limit.is_contiguous()):
        raise ValueError(f"K9 any-hit: t_limit must be a contiguous ({n},) float32 tensor on "
                         f"{dev}")
    if dev.type == "cpu":
        return phongtess.occluded_bvh_phongtess(o, d, t_limit, bvh, None, alpha, max_leaf,
                                                alive=alive, faces=faces)
    return walk_kernel(o, d, bvh, faces, alpha, max_leaf, alive, None, t_limit)


def walk_kernel(o: Vec3, d: Vec3, bvh, faces: torch.Tensor, alpha: float, max_leaf: int,
                alive, order, t_limit: Optional[torch.Tensor] = None, lib=None):
    """K9's launch alone over checked inputs and a launch ``order`` (None:
    the rays as given, which the wrappers take; CUDA tensors, which
    ``intersect_walk`` and ``occluded_walk`` check): the nearest instance's
    ``(t, face, u, v)``, or with ``t_limit`` the any-hit instance's
    ``occluded``. ``lib``: another build of the source (``tools/k9_walk.py``'s
    copies), None for the port's."""
    dev, n = o.x.device, o.x.shape[0]
    if t_limit is None:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        f = torch.empty((n,), dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        outs, occ = (t.data_ptr(), f.data_ptr(), u.data_ptr(), v.data_ptr(), None), None
    else:
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
        outs = (None, None, None, None, occ.data_ptr())
    lib = load("phong_walk", "pbr_phong_walk", _WALK_ARGTYPES) if lib is None else lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_phong_walk(
            *(a.data_ptr() for a in (*o, *d)), None if order is None else order.data_ptr(),
            None if alive is None else alive.data_ptr(),
            None if t_limit is None else t_limit.data_ptr(), n, bvh.node_records.data_ptr(),
            bvh.count, faces.data_ptr(), max_leaf, *_alphas(alpha), *outs, stream)
    name = "K9" if t_limit is None else "K9 any-hit"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    count_launch(launches, name)
    return (t, f, u, v) if t_limit is None else occ


def cluster_order(o: Vec3, d: Vec3, clusters, alive=None) -> torch.Tensor:
    """K10's tile order: the rays sorted by octant and Morton code of the
    origin in the clusters' scene box (``ops/cull.py::coherence_keys``, K8's
    and K9's sort; stable, so rays of one key keep their order: camera rays
    share an origin), dead lanes last, (B,) int32."""
    keys = coherence_keys(o, d, clusters.scene_min, clusters.scene_max)
    if alive is not None:
        keys = torch.where(alive, keys, torch.iinfo(torch.int32).max)
    return torch.argsort(keys, stable=True).to(torch.int32)


def in_order(o: Vec3, d: Vec3, alive, order) -> tuple:
    """``(o, d, alive)`` gathered into ``order``."""
    idx = order.long()
    take = lambda v: Vec3(*(a[idx] for a in v))  # noqa: E731
    return take(o), take(d), None if alive is None else alive[idx]


def sorted_lists(o: Vec3, d: Vec3, clusters, alive=None) -> tuple:
    """What ``intersect_clusters`` runs on the card before K10's launch:
    ``(o, d, alive, order, lists)``, the rays and ``alive`` sorted into
    ``cluster_order``, that order, and ``candidate_lists`` over the sorted
    rays (None for no ray). The plain version takes the rays as given: its
    results do not depend on the tiles."""
    order = cluster_order(o, d, clusters, alive)
    os_, ds, als = in_order(o, d, alive, order)
    return os_, ds, als, order, candidate_lists(os_, ds, clusters) if o.x.shape[0] else None


def cluster_boxes(clusters) -> torch.Tensor:
    """K10's (C, 8) float32 cluster boxes, two 16-byte words a cluster:
    ``bb_min`` and a 0, ``bb_max`` and a 0."""
    lo, hi = clusters.bb_min, clusters.bb_max
    zero = torch.zeros_like(lo.x)
    return torch.stack([lo.x, lo.y, lo.z, zero, hi.x, hi.y, hi.z, zero], dim=1).contiguous()


def candidate_lists(o: Vec3, d: Vec3, clusters) -> tuple:
    """K10's input: ``ops/cull.py::candidates_fine`` over the rays' 128-ray
    tiles (the last tile padded with the last ray, as the plain version
    pads it), ``(cand, cnt, tent)`` of (T, C), (T,) and (T, C), built
    ``_CAND_ELEMS`` (tile, cluster) pairs at a time."""
    from pbr_tpu_torch.ops.cull import candidates_fine

    n = o.x.shape[0]
    tiles = -(-n // TILE)
    pad = tiles * TILE - n
    if pad:
        o, d = (Vec3(*(torch.cat([a, a[-1:].expand(pad)]) for a in v)) for v in (o, d))
    step = max(1, _CAND_ELEMS // clusters.count) * TILE
    parts = [candidates_fine(Vec3(*(a[lo:lo + step] for a in o)),
                             Vec3(*(a[lo:lo + step] for a in d)), clusters, TILE)
             for lo in range(0, tiles * TILE, step)]
    if len(parts) == 1:
        return tuple(a.contiguous() for a in parts[0])
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


def intersect_clusters(o: Vec3, d: Vec3, clusters, faces: torch.Tensor, alpha: float,
                       alive=None, with_rounds: bool = False):
    """Nearest hit by the Phong cluster search, kernel K10
    (``intersect_clusters_phongtess``'s contract, tiles of 128 rays).
    ``clusters``: the scene's ``ClusterTables`` over the inflated bounds;
    ``faces``: its ``phong_records`` table padded to ``clusters.count *
    clusters.size`` rows; ``alive`` (B,) bool: dead lanes report face -1 and
    cost nothing. Returns ``(face, u, v)``, and with ``with_rounds`` also
    each tile's rounds, (T,) int32: on the card the tiles of the sorted
    rays (``cluster_order``), on the CPU those of the rays as given."""
    s, c = clusters.size, clusters.count
    _check("K10", o, d, faces, c * s, alive)
    if not 1 <= s <= MAX_CLUSTER:
        raise ValueError(f"K10 stages clusters of at most {MAX_CLUSTER} faces, not {s}")
    dev, n = o.x.device, o.x.shape[0]
    if dev.type == "cpu":
        stats = {} if with_rounds else None
        out = phongtess.intersect_clusters_phongtess(o, d, clusters, None, alpha, alive=alive,
                                                     tile=TILE, stats=stats, faces=faces)
        return (*out, stats["per_tile"]) if with_rounds else out
    os_, ds, als, order, lists = sorted_lists(o, d, clusters, alive)
    return clusters_kernel(os_, ds, faces, clusters, lists, alpha, als, order, with_rounds)


def clusters_kernel(o: Vec3, d: Vec3, faces: torch.Tensor, clusters, lists, alpha: float,
                    alive, order=None, with_rounds: bool = False):
    """K10's launch alone over checked inputs: the rays ``o``, ``d`` and
    ``alive`` in tile order, the candidate ``lists`` of ``candidate_lists``
    over them, and ``order`` (None: identity) giving each ray's place in the
    output (CUDA tensors; ``intersect_clusters`` checks them, sorts the rays
    and builds the lists): ``(face, u, v)``, with ``with_rounds`` also each
    tile's rounds. chip_smoke.py times it apart from the sort and the
    lists."""
    dev, n = o.x.device, o.x.shape[0]
    f = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty_like(u)
    rounds = torch.zeros((-(-n // TILE),), dtype=torch.int32, device=dev)
    if n:
        cand, cnt, tent = lists
        boxes = cluster_boxes(clusters)
        lib = load("phong_clusters", "pbr_phong_clusters", _CLUSTER_ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.pbr_phong_clusters(
                *(a.data_ptr() for a in (*o, *d)), None if alive is None else alive.data_ptr(),
                None if order is None else order.data_ptr(), n, faces.data_ptr(),
                clusters.size, boxes.data_ptr(), cand.data_ptr(), cnt.data_ptr(),
                tent.data_ptr(), cand.shape[1], *_alphas(alpha), f.data_ptr(), u.data_ptr(),
                v.data_ptr(), rounds.data_ptr() if with_rounds else None, stream)
        if err != 0:
            raise RuntimeError(f"K10 launch failed: cudaError {err}")
        count_launch(launches, "K10")
    return (f, u, v, rounds) if with_rounds else (f, u, v)


def cluster_work(lists, stats: dict) -> dict:
    """What a call of the plain cluster search did, and what the JAX loop's
    rule would do, from its ``stats`` (``intersect_clusters_phongtess``) and
    the candidate ``lists`` of the same rays in the same tiles
    (``candidate_lists``):

    - ``jax_rounds`` (T,) int32: each tile's rounds under the JAX rule
      (rounds while some ray's best t lies beyond the entry bound, the list
      not run out). A ray's best t after the rounds it stayed open is
      final: a cluster it then skips starts at or beyond that t or lies off
      its path. So at round r the rule finds the ray done where r is past
      its open rounds and its final t lies at or before the entry bound;
    - ``slabs``: the box tests K10 runs, each live ray's scan for its last
      entry and one a round while it is open;
    - ``staged``: the (tile, round) pairs with an active ray, whose cluster
      K10 stages."""
    _, cnt, tent = lists
    opened, t = stats["open"].reshape(-1, TILE), stats["t"].reshape(-1, TILE)
    jax_rounds = cnt.clone()
    for r in range(int(cnt.max()) if cnt.numel() else 0):
        done = ((r >= opened) & (t <= tent[:, r:r + 1])).all(dim=1)
        jax_rounds = torch.where(done & (r < jax_rounds), r, jax_rounds)
    return {"jax_rounds": jax_rounds, "slabs": int(stats["scan"].sum() + stats["open"].sum()),
            "staged": int((stats["active"] > 0).sum())}


def cluster_tests(cand: torch.Tensor, rounds: torch.Tensor, live: torch.Tensor,
                  faces: torch.Tensor, size: int, active: Optional[torch.Tensor] = None) -> tuple:
    """(flat, curved): the face tests of the JAX loop's rule, every real
    face of each cluster a tile ran (its first ``rounds`` entries of
    ``cand``, the rounds under that rule: ``cluster_work``'s
    ``jax_rounds``) against each live ray of the tile; ``live`` (T * 128,)
    bool, padding lanes False. With ``active`` (the plain version's (T, C)
    active rays a tile and round) also the tests K10 runs: (flat, curved,
    flat run, curved run). Padding faces (all zero: no vertex) need no
    test."""
    flat = faces[:, 18] > 0.5
    real = faces[:, :18].ne(0).any(dim=1)
    per_cluster = lambda m: m.reshape(-1, size).sum(dim=1)  # noqa: E731
    n_flat, n_curved = per_cluster(flat & real), per_cluster(~flat & real)
    ran = torch.arange(cand.shape[1], device=cand.device)[None, :] < rounds[:, None].long()
    cid = cand.long()
    rays = live.reshape(-1, TILE).sum(dim=1)
    per_tile = lambda counts: (counts[cid] * ran).sum(dim=1)  # noqa: E731
    out = (int((per_tile(n_flat) * rays).sum()), int((per_tile(n_curved) * rays).sum()))
    if active is None:
        return out
    return (*out, *(int((counts[cid] * active.long()).sum()) for counts in (n_flat, n_curved)))
