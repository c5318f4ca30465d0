"""Kernels K9 and K10: the Phong-tessellation searches, CUDA for Hopper, and
their plain PyTorch versions.

The JAX package runs its two Phong searches as device loops in XLA, the
same class as ``traverse.py``'s walk whose port is K8:

- **K9** (``csrc/phong_walk.cu``, ``intersect_walk``) is the per-ray
  stackless walk of the Phong tree (built over ``phongtess_face_aabbs``),
  ``pbr_tpu/ops/phongtess.py::intersect_bvh_phongtess`` (the
  ``jax.lax.while_loop`` at :458 over the step at :414-452). Its plain
  version is ``ops/phongtess.py::intersect_bvh_phongtess``;
- **K10** (``csrc/phong_clusters.cu``, ``intersect_clusters``) is the
  cluster search, ``intersect_clusters_phongtess`` (the while_loop at :730
  over ``cond`` and ``body`` at :681-728): one block a 128-ray tile, the
  tile's rounds over its near-to-far list (``ops/cull.py::
  candidates_fine``, torch ops here as JAX keeps it outside its loop). Its
  plain version is ``ops/phongtess.py::intersect_clusters_phongtess``.

Both read the scene's Phong face table (``ops/phongtess.py::
phong_records``, 20 floats a face in five 16-byte words, which
``scene/device.py::to_torch`` builds once a scene with curved faces) and
share ``csrc/phong.cuh``, the patch test. The searches are detached, as in
JAX (``pbr_tpu/ops/phongtess.py:475-483``): neither kernel has a backward.

A wrapper checks device, type, shape and contiguity; on a CUDA tensor it
launches its kernel or raises, on a CPU tensor (and only there) it runs the
plain version. ``launches`` counts kernel launches ("K9", "K10"); a launch
under capture counts at its graph's replays (``ops.counts``).

The bounds of chip_smoke.py count the operations of the functions as
written (``OPS_NODE`` a node step, ``OPS_MT`` a flat face test,
``OPS_PATCH`` a curved one, ``OPS_RAY`` a ray) over the work of the run's
data: the walk's node steps and face tests (``intersect_bvh_phongtess``'s
``work``), the cluster search's tile-rounds times its live rays and real
faces (``cluster_tests``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pbr_tpu_torch.ops import count_launch, phongtess
from pbr_tpu_torch.ops.cuda_bvh import ray_order
from pbr_tpu_torch.ops.cuda_intersect import check_rays, load
from pbr_tpu_torch.ops.traverse import leaf_bound
from pbr_tpu_torch.ops.vec import Vec3, f32

# Kernel launches. CPU calls and launches under capture do not count.
launches = {"K9": 0, "K10": 0}

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
# rays (6), order, alive, n, node records, n_nodes, faces, max_leaf, alpha,
# 1 - alpha, t_out, f_out, u_out, v_out, stream
_WALK_ARGTYPES = [_P] * 8 + [_I, _P, _I, _P, _I, _F, _F] + [_P] * 5
# rays (6), alive, n, faces, size, cand, cnt, tent, n_cand, alpha,
# 1 - alpha, f_out, u_out, v_out, rounds_out, stream
_CLUSTER_ARGTYPES = [_P] * 7 + [_I, _P, _I, _P, _P, _P, _I, _F, _F] + [_P] * 5


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


def intersect_walk(o: Vec3, d: Vec3, bvh, faces: torch.Tensor, alpha: float,
                   max_leaf: Optional[int] = None, alive=None):
    """Nearest hit by the per-ray Phong walk, kernel K9
    (``intersect_bvh_phongtess``'s contract). ``bvh``: the scene's
    ``BVHTables`` (with its node records), built over the inflated bounds;
    ``faces``: its ``phong_records`` table; ``max_leaf``: the faces a leaf
    may hold (``leaf_bound``: None takes the tree's own, and a bound below
    the tree's largest leaf raises); ``alive`` (B,) bool: a dead lane walks
    nothing. Returns ``(t, face, u, v)``."""
    max_leaf = leaf_bound(bvh, max_leaf)
    _check("K9", o, d, faces, None, alive)
    dev, n = o.x.device, o.x.shape[0]
    if dev.type == "cpu":
        return phongtess.intersect_bvh_phongtess(o, d, bvh, None, alpha, max_leaf, alive=alive,
                                                 faces=faces)
    rec = bvh.node_records
    if rec is None or rec.device != dev or tuple(rec.shape) != (bvh.count, 8) \
            or not rec.is_contiguous():
        raise ValueError(f"K9: the tree needs its packed node records, contiguous "
                         f"({bvh.count}, 8) float32 on {dev} (to_torch builds them)")
    return walk_kernel(o, d, bvh, faces, alpha, max_leaf, alive, ray_order(o, d, bvh, alive))


def walk_kernel(o: Vec3, d: Vec3, bvh, faces: torch.Tensor, alpha: float, max_leaf: int,
                alive, order):
    """K9's launch alone over checked inputs and a launch ``order`` (CUDA
    tensors; ``intersect_walk`` checks them and computes the order):
    ``(t, face, u, v)``. chip_smoke.py times it apart from the order."""
    dev, n = o.x.device, o.x.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    f = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    lib = load("phong_walk", "pbr_phong_walk", _WALK_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_phong_walk(
            *(a.data_ptr() for a in (*o, *d)), None if order is None else order.data_ptr(),
            None if alive is None else alive.data_ptr(), n, bvh.node_records.data_ptr(),
            bvh.count, faces.data_ptr(), max_leaf, *_alphas(alpha), t.data_ptr(), f.data_ptr(),
            u.data_ptr(), v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K9 launch failed: cudaError {err}")
    count_launch(launches, "K9")
    return t, f, u, v


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
    clusters.size`` rows; ``alive`` (B,) bool: dead lanes keep their rays in
    the tiles, report face -1 and cost nothing. Returns ``(face, u, v)``,
    and with ``with_rounds`` also each tile's rounds, (T,) int32."""
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
    lists = candidate_lists(o, d, clusters) if n else None
    return clusters_kernel(o, d, faces, s, lists, alpha, alive, with_rounds)


def clusters_kernel(o: Vec3, d: Vec3, faces: torch.Tensor, size: int, lists, alpha: float,
                    alive, with_rounds: bool = False):
    """K10's launch alone over checked inputs and the candidate ``lists``
    of ``candidate_lists`` (CUDA tensors; ``intersect_clusters`` checks them
    and builds the lists): ``(face, u, v)``, with ``with_rounds`` also each
    tile's rounds. chip_smoke.py times it apart from the lists."""
    dev, n = o.x.device, o.x.shape[0]
    f = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty_like(u)
    rounds = torch.zeros((-(-n // TILE),), dtype=torch.int32, device=dev)
    if n:
        cand, cnt, tent = lists
        lib = load("phong_clusters", "pbr_phong_clusters", _CLUSTER_ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.pbr_phong_clusters(
                *(a.data_ptr() for a in (*o, *d)), None if alive is None else alive.data_ptr(),
                n, faces.data_ptr(), size, cand.data_ptr(), cnt.data_ptr(), tent.data_ptr(),
                cand.shape[1], *_alphas(alpha), f.data_ptr(), u.data_ptr(), v.data_ptr(),
                rounds.data_ptr() if with_rounds else None, stream)
        if err != 0:
            raise RuntimeError(f"K10 launch failed: cudaError {err}")
        count_launch(launches, "K10")
    return (f, u, v, rounds) if with_rounds else (f, u, v)


def cluster_tests(cand: torch.Tensor, rounds: torch.Tensor, live: torch.Tensor,
                  faces: torch.Tensor, size: int) -> tuple:
    """(flat, curved): the face tests a cluster search needs, every real
    face of each cluster a tile ran (its first ``rounds`` entries of
    ``cand``) against each live ray of the tile; ``live`` (T * 128,) bool,
    padding lanes False. Padding faces (all zero: no vertex) need no test."""
    flat = faces[:, 18] > 0.5
    real = faces[:, :18].ne(0).any(dim=1)
    per_cluster = lambda m: m.reshape(-1, size).sum(dim=1)  # noqa: E731
    n_flat, n_curved = per_cluster(flat & real), per_cluster(~flat & real)
    ran = torch.arange(cand.shape[1], device=cand.device)[None, :] < rounds[:, None].long()
    cid = cand.long()
    rays = live.reshape(-1, TILE).sum(dim=1)
    per_tile = lambda counts: (counts[cid] * ran).sum(dim=1)  # noqa: E731
    return (int((per_tile(n_flat) * rays).sum()), int((per_tile(n_curved) * rays).sum()))
