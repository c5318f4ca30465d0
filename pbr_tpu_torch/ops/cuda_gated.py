"""Kernel K3: the gated brute-force sweep, CUDA for Hopper, and its plain
PyTorch version.

K3 replaces ``pbr_tpu/ops/pallas_gated.py::_kernel`` (with
``_mt_lin_update``); this module is the counterpart of that file's
wrapper, ``intersect_gated``, with its contract. The source is
``pbr_tpu_torch/csrc/gated_intersect.cu``, whose header says what bounds
the kernel on the card and how its design answers that.

Per ray tile (``rows`` x 128 rays) the cull stage (``ops/cull.py``) marks
the 64-face clusters that any live ray of the tile may hit; the sweep then
visits the marked clusters in ascending order with the linear-form
Möller-Trumbore of kernel K2 (``ops/cuda_intersect.py::mt_lin``):

- a nearest pass seeded with t = +inf (live lanes) or -3e38 (dead lanes,
  which then never update) and face -1;
- with a light, an any-hit NEE pass from the guarded hit points to light 0,
  with verdicts capped by each tile's longest shadow ray and only the lanes
  that hit as live.

- ``intersect_gated(o, d, tris, clusters, light_pos=None, alive=None,
  rows=8, with_counts=False)`` is the wrapper: for CUDA tensors it launches
  the kernel (or raises); for CPU tensors — and only for them — it runs the
  plain sweep. ``launches`` counts kernel launches per pass.
- ``intersect_gated_plain`` is the same function with the plain sweep on
  any device: per gated-in cluster, the tiles that take it sweep its faces
  by broadcasting, each element running the per-face expression in the
  kernel's operation order, so on the card the two agree bitwise.

The sweep reads the scene's (C * 64, 16) face-major table
(``ClusterTables.gated``), which ``scene/device.py::to_torch`` builds once
a scene from ``gated_table``; nothing is rebuilt or transposed per pass.

The JAX wrapper's ray chunking (``chunk_rays``) is a TPU SMEM budget for
its verdict words. Chunks are whole tiles, so leaving it out changes no
verdict; it is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from pbr_tpu_torch.ops import count_launch
from pbr_tpu_torch.ops.cuda_intersect import (
    _PLAIN_ELEMS,
    check_rays,
    cross_od,
    first_min,
    lin_table,
    load,
    mt_lin,
)
from pbr_tpu_torch.ops.cull import fine_hit_mask
from pbr_tpu_torch.ops.intersect import INF
from pbr_tpu_torch.ops.vec import Vec3, f32, safe_div, safe_sqrt

LANES = 128
GATE_CLUSTER = 64  # faces per gated section: the ClusterSet's fine size
_BIG_NEG = f32(-3.0e38)

# Kernel launches by intersect_gated, per pass. CPU calls and launches
# under capture do not count (``ops.counts`` adds a CUDA graph's at its
# replays).
launches = {"nearest": 0, "any-hit": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I, _I, _I] + [_P] * 7


def gated_table(tris, n_clusters: int) -> torch.Tensor:
    """The (16, C * 64) linear-form table, zero-padded past the last face
    (pallas_gated.py:268-272): a padding face has det 0, so its t is NaN
    and it is never valid."""
    tab = lin_table(tris)
    pad = n_clusters * GATE_CLUSTER - tab.shape[1]
    if pad < 0:
        raise ValueError(f"{n_clusters} clusters of {GATE_CLUSTER} cannot hold "
                         f"{tab.shape[1]} faces")
    return torch.nn.functional.pad(tab, (0, pad))


def real_faces(nf: int, n_clusters: int, device) -> torch.Tensor:
    """(C,) int32: the real (non-padding) faces of each cluster."""
    lo = torch.arange(n_clusters, dtype=torch.int32, device=device) * GATE_CLUSTER
    return (nf - lo).clamp(0, GATE_CLUSTER)


def _sweep_plain(o: Vec3, d: Vec3, tab, verdict, tile, seed_t, seed_f, t_limit):
    """The gated sweep in torch ops. ``tab`` (16, C * 64), a transposed view
    of the face-major ``ClusterTables.gated``; ``verdict`` (T, C)
    bool; rays, seeds and ``t_limit`` (T * tile,). Nearest mode
    (``t_limit`` None) returns ``(t, face)``; any-hit mode the occlusion
    as float32 0/1."""
    n_clusters = verdict.shape[1]
    any_hit = t_limit is not None
    best = seed_t.clone()
    face = None if any_hit else seed_f.clone()
    c_all = cross_od(o, d)
    lane = torch.arange(tile, device=o.x.device)
    step = max(1, _PLAIN_ELEMS // (tile * GATE_CLUSTER))  # tiles per block
    for c in range(n_clusters):
        cols = tab[:, c * GATE_CLUSTER:(c + 1) * GATE_CLUSTER]
        tiles = torch.nonzero(verdict[:, c]).flatten()
        for k in range(0, tiles.shape[0], step):
            idx = (tiles[k:k + step, None] * tile + lane).reshape(-1)
            col = lambda v: Vec3(v.x[idx, None], v.y[idx, None], v.z[idx, None])  # noqa: E731
            t, valid = mt_lin(col(o), col(d), col(c_all), cols)
            if any_hit:
                hit = (valid & (t < t_limit[idx, None])).any(dim=1)
                best[idx] = torch.maximum(best[idx], hit.to(torch.float32))
                continue
            t_min, first = first_min(t, valid, c * GATE_CLUSTER, tab.shape[1])
            better = t_min < best[idx]
            best[idx] = torch.where(better, t_min, best[idx])
            face[idx] = torch.where(better, first, face[idx])
    return best if any_hit else (best, face)


def _sweep_kernel(o: Vec3, d: Vec3, tab, verdict, tile, seed_t, seed_f, t_limit):
    """``_sweep_plain``'s contract, by a launch of kernel K3."""
    dev = o.x.device
    n = o.x.shape[0]
    n_tiles, n_clusters = verdict.shape
    any_hit = t_limit is not None
    if n == 0:
        return seed_t.clone() if any_hit else (seed_t.clone(), seed_f.clone())
    tab_fm = tab.t()  # the face-major table itself
    if not tab_fm.is_contiguous() or tab_fm.data_ptr() % 16:
        raise ValueError("K3 reads the face-major (C * 64, 16) table, contiguous and 16-byte "
                         "aligned (ClusterTables.gated)")
    verdict = verdict.contiguous()
    t_out = torch.empty((0 if any_hit else n,), dtype=torch.float32, device=dev)
    f_out = torch.empty((0 if any_hit else n,), dtype=torch.int32, device=dev)
    occ = torch.empty((n if any_hit else 0,), dtype=torch.int32, device=dev)
    lib = load("gated_intersect", "pbr_gated_intersect", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_gated_intersect(
            *(a.data_ptr() for a in (*o, *d)), tab_fm.data_ptr(), verdict.data_ptr(),
            n_clusters, n_tiles, tile, seed_t.data_ptr(),
            None if any_hit else seed_f.data_ptr(),
            t_limit.data_ptr() if any_hit else None,
            t_out.data_ptr(), f_out.data_ptr(), occ.data_ptr(), stream,
        )
    name = "any-hit" if any_hit else "nearest"
    if err != 0:
        raise RuntimeError(f"K3 ({name}) launch failed: cudaError {err}")
    count_launch(launches, name)
    return occ.to(torch.float32) if any_hit else (t_out, f_out)


def _gated(sweep, o: Vec3, d: Vec3, tris, clusters, light_pos, alive, rows, with_counts):
    check_rays("intersect_gated", o, d)
    if clusters.size != GATE_CLUSTER:
        raise ValueError(f"the gated sweep takes {GATE_CLUSTER}-face clusters, "
                         f"not {clusters.size}")
    if not 1 <= rows <= 8:
        raise ValueError(f"rows must be 1..8 (tiles of up to 1,024 rays), not {rows}")
    dev = o.x.device
    if alive is not None and (alive.dtype != torch.bool or alive.shape != o.x.shape
                              or alive.device != dev):
        raise ValueError(f"alive must be a bool tensor of the rays' shape on {dev}")
    nf, n_clusters = int(tris.mtl.shape[0]), clusters.count
    tile = rows * LANES
    flat = o.x.shape[0]
    pad = (-flat) % tile

    def prep(a):  # edge padding, as jnp.pad(mode='edge')
        return torch.cat([a, a[-1:].expand(pad)]) if pad and flat else a

    o_p, d_p = Vec3(*map(prep, o)), Vec3(*map(prep, d))
    live = torch.ones((flat,), dtype=torch.bool, device=dev) if alive is None else alive
    live = torch.cat([live, live.new_zeros(pad)])
    fm = clusters.gated
    if fm is None:
        raise ValueError("the gated sweep needs the scene's face-major table "
                         "(ClusterTables.gated; to_torch builds it for 64-face clusters)")
    if fm.device != dev or fm.dtype != torch.float32 or fm.shape != (n_clusters * GATE_CLUSTER,
                                                                     16):
        raise ValueError(f"the gated table must be ({n_clusters * GATE_CLUSTER}, 16) float32 "
                         f"on the rays' device {dev}")
    tab = fm.t()
    real = real_faces(nf, n_clusters, dev)

    def counts_of(verdict):
        per_tile = (verdict.to(torch.int32) * real).sum(dim=1, dtype=torch.int32)
        return per_tile.repeat_interleave(tile)

    t_seed = torch.where(live, INF, _BIG_NEG)
    f_seed = torch.full_like(live, -1, dtype=torch.int32)
    verdict = fine_hit_mask(o_p, d_p, clusters, tile, live=live)
    t, face = sweep(o_p, d_p, tab, verdict, tile, t_seed, f_seed, None)
    out = [t[:flat], face[:flat]]
    n_tests = counts_of(verdict) if with_counts else None
    if light_pos is not None:
        hit = (t < INF) & (t > 0.0) & live
        h = o_p + d_p * torch.where(hit, t, 1.0)
        lv = Vec3(light_pos.x - h.x, light_pos.y - h.y, light_pos.z - h.z)
        t_light = safe_sqrt(lv.length2())
        s = lv * safe_div(1.0, t_light)
        t_cap = torch.where(hit, t_light, 0.0).reshape(-1, tile).amax(dim=1)
        occ_seed = torch.where(hit, 0.0, 1.0)
        verdict_sh = fine_hit_mask(h, s, clusters, tile, t_cap=t_cap, live=hit)
        occ = sweep(h, s, tab, verdict_sh, tile, occ_seed, None, t_light)
        out.append((occ > 0.0)[:flat])
        if with_counts:
            n_tests = n_tests + counts_of(verdict_sh)
    if with_counts:
        out.append(n_tests[:flat])
    return tuple(out)


def intersect_gated_plain(o: Vec3, d: Vec3, tris, clusters, light_pos=None, alive=None,
                          rows: int = 8, with_counts: bool = False):
    """K3's plain version: ``intersect_gated``'s contract on any device."""
    return _gated(_sweep_plain, o, d, tris, clusters, light_pos, alive, rows, with_counts)


def intersect_gated(o: Vec3, d: Vec3, tris, clusters, light_pos=None, alive=None,
                    rows: int = 8, with_counts: bool = False):
    """Nearest hit by the gated sweep (``pallas_gated.py::intersect_gated``).

    ``o``, ``d``: (B,) rays; ``tris``: the scene's TrianglesSoA (cluster
    order); ``clusters``: its ``scene.ClusterTables`` (64-face clusters);
    ``light_pos``: a Vec3 of 0-d tensors (light 0) for the NEE shadow pass;
    ``alive``: (B,) bool, dead lanes cost nothing, widen no frustum and
    return face -1; ``rows``: rays per tile / 128, the frustum and gate
    granularity.

    Returns ``(t, face[, occluded][, n_tests])``: face -1 on a miss, the
    first face in memory order winning ties; ``t`` +inf on a miss and
    -3e38 on a dead lane; ``n_tests`` the exact executed real-face tests
    per lane. A CUDA tensor launches K3 or raises; a CPU tensor runs the
    plain version. Not differentiable: callers re-evaluate the winner."""
    dev = o.x.device
    if dev.type == "cpu":
        sweep = _sweep_plain
    elif dev.type == "cuda":
        sweep = _sweep_kernel
    else:
        raise ValueError(f"intersect_gated runs on CUDA or CPU tensors, not {dev}")
    return _gated(sweep, o, d, tris, clusters, light_pos, alive, rows, with_counts)
