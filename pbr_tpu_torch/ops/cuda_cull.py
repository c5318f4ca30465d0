"""Kernels K4 and K4m: the cull-and-sweep intersector, CUDA for Hopper, and
their plain PyTorch versions.

K4 replaces ``pbr_tpu/ops/pallas_cull.py::_kernel`` (the slotted sweep,
launched by ``::_build_call``) around ``::_dot_k``; K4m replaces
``::_kernel_masked`` (launched by ``::_build_call_masked``). This module is
the counterpart of that file's wrapper, ``intersect_cull``, with its
contract. The source is ``pbr_tpu_torch/csrc/cull_intersect.cu``, whose
header says what bounds the kernels on the card and how their design
answers that.

The scene is cut into clusters of S = 64 or 128 faces
(``accel/clusters.py``), each with a (16, 4S) coefficient block; contracted
with a ray's features ``[o, d, o x d, 1, t_limit]`` (rows 0-10) it gives
det, tnum, unum and vnum of the linear-form Moller-Trumbore for the S
faces. Only 19 of a face's 44 entries in rows 0-10 can be nonzero:
``compact_table`` repacks them once a scene (``scene/device.py``) into the
(C, S, 20) table the kernels and the plain versions read, and each sum
leaves out only the zero terms, in ascending row order, which changes no
gate and no winning t for finite rays (the source's header says why). Per
tile of ``TILE`` = 256 rays (the JAX wrapper's default, fixed here):

- **K4** (more than 48 clusters) sweeps the tile's candidate list
  (``ops/cull.py::candidates``: superclusters near to far, the fine
  clusters the frustum misses marked ``CAND_MISS`` and skipped), keeping
  (t, face)-lexicographic minima, so the first face in memory order wins
  ties whatever the order of the sweep. With more than 96 clusters the
  rays are first sorted by ``coherence_keys``, and a tile stops once every
  ray's best t (any-hit: every unoccluded ray's light distance) is at most
  the next slot's entry bound. The kernel takes the tiles heaviest first
  (``tile_order``), two threads a ray;
- **K4m** (at most 48 clusters) visits every cluster in ascending order,
  gated by the tile's ``fine_hit_mask`` verdict.

Each runs a nearest pass seeded with t = +inf (live lanes) or -3e38 (dead
lanes, which then never update) and face -1; with a light, an any-hit pass
follows on the derived shadow rays, with the verdicts capped by each tile's
longest shadow ray and the lanes that missed seeded occluded.

- ``intersect_cull(o, d, clusters, light_pos=None, alive=None,
  precision='highest')`` is the wrapper: for CUDA tensors it
  launches the kernels (or raises); for CPU tensors — and only for them —
  it runs the plain sweeps. ``launches`` counts kernel launches per
  instance.
- ``intersect_cull_plain`` is the same function with the plain sweeps on
  any device: slot by slot (or cluster by cluster), only the tiles whose
  slot runs are computed, each element running the kernels' per-face
  expression in their operation order, so on the card the two agree
  bitwise.

Four parts of the JAX wrapper are not ported, and none changes an answer:

- the ``lax.map`` ray chunking (``CULL_CHUNK_RAYS``): a budget of the
  TPU's scalar memory for the candidate tables. Chunks are whole tiles;
- the ``_sweep_rounds`` while-loop over rounds of ``slots`` candidate
  slots: one launch sweeps every slot, and the in-kernel early-out, with
  the same criterion, subsumes the round boundary. So there is no
  ``slots`` argument, and no ``tile`` or ``sort``: every tile is 256
  rays, and the sort and the early-out both follow the cluster count;
- the 16-bits-a-word packing of K4m's verdicts (``_kernel_masked``): a
  TPU SMEM sign rule. Verdicts travel as bytes, as in K3;
- the ``vma`` plumbing, which only shard_map needs.

``precision`` other than 'highest' (float32 arithmetic) raises
``NotImplementedError``: 'high', 'default' and 'tri' are TPU matrix-unit
pass settings, and ``_dot_k``'s docstring records that 'tri' flips
self-hit gates.
"""

from __future__ import annotations

import ctypes

import torch

from pbr_tpu_torch.ops import count_launch
from pbr_tpu_torch.ops.cuda_intersect import check_rays, cross_od, load
from pbr_tpu_torch.ops.cull import CAND_MISS, candidates, coherence_keys, fine_hit_mask
from pbr_tpu_torch.ops.intersect import EPS5, INF
from pbr_tpu_torch.ops.vec import Vec3, f32, safe_div, safe_sqrt

MASKED_MAX_CLUSTERS = 48  # K4m up to this many clusters, K4 above
SORT_MIN_CLUSTERS = 96  # sort and early-out above this many (more than one TPU round)
FEATURE_ROWS = 11  # rows 0-10 of the coefficient block: o, d, o x d, 1, t_limit
TILE = 256  # rays a tile: one thread block of the kernels (K4's has two threads a ray)
# The compact table: per face, the entries of the coefficient block that the
# layout (accel/clusters.py) can make nonzero, as (group, row), each sum's
# rows ascending: det = d.m, tnum = -o.m + km (row 9's feature is 1), unum =
# -d.w + c.e2, vnum = -d.q - c.e1; then one zero, so a face is five float4s.
COMPACT_TERMS = ((0, 3), (0, 4), (0, 5),
                 (1, 0), (1, 1), (1, 2), (1, 9),
                 (2, 3), (2, 4), (2, 5), (2, 6), (2, 7), (2, 8),
                 (3, 3), (3, 4), (3, 5), (3, 6), (3, 7), (3, 8))
COMPACT = 20  # floats a face of the compact table
_BIG = f32(3.0e38)
_BIG_NEG = f32(-3.0e38)
# Plain version: tiles per step are capped so that a (tiles, TILE, S)
# temporary holds at most this many elements.
_PLAIN_ELEMS = 1 << 22

# Kernel launches by intersect_cull, per instance. CPU calls and launches
# under capture do not count (``ops.counts`` adds a CUDA graph's at its
# replays).
launches = {"K4": 0, "K4 any-hit": 0, "K4m": 0, "K4m any-hit": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# rays (6), t_limit, table, C, S, n_tiles, cand, cnt, tent, order, early_out,
# seed_t, seed_f, t_out, f_out, occ_out, stream
_SLOTTED_ARGTYPES = [_P] * 8 + [_I] * 3 + [_P] * 4 + [_I] + [_P] * 6
# rays (6), t_limit, table, C, S, n_tiles, mask, seed_t, seed_f, t_out,
# f_out, occ_out, stream
_MASKED_ARGTYPES = [_P] * 8 + [_I] * 3 + [_P] * 7


def _features(o: Vec3, d: Vec3, t_limit) -> list:
    """The ray features of rows 0-10: o, d, c = o x d, 1 and t_limit (0 in
    the nearest pass), each an (N,) tensor."""
    c = cross_od(o, d)
    ones = torch.ones_like(o.x)
    tlim = torch.zeros_like(o.x) if t_limit is None else t_limit
    return [*o, *d, *c, ones, tlim]


def compact_table(coeffs: torch.Tensor) -> torch.Tensor:
    """The (C, S, 20) float32 compact table of (C, 16, 4S) coefficient
    blocks, face-major: face j of cluster c holds the ``COMPACT_TERMS``
    entries, then 0. Raises ``ValueError`` where an entry of rows 0-10 that
    it drops is not exactly 0 (row 11, the AABB lanes, is not read)."""
    c, rows, lanes = coeffs.shape
    if rows != 16 or lanes % 4:
        raise ValueError(f"coefficient blocks must be (C, 16, 4S), not {tuple(coeffs.shape)}")
    blk = coeffs[:, :FEATURE_ROWS].reshape(c, FEATURE_ROWS, 4, lanes // 4)  # (C, row, group, S)
    keep = torch.zeros((FEATURE_ROWS, 4), dtype=torch.bool)
    for g, r in COMPACT_TERMS:
        keep[r, g] = True
    dropped = blk[:, ~keep.to(coeffs.device)]
    if (dropped != 0).any():
        raise ValueError("coefficient blocks hold a nonzero entry where the layout has none: "
                         "the compact table would drop it")
    cols = [blk[:, r, g] for g, r in COMPACT_TERMS]
    return torch.stack([*cols, torch.zeros_like(cols[0])], dim=2).contiguous()


def _face_test(tab: torch.Tensor, feats: torch.Tensor):
    """t and validity of each (ray, face) pair of a group of tiles.

    ``tab`` (k, S, 20): each tile's cluster of the compact table; ``feats``
    (11, k, TILE). det, tnum, unum and vnum sum the compact terms left to
    right, as the kernel does (km is added as it is: its feature is 1).
    Returns ``(t, valid)`` of (k, TILE, S)."""
    c = [tab[:, None, :, j] for j in range(len(COMPACT_TERMS))]  # (k, 1, S)
    f = [feats[i, :, :, None] for i in range(9)]  # (k, TILE, 1)
    det = c[0] * f[3] + c[1] * f[4] + c[2] * f[5]
    tnum = c[3] * f[0] + c[4] * f[1] + c[5] * f[2] + c[6]
    unum = c[7] * f[3] + c[8] * f[4] + c[9] * f[5] + c[10] * f[6] + c[11] * f[7] + c[12] * f[8]
    vnum = c[13] * f[3] + c[14] * f[4] + c[15] * f[5] + c[16] * f[6] + c[17] * f[7] + c[18] * f[8]
    inv = 1.0 / det
    t = tnum * inv
    u = unum * inv
    v = vnum * inv
    return t, (t >= EPS5) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


class _SweepState:
    """The running (t, face) minima, or the 0/1 occlusion, of a pass: what
    the kernel keeps in registers, here (T, TILE) tensors."""

    def __init__(self, feats, seed_t, seed_f, any_hit):
        self.feats = torch.stack(feats).reshape(FEATURE_ROWS, -1, TILE)  # (11, T, TILE)
        self.best = seed_t.reshape(-1, TILE).clone()
        self.face = None if any_hit else seed_f.reshape(-1, TILE).clone()
        self.any_hit = any_hit

    def sweep(self, table, tiles, cids):
        """Sweep cluster ``cids[i]`` of the compact table for tile
        ``tiles[i]`` (1-D int64)."""
        s = table.shape[1]
        step = max(1, _PLAIN_ELEMS // (TILE * s))
        for k in range(0, tiles.shape[0], step):
            tl, cl = tiles[k:k + step], cids[k:k + step]
            t, valid = _face_test(table[cl], self.feats[:, tl])
            if self.any_hit:
                occ_new = (valid & (t < self.feats[10, tl][:, :, None])).any(dim=2)
                self.best[tl] = torch.maximum(self.best[tl], occ_new.to(torch.float32))
                continue
            tt = torch.where(valid, t, INF)
            tmin = tt.amin(dim=2)
            rowid = torch.arange(s, dtype=torch.int32, device=tt.device)
            fsub = torch.where(tt == tmin[:, :, None], rowid, 1 << 30).amin(dim=2)
            fid = cl.to(torch.int32)[:, None] * s + fsub
            tb, fb = self.best[tl], self.face[tl]
            better = (tmin < INF) & ((tmin < tb) | ((tmin == tb) & (fid < fb)))
            self.best[tl] = torch.where(better, tmin, tb)
            self.face[tl] = torch.where(better, fid, fb)

    def done(self, tiles, tent_next):
        """The early-out test of ``pallas_cull.py:155-158/177-180`` for
        ``tiles``: every ray's best t (any-hit: every unoccluded ray's
        t_limit) at most the next slot's entry bound."""
        best = self.best[tiles]
        key = torch.where(best > 0.0, _BIG_NEG, self.feats[10, tiles]) if self.any_hit else best
        return key.amax(dim=1) <= tent_next

    def result(self):
        if self.any_hit:
            return self.best.reshape(-1)
        return self.best.reshape(-1), self.face.reshape(-1)


def _slotted_plain(feats, table, cand, cnt, tent, early_out, seed_t, seed_f, any_hit):
    """K4 in torch ops: walk the slots in order; at each slot only the
    tiles whose slot runs (within ``cnt``, no miss bit, not done) sweep
    their candidate, so the cost follows the executed work."""
    st = _SweepState(feats, seed_t, seed_f, any_hit)
    n_tiles, c = cand.shape
    done = torch.zeros(n_tiles, dtype=torch.bool, device=cand.device)
    for l in range(min(c, int(cnt.max()) if n_tiles else 0)):
        run = (l < cnt) & (cand[:, l] < CAND_MISS)
        if early_out:
            run = run & ~done
        tiles = torch.nonzero(run).flatten()
        if tiles.numel() == 0:
            continue
        st.sweep(table, tiles, cand[tiles, l].long())
        if early_out:
            done[tiles] = st.done(tiles, tent[tiles, l + 1])
    return st.result()


def _masked_plain(feats, table, mask, seed_t, seed_f, any_hit):
    """K4m in torch ops: cluster by cluster in ascending order, only the
    tiles whose verdict is set."""
    st = _SweepState(feats, seed_t, seed_f, any_hit)
    for c in range(mask.shape[1]):
        tiles = torch.nonzero(mask[:, c]).flatten()
        if tiles.numel():
            st.sweep(table, tiles, torch.full_like(tiles, c))
    return st.result()


def _launch(name, symbol, argtypes, o, d, t_limit, table, n_tiles, gate_args, seed_t,
            seed_f):
    """One launch of a K4/K4m instance; returns the pass's outputs."""
    dev = o.x.device
    n = o.x.shape[0]
    any_hit = t_limit is not None
    t_out = torch.empty((0 if any_hit else n,), dtype=torch.float32, device=dev)
    f_out = torch.empty((0 if any_hit else n,), dtype=torch.int32, device=dev)
    occ = torch.empty((n if any_hit else 0,), dtype=torch.int32, device=dev)
    lib = load("cull_intersect", symbol, argtypes)
    c, s, _ = table.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, symbol)(
            *(a.data_ptr() for a in (*o, *d)), t_limit.data_ptr() if any_hit else None,
            table.data_ptr(), c, s, n_tiles, *gate_args,
            seed_t.data_ptr(), None if any_hit else seed_f.data_ptr(),
            t_out.data_ptr(), f_out.data_ptr(), occ.data_ptr(), stream,
        )
    name = name + (" any-hit" if any_hit else "")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    count_launch(launches, name)
    return occ.to(torch.float32) if any_hit else (t_out, f_out)


def tile_order(cand: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """(T,) int32: the tiles by listed slots (within ``cnt``, without the
    miss bit), most first, ties in ascending order. K4's block b sweeps
    tile ``order[b]``, so the longest lists start in the first wave."""
    slots = torch.arange(cand.shape[1], device=cand.device)[None, :] < cnt[:, None]
    listed = ((cand < CAND_MISS) & slots).sum(dim=1)
    return torch.argsort(listed, descending=True, stable=True).to(torch.int32)


def _slotted_kernel(feats, table, cand, cnt, tent, early_out, seed_t, seed_f, any_hit):
    """``_slotted_plain``'s contract, by a launch of kernel K4."""
    o, d = Vec3(*feats[0:3]), Vec3(*feats[3:6])
    cand, cnt, tent = (a.contiguous() for a in (cand, cnt, tent))
    order = tile_order(cand, cnt)
    gate = (cand.data_ptr(), cnt.data_ptr(), tent.data_ptr(), order.data_ptr(), int(early_out))
    return _launch("K4", "pbr_cull_slotted", _SLOTTED_ARGTYPES, o, d,
                   feats[10] if any_hit else None, table, cand.shape[0], gate, seed_t,
                   seed_f)


def _masked_kernel(feats, table, mask, seed_t, seed_f, any_hit):
    """``_masked_plain``'s contract, by a launch of kernel K4m."""
    o, d = Vec3(*feats[0:3]), Vec3(*feats[3:6])
    m8 = mask.to(torch.uint8).contiguous()
    return _launch("K4m", "pbr_cull_masked", _MASKED_ARGTYPES, o, d,
                   feats[10] if any_hit else None, table, mask.shape[0], (m8.data_ptr(),),
                   seed_t, seed_f)


def _cull(slotted, masked, o: Vec3, d: Vec3, clusters, light_pos, alive, precision):
    check_rays("intersect_cull", o, d)
    if precision != "highest":
        raise NotImplementedError(
            f"precision {precision!r} is a TPU matrix-unit pass setting; the port "
            f"computes in float32 ('highest') only")
    dev = o.x.device
    if alive is not None and (alive.dtype != torch.bool or alive.shape != o.x.shape
                              or alive.device != dev):
        raise ValueError(f"alive must be a bool tensor of the rays' shape on {dev}")
    table = clusters.compact
    if table.device != dev or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"the compact table must be contiguous float32 on {dev}")
    c = clusters.count
    if table.shape != (c, clusters.size, COMPACT) or clusters.size not in (64, 128):
        raise ValueError(f"the compact table must be (C, S, {COMPACT}) with S 64 or 128, not "
                         f"{tuple(table.shape)}")
    sort = early_out = c > SORT_MIN_CLUSTERS
    flat = o.x.shape[0]
    pad = (-flat) % TILE
    n_tiles = (flat + pad) // TILE

    def prep(a):  # edge padding, as jnp.pad(mode='edge')
        return torch.cat([a, a[-1:].expand(pad)]) if pad and flat else a

    o_p, d_p = Vec3(*map(prep, o)), Vec3(*map(prep, d))
    live = torch.ones((flat,), dtype=torch.bool, device=dev) if alive is None else alive
    live = torch.cat([live, live.new_zeros(pad)])
    inv_perm = None
    if sort and flat:
        perm = torch.argsort(coherence_keys(o_p, d_p, clusters.scene_min, clusters.scene_max),
                             stable=True)
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(perm.shape[0], device=dev)
        o_p, d_p = Vec3(*(a[perm] for a in o_p)), Vec3(*(a[perm] for a in d_p))
        live = live[perm]

    def run_pass(ov, dv, t_limit, seed_t, seed_f, t_cap):
        feats = _features(ov, dv, t_limit)
        any_hit = t_limit is not None
        if c <= MASKED_MAX_CLUSTERS:
            mask = fine_hit_mask(ov, dv, clusters, TILE, t_cap=t_cap)
            return masked(feats, table, mask, seed_t, seed_f, any_hit)
        cand, cnt, tent = candidates(ov, dv, clusters, TILE, t_cap=t_cap)
        tent = torch.cat([tent, tent.new_full((n_tiles, 1), _BIG)], dim=1)
        return slotted(feats, table, cand, cnt, tent, early_out, seed_t, seed_f, any_hit)

    t_seed = torch.where(live, INF, _BIG_NEG)
    f_seed = torch.full((flat + pad,), -1, dtype=torch.int32, device=dev)
    t, face = run_pass(o_p, d_p, None, t_seed, f_seed, None)
    occ = None
    if light_pos is not None:
        # The shadow rays: the guarded math of pallas_cull.py:572-595.
        hit = (t < INF) & (t > 0.0) & live
        h = o_p + d_p * torch.where(hit, t, 1.0)
        lv = Vec3(light_pos.x - h.x, light_pos.y - h.y, light_pos.z - h.z)
        t_light = safe_sqrt(lv.length2())
        s = lv * safe_div(1.0, t_light)
        t_cap = torch.where(hit, t_light, 0.0).reshape(-1, TILE).amax(dim=1)
        occ_seed = torch.where(hit, 0.0, 1.0)
        occ = run_pass(h, s, t_light, occ_seed, f_seed, t_cap) > 0.0
    if inv_perm is not None:
        t, face = t[inv_perm], face[inv_perm]
        occ = None if occ is None else occ[inv_perm]
    out = (t[:flat], face[:flat])
    return out if occ is None else (*out, occ[:flat])


def intersect_cull_plain(o: Vec3, d: Vec3, clusters, light_pos=None, alive=None,
                         precision: str = "highest"):
    """K4's and K4m's plain version: ``intersect_cull``'s contract on any
    device."""
    return _cull(_slotted_plain, _masked_plain, o, d, clusters, light_pos, alive, precision)


def intersect_cull(o: Vec3, d: Vec3, clusters, light_pos=None, alive=None,
                   precision: str = "highest"):
    """Nearest hit by cull-and-sweep (``pallas_cull.py::intersect_cull``).

    ``o``, ``d``: (B,) rays; ``clusters``: the scene's
    ``scene.ClusterTables``; ``light_pos``: a Vec3 of 0-d tensors (light 0)
    for the NEE shadow pass; ``alive``: (B,) bool, dead lanes keep their
    rays (tile frustums stay tight) but are seeded closed, cost nothing and
    return face -1. Rays go in tiles of ``TILE``; with more than 96
    clusters they are sorted by ``coherence_keys`` first.

    Returns ``(t, face[, occluded])``: face -1 on a miss, the first face in
    memory order winning ties; ``t`` +inf on a miss and -3e38 on a dead
    lane. A CUDA tensor launches K4 (more than 48 clusters) or K4m, or
    raises; a CPU tensor runs the plain versions. Not differentiable:
    callers re-evaluate the winner."""
    dev = o.x.device
    if dev.type == "cpu":
        return intersect_cull_plain(o, d, clusters, light_pos, alive, precision)
    if dev.type != "cuda":
        raise ValueError(f"intersect_cull runs on CUDA or CPU tensors, not {dev}")
    return _cull(_slotted_kernel, _masked_kernel, o, d, clusters, light_pos, alive, precision)
