"""Kernels K5 and K5m: the row sweep, CUDA for Hopper, and their plain
PyTorch versions.

K5 replaces ``pbr_tpu/ops/pallas_sweep.py::_kernel_rows`` (the slotted row
sweep, launched by ``::_build_call``) with ``::_section`` and
``::_row_done``; K5m replaces ``::_kernel_masked_rows`` (launched by
``::_build_call_masked``). This module is the counterpart of that file's
wrapper, ``intersect_sweep``, with its contract. The source is
``pbr_tpu_torch/csrc/row_sweep.cu``, whose header says what bounds the
kernels on the card and how their design answers that.

The scene's faces are cut into lin clusters of 128 (``accel/clusters.py``),
each with a (16, 128) table of the linear form's per-face constants, which
the kernels read face-major: ``clusters.lin`` is a transposed view of the
contiguous (CL, 128, 16) ``SceneParams.clu_lin_fm`` that ``to_torch``
builds once a scene, and the plain versions read the same values. A ray
tile is ``TILE`` = 256 rays in ``GROUPS`` = 8 rows of 32 (the JAX wrapper's
defaults, fixed here; one thread block a tile, which deals each row's
faces to all eight warps), and every row has its own frustum verdicts:

- **K5** (more than 48 lin clusters) sweeps the tile's candidate list
  (``ops/cull.py::candidates_rows``: superclusters near to far, expanded to
  their lin clusters, each entry with the rows whose frustum hits it); a
  row runs an entry only where its bit is set. With more than 96 lin
  clusters the rays are first sorted by ``coherence_keys``, and a row stops
  once every ray's best t (any-hit: every unoccluded ray's light distance)
  is at most the next slot's entry bound. Its blocks take the tiles
  heaviest first (``row_order``);
- **K5m** (at most 48 lin clusters) visits every lin cluster in ascending
  order, each row gated by its bit of ``ops/cull.py::row_hit_words``.

Both keep (t, face)-lexicographic minima, so the first face in memory order
wins ties whatever the order of the sweep. Each runs a nearest pass seeded
with t = +inf (live lanes) or -3e38 (dead lanes, which then never update)
and face -1; with a light, an any-hit pass follows on the derived shadow
rays, with the verdicts capped by each row's longest shadow ray, dead and
missed lanes out of the frustums, and those lanes seeded occluded.

- ``intersect_sweep(o, d, clusters, light_pos=None, alive=None,
  with_counts=False)`` is the wrapper: for CUDA tensors it launches the
  kernels (or raises); for CPU tensors — and only for them — it runs the
  plain versions. ``launches`` counts kernel launches per instance.
- ``intersect_sweep_plain`` is the same function with the plain sweeps on
  any device: slot by slot (or lin cluster by lin cluster), only the rows
  that run are computed, each element running the kernels' per-face
  expression (``ops/cuda_intersect.py::mt_lin``) in their operation order,
  so on the card the two agree bitwise.

After the global coherence sort, each pass builds its lists one chunk of
``SWEEP_CHUNK_RAYS`` = 262,144 rays (whole tiles) at a time, as JAX's
``lax.map`` does (131,072 rays there, a budget of the TPU's scalar memory):
here the chunks bound the lists' (rows x 8, CL) temporaries, and the
joined lists (a few MB) feed one launch a pass over all tiles, since a
chunk of 1,024 tiles would fill only a few waves of the card. The chunk is
the largest of those measured (``tools/sweep_chunks.py``) that keeps
soup:100000's 1024² ``sweep`` frame within 5 GiB; fewer chunks cost fewer
launches. No answer changes: every list, verdict and shadow ``t_cap`` is
per tile or per row.

Three parts of the JAX wrapper are not ported, and none changes an answer:

- the ``_sweep_rounds`` while-loop over rounds of ``slots`` candidate
  slots (``pallas_cull.py:339``): one launch sweeps every slot, and the
  in-kernel row early-out, with the same criterion, subsumes the round
  boundary. So there is no ``slots`` argument, and no ``tile``,
  ``groups`` or ``sort``: the tiling is fixed, and the sort and the
  early-out both follow the lin cluster count;
- ``interpret``, a Pallas setting;
- the ``vma`` plumbing, which only shard_map needs.
"""

from __future__ import annotations

import ctypes

import torch

from pbr_tpu_torch.ops import count_launch
from pbr_tpu_torch.ops.cuda_intersect import check_rays, cross_od, load, mt_lin
from pbr_tpu_torch.ops.cull import candidates_rows, coherence_keys, row_hit_words
from pbr_tpu_torch.ops.intersect import INF
from pbr_tpu_torch.ops.vec import Vec3, f32, safe_div, safe_sqrt

MASKED_MAX_LIN = 48  # K5m up to this many lin clusters, K5 above (pallas_sweep.py:66)
SORT_MIN_LIN = 96  # sort and early-out above this many (pallas_sweep.py:378-379, :471)
TILE = 256  # rays a tile, one thread block of the kernels
GROUPS = 8  # rows a tile
ROW = TILE // GROUPS  # rays a row
LIN = 128  # faces a lin cluster
# Rays a chunk of the lists, whole tiles (pallas_sweep.py:330-332 has 131,072)
SWEEP_CHUNK_RAYS = 262_144
_BIG = f32(3.0e38)
_BIG_NEG = f32(-3.0e38)
# Plain version: rows per step are capped so that a (rows, ROW, LIN)
# temporary holds at most this many elements.
_PLAIN_ELEMS = 1 << 22

# Kernel launches by intersect_sweep, per instance. CPU calls and launches
# under capture do not count (``ops.counts`` adds a CUDA graph's at its
# replays).
launches = {"K5": 0, "K5 any-hit": 0, "K5m": 0, "K5m any-hit": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# rays (6), t_limit, lin, n_lin, n_tiles, cand, cnt, tent, order, early_out,
# seed_t, seed_f, t_out, f_out, occ_out, stream
_SLOTTED_ARGTYPES = [_P] * 8 + [_I] * 2 + [_P] * 4 + [_I] + [_P] * 6
# rays (6), t_limit, lin, n_lin, n_tiles, words, seed_t, seed_f, t_out,
# f_out, occ_out, stream
_MASKED_ARGTYPES = [_P] * 8 + [_I] * 2 + [_P] * 7


class _RowState:
    """The running (t, face) minima, or the 0/1 occlusion, of a pass: what
    the kernels keep in registers, here (rows, ROW) tensors."""

    def __init__(self, o: Vec3, d: Vec3, t_limit, seed_t, seed_f):
        rows = lambda a: a.reshape(-1, ROW)  # noqa: E731
        self.o, self.d = Vec3(*map(rows, o)), Vec3(*map(rows, d))
        self.c = cross_od(self.o, self.d)
        self.any_hit = t_limit is not None
        self.t_limit = rows(t_limit) if self.any_hit else None
        self.best = rows(seed_t).clone()
        self.face = None if self.any_hit else rows(seed_f).clone()

    def sweep(self, lin, rows, cids, work=None):
        """Sweep lin cluster ``cids[i]`` for row ``rows[i]`` (1-D int64)."""
        if work is not None:
            work.append((rows, cids))
        step = max(1, _PLAIN_ELEMS // (ROW * LIN))
        fidx = torch.arange(LIN, dtype=torch.int32, device=lin.device)
        for k in range(0, rows.shape[0], step):
            rw, cd = rows[k:k + step], cids[k:k + step]
            tab = lin[cd].transpose(0, 1)[:, :, None, :]  # (16, k, 1, LIN)
            ray = lambda v: Vec3(*(a[rw][:, :, None] for a in v))  # noqa: E731
            t, valid = mt_lin(ray(self.o), ray(self.d), ray(self.c), tab)  # (k, ROW, LIN)
            if self.any_hit:
                occ_new = (valid & (t < self.t_limit[rw][:, :, None])).any(dim=2)
                self.best[rw] = torch.maximum(self.best[rw], occ_new.to(torch.float32))
                continue
            tt = torch.where(valid, t, INF)
            tmin = tt.amin(dim=2)
            fsub = torch.where(tt == tmin[:, :, None], fidx, 1 << 30).amin(dim=2)
            fid = cd.to(torch.int32)[:, None] * LIN + fsub
            tb, fb = self.best[rw], self.face[rw]
            better = (tmin < INF) & ((tmin < tb) | ((tmin == tb) & (fid < fb)))
            self.best[rw] = torch.where(better, tmin, tb)
            self.face[rw] = torch.where(better, fid, fb)

    def done(self, rows, bound):
        """``_row_done`` for ``rows``: every ray's best t (any-hit: every
        unoccluded ray's t_limit) at most ``bound``."""
        best = self.best[rows]
        key = torch.where(best > 0.0, _BIG_NEG, self.t_limit[rows]) if self.any_hit else best
        return key.amax(dim=1) <= bound

    def result(self):
        if self.any_hit:
            return self.best.reshape(-1)
        return self.best.reshape(-1), self.face.reshape(-1)


def _row_bits(x: torch.Tensor, lo: int) -> torch.Tensor:
    """(T, GROUPS) bool: bits lo..lo + 7 of one int32 a tile, row g's at
    lo + g."""
    g = torch.arange(GROUPS, dtype=torch.int32, device=x.device)
    return ((x[:, None] >> (lo + g)) & 1) != 0


def _slotted_plain(o, d, t_limit, lin, cand, cnt, tent, early_out, seed_t, seed_f, work=None):
    """K5 in torch ops: walk the slots in order; at each slot only the rows
    that run (slot within ``cnt``, row bit set, row not done) sweep the
    slot's lin cluster, so the cost follows the executed work. ``work``:
    a list that receives each step's rows and lin cluster ids, one a
    (row, slot) pair run."""
    st = _RowState(o, d, t_limit, seed_t, seed_f)
    n_tiles, c = cand.shape
    tile_of = torch.arange(n_tiles * GROUPS, device=cand.device) // GROUPS
    done = torch.zeros(n_tiles * GROUPS, dtype=torch.bool, device=cand.device)
    if early_out and n_tiles:
        # Rows whose seeds already beat the first entry bound skip everything.
        done = st.done(slice(None), tent[tile_of, 0])
    for l in range(min(c, int(cnt.max()) if n_tiles else 0)):
        entry = cand[:, l]
        run = ((l < cnt)[:, None] & _row_bits(entry, 16)).reshape(-1) & ~done
        rows = torch.nonzero(run).flatten()
        if rows.numel() == 0:
            continue
        st.sweep(lin, rows, (entry[tile_of[rows]] & 0xFFFF).long(), work)
        if early_out:
            done[rows] = st.done(rows, tent[tile_of[rows], l + 1])
    return st.result()


def _masked_plain(o, d, t_limit, lin, words, seed_t, seed_f, work=None):
    """K5m in torch ops: lin cluster by lin cluster in ascending order,
    only the rows whose bit is set."""
    st = _RowState(o, d, t_limit, seed_t, seed_f)
    for c in range(lin.shape[0]):
        rows = torch.nonzero(_row_bits(words[:, c // 2], (c % 2) * 8).reshape(-1)).flatten()
        if rows.numel():
            st.sweep(lin, rows, torch.full_like(rows, c), work)
    return st.result()


def _launch(name, symbol, argtypes, o, d, t_limit, lin, gate_args, seed_t, seed_f):
    """One launch of a K5/K5m instance on whole tiles of contiguous rays;
    returns the pass's outputs."""
    dev = o.x.device
    n = o.x.shape[0]
    any_hit = t_limit is not None
    o, d = Vec3(*(a.contiguous() for a in o)), Vec3(*(a.contiguous() for a in d))
    t_limit = t_limit.contiguous() if any_hit else None
    seed_t = seed_t.contiguous()
    seed_f = None if any_hit else seed_f.contiguous()
    t_out = torch.empty((0 if any_hit else n,), dtype=torch.float32, device=dev)
    f_out = torch.empty((0 if any_hit else n,), dtype=torch.int32, device=dev)
    occ = torch.empty((n if any_hit else 0,), dtype=torch.int32, device=dev)
    lib = load("row_sweep", symbol, argtypes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, symbol)(
            *(a.data_ptr() for a in (*o, *d)), t_limit.data_ptr() if any_hit else None,
            lin.data_ptr(), lin.shape[0], n // TILE, *gate_args,
            seed_t.data_ptr(), None if any_hit else seed_f.data_ptr(),
            t_out.data_ptr(), f_out.data_ptr(), occ.data_ptr(), stream,
        )
    name = name + (" any-hit" if any_hit else "")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    count_launch(launches, name)
    return occ.to(torch.float32) if any_hit else (t_out, f_out)


def listed_rows(cand: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """(T, GROUPS) int32: each tile's listed (row, slot) pairs by row, the
    row's bit (16 + g) over the slots within ``cnt``."""
    slots = torch.arange(cand.shape[1], device=cand.device)[None, :] < cnt[:, None]
    bits = torch.where(slots, (cand >> 16) & 0xFF, 0).to(torch.uint8)
    g = torch.arange(GROUPS, dtype=torch.uint8, device=cand.device)
    return ((bits[:, :, None] >> g) & 1).sum(dim=1, dtype=torch.int32)


def row_order(cand: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """(T,) int32: the tiles by listed (row, slot) pairs (``listed_rows``),
    most first, ties in ascending order. K5's block b sweeps tile
    ``order[b]``, so the longest lists start in the first wave."""
    listed = listed_rows(cand, cnt).sum(dim=1)
    return torch.argsort(listed, descending=True, stable=True).to(torch.int32)


def _slotted_kernel(o, d, t_limit, lin, cand, cnt, tent, early_out, seed_t, seed_f,
                    order=None):
    """``_slotted_plain``'s contract, by a launch of kernel K5; ``order``:
    the tiles' order (default ``row_order``)."""
    cand, cnt, tent = (a.contiguous() for a in (cand, cnt, tent))
    order = row_order(cand, cnt) if order is None else order.contiguous()
    gate = (cand.data_ptr(), cnt.data_ptr(), tent.data_ptr(), order.data_ptr(), int(early_out))
    return _launch("K5", "pbr_row_sweep", _SLOTTED_ARGTYPES, o, d, t_limit, lin, gate, seed_t,
                   seed_f)


def _masked_kernel(o, d, t_limit, lin, words, seed_t, seed_f):
    """``_masked_plain``'s contract, by a launch of kernel K5m."""
    words = words.contiguous()
    return _launch("K5m", "pbr_row_sweep_masked", _MASKED_ARGTYPES, o, d, t_limit, lin,
                   (words.data_ptr(),), seed_t, seed_f)


def _per_ray(per_row: torch.Tensor) -> torch.Tensor:
    """(T, GROUPS) swept lin clusters a row -> (T * TILE,) face tests a ray."""
    return per_row.reshape(-1).repeat_interleave(ROW) * LIN


def _masked_counts(words: torch.Tensor) -> torch.Tensor:
    """The verdict counts of a K5m pass (pallas_sweep.py:434-443): every set
    row bit, times LIN."""
    g = torch.arange(GROUPS, dtype=torch.int32, device=words.device)
    w = words[:, :, None]
    return _per_ray((((w >> g) & 1) + ((w >> (g + 8)) & 1)).sum(dim=1, dtype=torch.int32))


def _slotted_counts(cand: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The verdict counts of a K5 pass (pallas_sweep.py:453-463): the row
    bits of the listed slots, times LIN; early-out savings are not
    subtracted."""
    return _per_ray(listed_rows(cand, cnt))


def _check_lin(clusters, dev) -> torch.Tensor:
    """The scene's lin tables, checked: (CL, 16, 128) float32 on ``dev``
    with CL <= 2**16 (ids fill 16 bits of an entry), stored face-major
    (``lin.transpose(1, 2)`` contiguous: ``to_torch``'s ``clu_lin_fm``),
    the one layout the kernels read; raises ``ValueError`` when the
    clusters carry none."""
    if clusters is None or clusters.lin is None:
        raise ValueError(
            "mode='sweep' needs a scene whose clusters carry row-sweep lin tables; "
            "rebuild via scene/build.py (build_scene attaches them) or "
            "accel.clusters.build_clusters.")
    lin = clusters.lin
    face_major = lin.transpose(1, 2).is_contiguous()
    if lin.device != dev or lin.dtype != torch.float32 or not face_major:
        raise ValueError(f"lin tables must be float32 on {dev}, stored face-major (a "
                         f"transposed view of a contiguous (CL, 128, 16) table)")
    if lin.dim() != 3 or lin.shape[1:] != (16, LIN) or not 0 < lin.shape[0] <= 2**16:
        raise ValueError(f"lin tables must be (CL, 16, {LIN}) with 0 < CL <= 65536, not "
                         f"{tuple(lin.shape)}")
    return lin


def _sweep(slotted, masked, o: Vec3, d: Vec3, clusters, light_pos, alive, with_counts):
    check_rays("intersect_sweep", o, d)
    dev = o.x.device
    if alive is not None and (alive.dtype != torch.bool or alive.shape != o.x.shape
                              or alive.device != dev):
        raise ValueError(f"alive must be a bool tensor of the rays' shape on {dev}")
    lin = _check_lin(clusters, dev)
    cl = lin.shape[0]
    sort = early_out = cl > SORT_MIN_LIN
    flat = o.x.shape[0]
    pad = (-flat) % TILE

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

    def chunked(lists, ov, dv, t_cap, live_p):
        """``lists`` (``candidates_rows`` or ``row_hit_words``) one chunk of
        whole tiles at a time, joined along the tiles."""
        n = ov.x.shape[0]
        step = max(TILE, SWEEP_CHUNK_RAYS // TILE * TILE)
        parts = []
        for lo in range(0, max(n, 1), step):  # one empty chunk when there are no rays
            hi = min(lo + step, n)
            cut = lambda v: Vec3(*(a[lo:hi] for a in v))  # noqa: E731
            cap = None if t_cap is None else t_cap[lo // ROW:hi // ROW]
            parts.append(lists(cut(ov), cut(dv), clusters, TILE, GROUPS, t_cap=cap,
                               live=live_p[lo:hi]))
        if len(parts) == 1:
            return parts[0]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(p) for p in zip(*parts))
        return torch.cat(parts)

    def run_pass(ov, dv, t_limit, seed_t, seed_f, t_cap, live_p):
        if cl <= MASKED_MAX_LIN:
            words = chunked(row_hit_words, ov, dv, t_cap, live_p)
            tests = _masked_counts(words) if with_counts else None
            return masked(ov, dv, t_limit, lin, words, seed_t, seed_f), tests
        cand, cnt, tent = chunked(candidates_rows, ov, dv, t_cap, live_p)
        tests = _slotted_counts(cand, cnt) if with_counts else None
        tent = torch.cat([tent, tent.new_full((tent.shape[0], 1), _BIG)], dim=1)
        return slotted(ov, dv, t_limit, lin, cand, cnt, tent, early_out, seed_t, seed_f), tests

    t_seed = torch.where(live, INF, _BIG_NEG)
    f_seed = torch.full((flat + pad,), -1, dtype=torch.int32, device=dev)
    (t, face), tests = run_pass(o_p, d_p, None, t_seed, f_seed, None, live)
    occ = None
    if light_pos is not None:
        # The shadow rays: the guarded math of pallas_sweep.py:500-526.
        hit = (t < INF) & (t > 0.0) & live
        h = o_p + d_p * torch.where(hit, t, 1.0)
        lv = Vec3(light_pos.x - h.x, light_pos.y - h.y, light_pos.z - h.z)
        t_light = safe_sqrt(lv.length2())
        s = lv * safe_div(1.0, t_light)
        t_cap = torch.where(hit, t_light, 0.0).reshape(-1, ROW).amax(dim=1)
        occ_seed = torch.where(hit, 0.0, 1.0)
        occ, tests_sh = run_pass(h, s, t_light, occ_seed, f_seed, t_cap, hit)
        occ = occ > 0.0
        if with_counts:
            tests = tests + tests_sh
    if inv_perm is not None:
        t, face = t[inv_perm], face[inv_perm]
        occ = None if occ is None else occ[inv_perm]
        tests = None if tests is None else tests[inv_perm]
    out = [t[:flat], face[:flat]]
    if occ is not None:
        out.append(occ[:flat])
    if with_counts:
        out.append(tests[:flat])
    return tuple(out)


def intersect_sweep_plain(o: Vec3, d: Vec3, clusters, light_pos=None, alive=None,
                          with_counts: bool = False):
    """K5's and K5m's plain version: ``intersect_sweep``'s contract on any
    device."""
    return _sweep(_slotted_plain, _masked_plain, o, d, clusters, light_pos, alive, with_counts)


def intersect_sweep(o: Vec3, d: Vec3, clusters, light_pos=None, alive=None,
                    with_counts: bool = False):
    """Nearest hit by the row sweep (``pallas_sweep.py::intersect_sweep``).

    ``o``, ``d``: (B,) rays; ``clusters``: the scene's
    ``scene.ClusterTables`` with its lin tables; ``light_pos``: a Vec3 of
    0-d tensors (light 0) for the NEE shadow pass; ``alive``: (B,) bool,
    dead lanes keep their rays but add no frustum demand, are seeded
    closed, cost nothing and return face -1. Rays go in tiles of ``TILE``;
    with more than 96 lin clusters they are sorted by ``coherence_keys``
    first.

    Returns ``(t, face[, occluded][, tests])``: face -1 on a miss, the first
    face in memory order winning ties; ``t`` +inf on a miss and -3e38 on a
    dead lane. ``with_counts`` appends the per-ray int32 face tests the
    row's verdicts ask for (both passes), the JAX package's counter: every
    set row bit (K5m) or the row bits of the listed slots (K5), times 128,
    early-out savings not subtracted. A CUDA tensor launches K5 (more than
    48 lin clusters) or K5m, or raises; a CPU tensor runs the plain
    versions. Not differentiable: callers re-evaluate the winner."""
    dev = o.x.device
    if dev.type == "cpu":
        return intersect_sweep_plain(o, d, clusters, light_pos, alive, with_counts)
    if dev.type != "cuda":
        raise ValueError(f"intersect_sweep runs on CUDA or CPU tensors, not {dev}")
    return _sweep(_slotted_kernel, _masked_kernel, o, d, clusters, light_pos, alive,
                  with_counts)
