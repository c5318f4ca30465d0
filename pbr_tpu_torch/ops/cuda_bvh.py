"""Kernels K6, K7 and K8: the BVH tree walks, CUDA for Hopper, and their
plain PyTorch version.

- **K6** (``csrc/bvh_packet.cu``) replaces ``pbr_tpu/ops/pallas_bvh.py``'s
  ``_kernel`` (instance "K6 nearest"), ``_kernel_nee`` ("K6 NEE"),
  ``_kernel_shadow`` ("K6 any-hit"), ``_kernel_seeded`` ("K6 seeded") and
  ``_kernel_shadow_seeded`` ("K6 seeded any-hit"), around
  ``_traverse_tile``, the TPU's packet walk. The single-tree instances
  (``packet_kernel``) walk each ray alone, NEE's shadow leg in the same
  loop; the seeded ones (``chain_kernel``) keep a node cursor shared by a
  warp of 32 rays. ``intersect_bvh_packet`` runs K6 on a scene's tree (the
  ``pallas_bvh`` mode); ``intersect_bvh_forest`` chains it over the
  sub-trees of a ``BVHForest`` (``pallas_bvh_forest``): sub-tree 0 by "K6
  nearest" / "K6 any-hit" (``ForestTables.tree(0)``, whose records are
  views of the forest's), then sub-trees 1..K-1 by one launch a pass of the
  seeded instances, which walk them in ascending order over the forest's
  packed records (``ForestTables.node_records``, ``face_records``), each
  seeded by the best so far.
- **K7**, the leaf-slab walk (same source, ``slab_kernel``), replaces
  ``_kernel_hbm`` ("K7 nearest") and ``_kernel_hbm_nee`` ("K7 NEE"),
  around ``_traverse_tile_hbm``: the same walk over the tree's packed
  records, each leaf some lane hits staged in shared memory and its
  (ray, face) tests dealt over the warp (``intersect_bvh_packet_hbm``, the
  ``pallas_bvh_hbm`` mode).
- **K8**, the per-ray walk (``csrc/bvh_walk.cu``), is the H100 form of the
  ``bvh`` mode, which the JAX package runs as an XLA while_loop
  (``pbr_tpu/ops/traverse.py::intersect_bvh``), with its exact ``tests``
  and ``visits`` counters (``intersect_bvh_walk``, instance "K8"); its
  any-hit instance ("K8 any-hit", ``occluded_bvh_walk``) is the ``bvh``
  mode's NEE shadow leg, the bit ``t_sh < t_light`` that the JAX package
  takes from a second nearest search (``pbr_tpu/models/integrator.py:
  352-353``). Every instance reads the tree and its faces as packed
  records (``node_records``, ``face_records``), which
  ``scene/device.py::to_torch`` builds once a scene
  (``BVHTables.node_records``/``face_records``) and ``_check`` requires.

The NEE instances (K6 NEE, K7 NEE) walk the shadow ray only on the lanes
whose nearest walk hit, and give False on the others without a walk: the
integrator reads the bit only where the nearest walk hit, and there it is
the TPU kernels' bit. The plain version does the same.

The sources' headers say what bounds the kernels on the card and how the
designs answer that. Every wrapper takes its rays as six (B,) float32
tensors and an optional (B,) bool ``alive``: a dead lane walks nothing
(``t`` +inf, face -1, not occluded, counts 0). On a CUDA tensor it sorts
the rays by ``ops/cull.py::coherence_keys`` against the tree's root box
(dead lanes last) and launches the kernel over that order, or raises; on a
CPU tensor, and only there, it runs the plain version.

**The plain version** is one function, ``walk_plain``: the per-ray walk in
torch ops, every ray with its own cursor, compacted to the rays still
walking at each step, the leaf faces tested only for the rays that stand
at a hit leaf. It is K8's plain version, and K6's and K7's too: a node's
box holds its children's, so a ray that hits a node hit every node above
it, and a packet visits every node its rays' own walks visit, in the same
order; a ray's answer does not depend on its packet. It follows the
kernels' operation order, so on the card they agree bitwise. Every walk
applies the empty-box guard of ``pallas_bvh.py:110-116`` (bb_min.x <=
bb_max.x), which only the forest's padding nodes fail, so K8's counters
equal the JAX package's on every tree the builders make.

The capacity rules of the TPU kernels are kept, and checked here rather
than found by a crash: a packet walk needs ``packet_fits`` (nodes + faces
<= ``PALLAS_BVH_MAX_ROWS``), a slab walk ``packet_hbm_fits`` (nodes <=
``PACKET_HBM_MAX_NODES``) and ``max_leaf`` <= ``SLAB_MAX_LEAF``. Every
walk tests at most ``max_leaf`` faces a leaf: the entry points given none
take the tree's own bound (``leaf_bound``), and ``_check`` raises where a
bound lies below the tree's largest leaf (``BVHTables.leaf_max``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from pbr_tpu_torch.accel.forest import FOREST_MAX_LEAF
from pbr_tpu_torch.ops import count_launch
from pbr_tpu_torch.ops.cuda_intersect import (
    _shadow_ray,
    check_rays,
    face_records,  # noqa: F401 (the walks' record layout, also cuda_bvh.face_records)
    face_table,
    load,
)
from pbr_tpu_torch.ops.cull import coherence_keys
from pbr_tpu_torch.ops.intersect import EPS5, INF, moller_trumbore, slab_box
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.device import ForestTables

# The TPU kernels' table budgets (pallas_bvh.py:39 and :460), kept so that
# both packages take the same scenes in the same modes.
PALLAS_BVH_MAX_ROWS = 24_576
PACKET_HBM_MAX_NODES = 12_288
# K7 stages up to this many faces a leaf, 12 KB a warp (csrc/bvh_packet.cu).
SLAB_MAX_LEAF = 256
# Plain version: leaf tests per step are cut so that a (rays, faces)
# temporary holds at most this many elements.
_PLAIN_ELEMS = 1 << 22

# K7's and K8's leaf record word: leaf_first << LEAF_COUNT_BITS |
# (leaf_count - 1) (kCountBits of csrc/bvh_walk.cu and bvh_packet.cu).
LEAF_COUNT_BITS = 8

# Kernel launches per instance. CPU calls and launches under capture do not
# count (``ops.counts`` adds a CUDA graph's at its replays).
launches = {"K6 nearest": 0, "K6 NEE": 0, "K6 any-hit": 0, "K6 seeded": 0,
            "K6 seeded any-hit": 0, "K7 nearest": 0, "K7 NEE": 0, "K8": 0, "K8 any-hit": 0}
_K8 = ("K8", "K8 any-hit")
# The seeded chain's instances (chain_kernel).
_SEEDED = ("K6 seeded", "K6 seeded any-hit")
# bvh_packet.cu's mode of each instance but the seeded chain's.
_PACKET_MODES = {"K6 nearest": 0, "K6 NEE": 1, "K6 any-hit": 2, "K7 nearest": 0, "K7 NEE": 1}
_SLAB = ("K7 nearest", "K7 NEE")

_P, _I = ctypes.c_void_p, ctypes.c_int
# mode, rays (6), order, alive, n, node records, n_nodes, face records,
# max_leaf, light, t_limit, t_out, f_out, occ_out, stream
_PACKET_ARGTYPES = [_I] + [_P] * 8 + [_I, _P, _I, _P, _I] + [_P] * 6
# any_hit, rays (6), order, alive, n, node records, n_nodes, n_trees, face
# records, chunk, face_base, max_leaf, t_limit, t_seed, f_seed, occ_seed,
# t_out, f_out, occ_out, stream
_CHAIN_ARGTYPES = [_I] + [_P] * 8 + [_I, _P, _I, _I, _P, _I, _I, _I] + [_P] * 8
# mode, rays (6), order, alive, n, node records, n_nodes, face records,
# max_leaf, light, t_out, f_out, occ_out, stream
_SLAB_ARGTYPES = [_I] + [_P] * 8 + [_I, _P, _I, _P, _I] + [_P] * 5
# rays (6), order, alive, n, node records, n_nodes, face records,
# max_leaf, t_limit, t_out, f_out, occ_out, tests, visits, stream
_WALK_ARGTYPES = [_P] * 8 + [_I, _P, _I, _P, _I] + [_P] * 7


def packet_fits(bvh, tris) -> bool:
    """True when the tree's nodes and the faces fit the packet walk's row
    budget (a ``LinearBVH`` or ``BVHTables``, and the triangles)."""
    return bvh.count + int(tris.mtl.shape[0]) <= PALLAS_BVH_MAX_ROWS


def packet_hbm_fits(bvh) -> bool:
    """True when the tree's nodes fit the slab walk's node budget."""
    return bvh.count <= PACKET_HBM_MAX_NODES


def node_records(tree) -> torch.Tensor:
    """The tree walks' (N, 8) float32 node records of a ``BVHTables``' (3, N)
    and (N,) tables: 32 bytes a node, read as two float4, ``{bb_min, exit}`` and
    ``{bb_max, leaf}``, each int32 word stored as its bits; ``leaf`` is
    ``leaf_first << LEAF_COUNT_BITS | (leaf_count - 1)`` for a leaf and -1
    for an inner node (leaf_first -1, leaf_count 0). Raises where a field
    does not fit: a leaf of no faces or more than 2**LEAF_COUNT_BITS, a
    first face at or above 2**(31 - LEAF_COUNT_BITS), an inner node with a
    count."""
    lf, lc = tree.leaf_first, tree.leaf_count
    leaf = lf >= 0
    bad_leaf = leaf & ((lc < 1) | (lc > 1 << LEAF_COUNT_BITS)
                       | (lf >= 1 << (31 - LEAF_COUNT_BITS)))
    bad_inner = ~leaf & ((lf != -1) | (lc != 0))
    if bool((bad_leaf | bad_inner).any()):
        i = int(torch.nonzero(bad_leaf | bad_inner)[0])
        raise ValueError(
            f"node {i} (leaf_first {int(lf[i])}, leaf_count {int(lc[i])}) does not fit the node "
            f"record: a leaf holds 1..{1 << LEAF_COUNT_BITS} faces from a first face below "
            f"{1 << (31 - LEAF_COUNT_BITS)}, an inner node has leaf_first -1 and leaf_count 0")
    word = torch.where(leaf, (lf << LEAF_COUNT_BITS) | (lc - 1), -1).to(torch.int32)
    return torch.cat([tree.bb_min.T, tree.exit.view(torch.float32)[:, None],
                      tree.bb_max.T, word.view(torch.float32)[:, None]], dim=1).contiguous()


class Walk(NamedTuple):
    """One launch of a tree-walk instance, or the same call of the plain
    version (what ``run`` executes; chip_smoke.py replays them).

    ``kernel``: the instance, a key of ``launches``; ``tree``: a
    ``BVHTables``, or for the seeded instances also a ``ForestTables`` (a
    run of a forest's sub-trees, ``ForestTables.subtrees``, walked in
    ascending order, each seeded by the best so far); ``faces``: the (9, F)
    face table the tree indexes (a column slice of a wider table for a
    forest's sub-trees), face ids written offset by ``face_base`` (and by
    ``i * chunk`` for a forest's sub-tree ``i``); ``order``: the launch order (CUDA
    only; the plain version walks each ray alone); ``light`` (3,) for the
    NEE instances; ``t_limit`` for the any-hit ones; ``t_seed``/``f_seed``
    and ``occ_seed`` for the seeded ones; ``with_counts`` for K8's two.
    Every instance reads ``tree``'s packed records, which it must have."""

    kernel: str
    o: Vec3
    d: Vec3
    tree: object
    faces: torch.Tensor
    max_leaf: int
    alive: Optional[torch.Tensor] = None
    order: Optional[torch.Tensor] = None
    face_base: int = 0
    light: Optional[torch.Tensor] = None
    t_limit: Optional[torch.Tensor] = None
    t_seed: Optional[torch.Tensor] = None
    f_seed: Optional[torch.Tensor] = None
    occ_seed: Optional[torch.Tensor] = None
    with_counts: bool = False


def _leaf_tests(o, d, faces, rays, first, cnt, face_base, t_best, f_best, occ, t_limit,
                uv=None):
    """The leaf faces ``first .. first + cnt - 1`` of each ray in ``rays``
    (1-D int64), in ascending order, a cut of rays at a time: nearest
    (strict '<', so the first face wins ties) into ``t_best``/``f_best``,
    or any-hit against ``t_limit`` into ``occ``. Returns each ray's face
    tests: ``cnt``, or on any-hit up to and including the occluding face.
    ``uv``: a list to which the tests whose t can change the result are
    appended as (rays, t) (``walk_plain``)."""
    kmax = int(cnt.max())
    nf = faces.shape[1]
    k = torch.arange(kmax, device=first.device)
    ran = cnt.clone()
    step = max(1, _PLAIN_ELEMS // kmax)
    for lo in range(0, rays.shape[0], step):
        r, fi, ct = rays[lo:lo + step], first[lo:lo + step], cnt[lo:lo + step]
        fidx = (fi[:, None] + k).clamp_max(nf - 1)
        tab = faces[:, fidx]  # (9, m, kmax)
        ob = Vec3(o.x[r, None], o.y[r, None], o.z[r, None])
        db = Vec3(d.x[r, None], d.y[r, None], d.z[r, None])
        t, valid = moller_trumbore(ob, db, Vec3(tab[0], tab[1], tab[2]),
                                   Vec3(tab[3], tab[4], tab[5]), Vec3(tab[6], tab[7], tab[8]))
        valid = valid & (k < ct[:, None])
        if t_limit is not None:
            below = (t >= EPS5) & (t < t_limit[r, None])
            hit = valid & below
            found = hit.any(dim=1)
            occ[r] = occ[r] | found
            first_hit = torch.where(hit, k, kmax).amin(dim=1)
            ran[lo:lo + step] = torch.where(found, first_hit + 1, ct)
            if uv is not None:
                _candidates(uv, r, t, below & (k < ran[lo:lo + step, None]))
            continue
        if uv is not None:
            _candidates(uv, r, t, (t >= EPS5) & (t <= t_best[r, None]) & (k < ct[:, None]))
        tt = torch.where(valid, t, INF)
        t_min = tt.amin(dim=1)
        k_first = torch.where(tt == t_min[:, None], k, kmax).amin(dim=1)
        better = t_min < t_best[r]
        t_best[r] = torch.where(better, t_min, t_best[r])
        f_best[r] = torch.where(better, (face_base + fi + k_first).to(torch.int32), f_best[r])
    return ran


def _candidates(uv: list, r, t, mask) -> None:
    rows, cols = torch.nonzero(mask, as_tuple=True)
    uv.append((r[rows], t[rows, cols]))


def _within(uv: list, t_best: torch.Tensor) -> tuple:
    """The candidates of ``uv`` joined, those with t above ``t_best`` dropped."""
    r, t = torch.cat([c[0] for c in uv]), torch.cat([c[1] for c in uv])
    keep = t <= t_best[r]
    return r[keep], t[keep]


def uv_counts(uv: list, n: int, device, t_final=None) -> torch.Tensor:
    """Per ray of ``n``, the face tests whose t can change the result,
    from the candidates ``walk_plain`` appended to ``uv``: on a nearest
    walk those with ``1e-5 <= t <= t_final`` (the ray's final t, as
    chip_smoke.py's K1 bound counts them), on an any-hit walk (``t_final``
    None) every candidate."""
    if not uv:
        return torch.zeros((n,), dtype=torch.int64, device=device)
    r = _within(uv, t_final)[0] if t_final is not None else torch.cat([c[0] for c in uv])
    return torch.bincount(r, minlength=n)


def walk_plain(o: Vec3, d: Vec3, tree, faces: torch.Tensor, max_leaf: int, alive=None,
               face_base: int = 0, t_seed=None, f_seed=None, t_limit=None, occ_seed=None,
               uv=None):
    """The per-ray stackless walk in torch ops (any device): K8's plain
    version, and K6's and K7's (module docstring).

    Nearest (``t_limit`` None), optionally from ``t_seed``/``f_seed``; or
    any-hit against ``t_limit``, optionally from ``occ_seed``. Returns
    ``(t, face, occluded, tests, visits)``: the exact per-ray counters of
    the walk that ran, those of ``pbr_tpu/ops/traverse.py:302-314`` on the
    nearest walk (node steps; min(leaf_count, max_leaf) per hit leaf); the
    any-hit walk counts a leaf's faces up to and including the one that
    occludes the ray, where it stops.

    ``uv``: a list to which each leaf appends the (rays, t) of its tests
    whose t can change the result, for ``uv_counts``: on a nearest walk
    ``1e-5 <= t <=`` the ray's bound before the leaf (a superset of those
    within its final t), on an any-hit walk ``1e-5 <= t < t_limit`` up to
    and including the occluding face."""
    n, dev = o.x.shape[0], o.x.device
    any_hit = t_limit is not None
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    t_best = torch.full((n,), INF, device=dev) if t_seed is None else t_seed.clone()
    f_best = (torch.full((n,), -1, dtype=torch.int32, device=dev) if f_seed is None
              else f_seed.clone())
    occ = torch.zeros((n,), dtype=torch.bool, device=dev) if occ_seed is None \
        else occ_seed.clone()
    tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    visits = torch.zeros_like(tests)
    idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    walking = torch.ones_like(occ) if alive is None else alive.clone()
    if any_hit:
        walking &= ~occ
    act = torch.nonzero(walking).flatten() if tree.count else idx[:0]
    while act.numel():
        i = idx[act]
        lo, hi = tree.bb_min[:, i], tree.bb_max[:, i]
        t_near, t_far, hit = slab_box(Vec3(o.x[act], o.y[act], o.z[act]),
                                      Vec3(inv.x[act], inv.y[act], inv.z[act]),
                                      Vec3(lo[0], lo[1], lo[2]), Vec3(hi[0], hi[1], hi[2]))
        gate = t_limit[act] if any_hit else t_best[act]
        hit = hit & (t_far > EPS5) & (lo[0] <= hi[0]) & (gate > t_near)
        visits[act] += 1
        lf = tree.leaf_first[i]
        leaf = hit & (lf >= 0)
        if bool(leaf.any()):
            rays = act[leaf]
            cnt = tree.leaf_count[i][leaf].clamp_max(max_leaf)
            tests[rays] += _leaf_tests(o, d, faces, rays, lf[leaf].long(), cnt.long(), face_base,
                                       t_best, f_best, occ, t_limit, uv).to(torch.int32)
        if uv is not None and not any_hit and len(uv) >= 32:  # t_best only falls
            uv[:] = [_within(uv, t_best)]
        nxt = torch.where(hit, i + 1, tree.exit[i].long())
        idx[act] = nxt
        keep = nxt < tree.count
        if any_hit:
            keep &= ~occ[act]
        act = act[keep]
    return t_best, f_best, occ, tests, visits


def _subtrees(w: Walk) -> list:
    """(tree, faces, face_base) of each tree ``w`` walks, in order: a
    forest's sub-trees, or ``w.tree`` alone."""
    if not isinstance(w.tree, ForestTables):
        return [(w.tree, w.faces, w.face_base)]
    c = w.tree.chunk
    return [(w.tree.tree(i), w.faces[:, i * c:(i + 1) * c], w.face_base + i * c)
            for i in range(w.tree.count)]


def _run_plain(w: Walk, work: Optional[list] = None, uv: Optional[list] = None):
    """``w`` through the plain version: (t, face), (t, face, occluded),
    occluded, or K8's (t, face[, tests, visits]) and (occluded[, tests,
    visits]); a forest's sub-trees walked one after another, each seeded by
    the one before. ``work``: a list to which each tree's walk appends its
    per-ray ``(tests, visits)``; ``uv``: a list to which each leg (the
    nearest walk, the shadow walk) appends its per-ray tests whose t can
    change the result (``uv_counts``: over a chain, against the chain's
    final t). chip_smoke.py's bounds count them."""
    def walk(o, d, alive=w.alive, t_seed=None, f_seed=None, t_limit=None, occ_seed=None):
        cands = None if uv is None else []
        for tree, faces, base in _subtrees(w):
            out = walk_plain(o, d, tree, faces, w.max_leaf, alive, base, t_seed=t_seed,
                             f_seed=f_seed, t_limit=t_limit, occ_seed=occ_seed, uv=cands)
            if work is not None:
                work.append(out[3:])
            t_seed, f_seed, occ_seed = out[:3]
        if uv is not None:
            uv.append(uv_counts(cands, o.x.shape[0], o.x.device,
                                None if t_limit is not None else out[0]))
        return out
    counts = w.with_counts and w.kernel in _K8
    if w.t_limit is not None:
        _, _, occ, tests, visits = walk(w.o, w.d, t_limit=w.t_limit, occ_seed=w.occ_seed)
        return (occ, tests, visits) if counts else occ
    t, f, _, tests, visits = walk(w.o, w.d, t_seed=w.t_seed, f_seed=w.f_seed)
    if w.kernel == "K8":
        return (t, f, tests, visits) if counts else (t, f)
    if w.light is None:
        return t, f
    hit_p, s_dir, t_light = _shadow_ray(w.o, w.d, t, w.light)
    casts = t < INF if w.alive is None else w.alive & (t < INF)
    return t, f, walk(hit_p, s_dir, casts, t_limit=t_light)[2]


def leaf_bound(bvh, max_leaf=None) -> int:
    """The leaf bound a walk of ``bvh`` runs with: ``max_leaf``, or where it
    is None the tree's own (``scene/build.py::bvh_max_leaf``: its largest
    leaf, at least 2). Raises where ``max_leaf`` is below the tree's largest
    leaf (``BVHTables.leaf_max``, where the tables carry it): the walk would
    never test that leaf's faces past the bound."""
    most = bvh.leaf_max
    if max_leaf is None:
        return max(2, most if most is not None else int(bvh.leaf_count.max()))
    if most is not None and max_leaf < most:
        raise ValueError(f"max_leaf {max_leaf} is below the BVH's largest leaf, {most} "
                         f"faces; pass max_leaf=None for the tree's own bound")
    return max_leaf


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


def _check(w: Walk) -> None:
    check_rays(w.kernel, w.o, w.d)
    dev, n = w.o.x.device, w.o.x.shape[0]
    tr = w.tree
    chain = isinstance(tr, ForestTables)
    if chain and w.kernel not in _SEEDED:
        raise ValueError(f"{w.kernel} walks one tree; only the seeded instances chain a "
                         f"forest's sub-trees")
    nodes = tr.trees if chain else tr
    for a, dt in ((nodes.bb_min, torch.float32), (nodes.bb_max, torch.float32),
                  (nodes.leaf_first, torch.int32), (nodes.leaf_count, torch.int32),
                  (nodes.exit, torch.int32)):
        if a.device != dev or a.dtype != dt or not a.is_contiguous() \
                or a.shape[-1] != nodes.count \
                or a.dim() != (2 if dt == torch.float32 else 1) + chain:
            raise ValueError(f"{w.kernel}: the tree's tables must be contiguous (3, N) float32 "
                             f"bounds and (N,) int32 indices on {dev} (stacked on a leading "
                             f"axis for a forest's sub-trees)")
    f = w.faces
    if f.device != dev or f.dtype != torch.float32 or f.dim() != 2 or f.shape[0] != 9 \
            or f.stride(1) != 1 or f.shape[1] < 1 or 9 * f.stride(0) >= 2**31:
        raise ValueError(f"{w.kernel}: the face table must be (9, F) float32 on {dev}, rows "
                         f"contiguous")
    for a, dt in ((w.alive, torch.bool), (w.t_limit, torch.float32),
                  (w.t_seed, torch.float32), (w.f_seed, torch.int32),
                  (w.occ_seed, torch.bool), (w.order, torch.int32)):
        if a is not None and (a.device != dev or a.dtype != dt or a.shape != (n,)
                              or not a.is_contiguous()):
            raise ValueError(f"{w.kernel}: per-ray inputs must be contiguous ({n},) tensors "
                             f"on {dev}, got {a.dtype} {tuple(a.shape)}")
    if w.light is not None and (w.light.device != dev or w.light.dtype != torch.float32
                                or tuple(w.light.shape) != (3,)):
        raise ValueError(f"light position must be (3,) float32 on {dev}")
    if w.max_leaf < 1:
        raise ValueError(f"max_leaf must be at least 1, not {w.max_leaf}")
    if not chain:
        leaf_bound(tr, w.max_leaf)
    if chain and (f.data_ptr() != tr.faces.data_ptr() or f.shape != tr.faces.shape
                  or f.shape[1] % tr.count):
        raise ValueError(f"{w.kernel}: a forest's sub-trees walk the forest's own faces, "
                         f"chunk faces a sub-tree")
    if w.kernel in _SEEDED and ((w.t_seed is None or w.f_seed is None) if w.t_limit is None
                                else w.occ_seed is None):
        raise ValueError(f"{w.kernel} starts from its seeds: t_seed and f_seed, or occ_seed "
                         f"with t_limit")
    if w.kernel in _K8 and (w.kernel == "K8 any-hit") != (w.t_limit is not None):
        raise ValueError("K8's any-hit instance, and only it, takes a t_limit")
    if w.kernel not in _SEEDED and w.face_base != 0:
        raise ValueError(f"{w.kernel} walks one tree from its first face: face_base must be 0")
    node_shape = (tr.count, nodes.count, 8) if chain else (tr.count, 8)
    for rec, shape in ((tr.node_records, node_shape), (tr.face_records, (f.shape[1], 12))):
        if (rec is None or rec.device != dev or rec.dtype != torch.float32
                or tuple(rec.shape) != shape or not rec.is_contiguous()):
            raise ValueError(f"{w.kernel}: the tree needs its packed records, contiguous "
                             f"{shape} float32 on {dev} (node_records, face_records; to_torch "
                             f"builds them)")


def _run_kernel(w: Walk):
    """``w`` by one kernel launch: ``_run_plain``'s outputs."""
    dev, n = w.o.x.device, w.o.x.shape[0]
    tr = w.tree
    rays = (*(a.data_ptr() for a in (*w.o, *w.d)), _ptr(w.order), _ptr(w.alive), n)
    any_hit = w.t_limit is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if w.kernel in _K8:
            out = ((torch.empty((n,), dtype=torch.bool, device=dev),) if any_hit else
                   (torch.empty((n,), dtype=torch.float32, device=dev),
                    torch.empty((n,), dtype=torch.int32, device=dev)))
            counts = tuple(torch.empty((n,), dtype=torch.int32, device=dev)
                           for _ in range(2 if w.with_counts else 0))
            lib = load("bvh_walk", "pbr_bvh_walk", _WALK_ARGTYPES)
            outs = (None, None, out[0].data_ptr()) if any_hit else \
                (out[0].data_ptr(), out[1].data_ptr(), None)
            err = lib.pbr_bvh_walk(*rays, tr.node_records.data_ptr(), tr.count,
                                   tr.face_records.data_ptr(), w.max_leaf, _ptr(w.t_limit),
                                   *outs, *(_ptr(c) for c in counts or (None, None)), stream)
            out = out + counts
            if len(out) == 1:
                out = out[0]
        elif w.kernel in _SEEDED:
            t = torch.empty((0 if any_hit else n,), dtype=torch.float32, device=dev)
            f = torch.empty((0 if any_hit else n,), dtype=torch.int32, device=dev)
            occ = torch.empty((n if any_hit else 0,), dtype=torch.bool, device=dev)
            chain = isinstance(tr, ForestTables)
            lib = load("bvh_packet", "pbr_bvh_chain", _CHAIN_ARGTYPES)
            err = lib.pbr_bvh_chain(
                int(any_hit), *rays, tr.node_records.data_ptr(),
                tr.trees.count if chain else tr.count, tr.count if chain else 1,
                tr.face_records.data_ptr(), tr.chunk if chain else w.faces.shape[1],
                w.face_base, w.max_leaf, _ptr(w.t_limit), _ptr(w.t_seed), _ptr(w.f_seed),
                _ptr(w.occ_seed), t.data_ptr(), f.data_ptr(), occ.data_ptr(), stream)
            out = occ if any_hit else (t, f)
        else:
            t = torch.empty((n,), dtype=torch.float32, device=dev)
            f = torch.empty((n,), dtype=torch.int32, device=dev)
            occ = torch.empty((n,) if any_hit or w.light is not None else (0,),
                              dtype=torch.bool, device=dev)
            mode = _PACKET_MODES[w.kernel]
            recs = (tr.node_records.data_ptr(), tr.count, tr.face_records.data_ptr(), w.max_leaf,
                    _ptr(w.light))
            outs = (t.data_ptr(), f.data_ptr(), occ.data_ptr(), stream)
            if w.kernel in _SLAB:
                lib = load("bvh_packet", "pbr_bvh_slab", _SLAB_ARGTYPES)
                err = lib.pbr_bvh_slab(mode, *rays, *recs, *outs)
            else:
                lib = load("bvh_packet", "pbr_bvh_packet", _PACKET_ARGTYPES)
                err = lib.pbr_bvh_packet(mode, *rays, *recs, _ptr(w.t_limit), *outs)
            out = occ if any_hit else (t, f) if w.light is None else (t, f, occ)
    if err != 0:
        raise RuntimeError(f"{w.kernel} launch failed: cudaError {err}")
    count_launch(launches, w.kernel)
    return out


def run(w: Walk):
    """``w`` by its kernel on a CUDA tensor (or raise), by the plain
    version on a CPU tensor."""
    _check(w)
    dev = w.o.x.device
    if dev.type == "cpu":
        return _run_plain(w)
    if dev.type != "cuda":
        raise ValueError(f"{w.kernel} runs on CUDA or CPU tensors, not {dev}")
    return _run_kernel(w)


def ray_order(o: Vec3, d: Vec3, tree, alive=None) -> Optional[torch.Tensor]:
    """The kernels' launch order on a CUDA tensor: rays sorted by octant
    and Morton code of the origin in the tree's root box, dead lanes last;
    None on a CPU tensor (the plain version walks each ray alone)."""
    if o.x.device.type != "cuda" or o.x.shape[0] == 0:
        return None
    keys = coherence_keys(o, d, *tree.root)
    if alive is not None:
        keys = torch.where(alive, keys, torch.iinfo(torch.int32).max)
    return torch.argsort(keys).to(torch.int32)


def _light(light_pos) -> Optional[torch.Tensor]:
    if light_pos is None:
        return None
    return torch.stack([light_pos.x, light_pos.y, light_pos.z]).to(torch.float32)


def intersect_bvh_walk(o: Vec3, d: Vec3, bvh, tris, max_leaf: Optional[int] = None,
                       alive=None, with_counts: bool = False):
    """Nearest hit by the per-ray walk, kernel K8
    (``pbr_tpu/ops/traverse.py::intersect_bvh``'s contract).

    ``bvh``: the scene's ``BVHTables``; ``tris``: its triangles (leaf
    order); ``max_leaf``: the faces a leaf may hold (``leaf_bound``: None
    takes the tree's own). Returns ``(t, face)``, or ``(t, face, tests,
    visits)`` with the exact int32 counters."""
    w = Walk("K8", o, d, bvh, face_table(tris), leaf_bound(bvh, max_leaf), alive,
             ray_order(o, d, bvh, alive), with_counts=with_counts)
    return run(w)


def occluded_bvh_walk(o: Vec3, d: Vec3, t_limit: torch.Tensor, bvh, tris,
                      max_leaf: Optional[int] = None, alive=None, with_counts: bool = False):
    """Any hit closer than ``t_limit`` by the per-ray walk, kernel K8's
    any-hit instance: a ray is occluded iff some valid face has t <
    ``t_limit``, which is the bit ``t_sh < t_light`` that the JAX package
    takes from a second nearest search (``pbr_tpu/models/integrator.py:
    352-353``). Arguments as ``intersect_bvh_walk``; ``t_limit`` (B,)
    float32. Returns the (B,) bool ``occluded`` (False on a dead lane), or
    ``(occluded, tests, visits)``: the any-hit walk's node steps, and its
    face tests up to and including each ray's occluding face."""
    w = Walk("K8 any-hit", o, d, bvh, face_table(tris), leaf_bound(bvh, max_leaf), alive,
             ray_order(o, d, bvh, alive), t_limit=t_limit, with_counts=with_counts)
    return run(w)


def intersect_bvh_packet(o: Vec3, d: Vec3, bvh, tris, max_leaf: Optional[int] = None,
                         light_pos=None, alive=None):
    """Nearest hit by kernel K6's per-ray walk
    (``pallas_bvh.py::intersect_bvh_packet``'s contract): ``(t, face)``,
    or with ``light_pos`` (a Vec3 of 0-d tensors, light 0) ``(t, face,
    occluded)`` from the fused NEE shadow leg; ``max_leaf`` as
    ``intersect_bvh_walk``. Needs ``packet_fits``."""
    if not packet_fits(bvh, tris):
        raise ValueError(
            f"the packet BVH walk takes at most {PALLAS_BVH_MAX_ROWS} node + face rows; this "
            f"scene has {bvh.count} + {int(tris.mtl.shape[0])} (use 'pallas_bvh_hbm', "
            f"'pallas_bvh_forest' or 'bvh')")
    light = _light(light_pos)
    w = Walk("K6 NEE" if light is not None else "K6 nearest", o, d, bvh, face_table(tris),
             leaf_bound(bvh, max_leaf), alive, ray_order(o, d, bvh, alive), light=light)
    return run(w)


def intersect_bvh_packet_hbm(o: Vec3, d: Vec3, bvh, tris, max_leaf: Optional[int] = None,
                             light_pos=None, alive=None):
    """Nearest hit by the leaf-slab packet walk, kernel K7
    (``pallas_bvh.py::intersect_bvh_packet_hbm``'s contract): as
    ``intersect_bvh_packet``. Needs ``packet_hbm_fits`` and ``max_leaf`` <=
    ``SLAB_MAX_LEAF``."""
    if not packet_hbm_fits(bvh):
        raise ValueError(
            f"the slab BVH walk takes at most {PACKET_HBM_MAX_NODES} nodes; this tree has "
            f"{bvh.count} (build 64-face leaves: scene/build.py does above 20,000 faces)")
    max_leaf = leaf_bound(bvh, max_leaf)
    if not 1 <= max_leaf <= SLAB_MAX_LEAF:
        raise ValueError(f"the slab BVH walk stages at most {SLAB_MAX_LEAF} faces a leaf; "
                         f"max_leaf is {max_leaf}")
    light = _light(light_pos)
    w = Walk("K7 NEE" if light is not None else "K7 nearest", o, d, bvh, face_table(tris),
             max_leaf, alive, ray_order(o, d, bvh, alive), light=light)
    return run(w)


def _forest(execute, o: Vec3, d: Vec3, forest, order, max_leaf, light, alive):
    """The forest walk with each launch made by ``execute(Walk)``: the
    nearest walk over sub-tree 0 ("K6 nearest"), then over sub-trees
    1..K-1 in one walk ("K6 seeded"), each seeded with the best so far;
    faces mapped to main order; with a light, the shadow rays from the
    combined hit (the guarded math of ``_kernel_nee``) and the any-hit
    walk chained the same way ("K6 any-hit", "K6 seeded any-hit")."""
    chunk = forest.chunk
    rest = forest.subtrees(1, forest.count) if forest.count > 1 else None
    first = (forest.tree(0), forest.faces[:, :chunk], max_leaf, alive, order)
    t, f = execute(Walk("K6 nearest", o, d, *first))
    if rest is not None:
        t, f = execute(Walk("K6 seeded", o, d, rest, rest.faces, max_leaf, alive, order,
                            face_base=chunk, t_seed=t, f_seed=f))
    face = torch.where(f >= 0, forest.face_ids[f.clamp_min(0).long()], -1)
    if light is None:
        return t, face
    hit_p, s_dir, t_light = _shadow_ray(o, d, t, light)
    occ = execute(Walk("K6 any-hit", hit_p, s_dir, *first, t_limit=t_light))
    if rest is not None:
        occ = execute(Walk("K6 seeded any-hit", hit_p, s_dir, rest, rest.faces, max_leaf,
                           alive, order, face_base=chunk, t_limit=t_light, occ_seed=occ))
    return t, face, occ


def intersect_bvh_forest(o: Vec3, d: Vec3, forest, bvh, max_leaf: int = FOREST_MAX_LEAF,
                         light_pos=None, alive=None):
    """Nearest hit over a ``ForestTables`` by K6's instances
    (``pallas_bvh.py::intersect_bvh_forest``'s contract): main-order faces,
    ``bvh`` (the scene's main tree) giving the root box of the coherence
    sort. Returns ``(t, face)`` or, with ``light_pos``, ``(t, face,
    occluded)``. Two launches a pass (one with a single sub-tree): four a
    call with NEE, two without."""
    return _forest(run, o, d, forest, ray_order(o, d, bvh, alive), max_leaf,
                   _light(light_pos), alive)
