"""Cull verdicts and candidate lists: which face clusters a ray tile may
hit, and in what order to sweep them.

The counterpart of ``pbr_tpu/ops/cull.py`` for the functions that the gated
sweep (kernel K3, ``ops/cuda_gated.py``), the cull-and-sweep (kernels K4
and K4m, ``ops/cuda_cull.py``) and the row sweep (kernels K5 and K5m,
``ops/cuda_sweep.py``) consume, with their operation order:
``frustum_hits``, ``frustum_hits_octants`` and ``fine_hit_mask`` (with
``_tile_minmax``), the coherence sort keys ``coherence_keys`` (with
``_part1by2`` of ``pbr_tpu/ops/traverse.py``), the near-to-far candidate
lists ``candidates``, and the row sweep's per-row lists
``candidates_rows`` and verdict words ``row_hit_words`` (with
``_row_minmax_v``, here ``_tile_bounds``), and the fine lists of the
Phong-tessellated search (``candidates_fine``, read by
``ops/phongtess.py::intersect_clusters_phongtess``). In the JAX package
this stage is plain XLA, not Pallas, so here it is plain torch ops on any
device. Every verdict is conservative: a cluster that any live ray of a
tile could hit is set; extra clusters cost sweep work, never a wrong
answer.
"""

from __future__ import annotations

import torch

from pbr_tpu_torch.accel.clusters import SUPER
from pbr_tpu_torch.ops.vec import Vec3, f32
from pbr_tpu_torch.utils.config import EPSILON5

_BIG = f32(3.0e38)  # finite stand-in for +/-inf (keeps 0*inf NaNs out)
_EPS5 = f32(EPSILON5)


# Candidate entries are fine-cluster ids with this bit set when the tile's
# frustum misses that fine cluster (pbr_tpu/ops/cull.py:32): the sweep
# skips the slot.
CAND_MISS = 1 << 20


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (Morton interleave helper), in int64."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_keys(o: Vec3, d: Vec3, lo: Vec3, hi: Vec3) -> torch.Tensor:
    """(N,) int32 octant+Morton sort keys of rays against the scene bounds
    ``lo``/``hi`` (Vec3s of 0-d tensors): direction octant in bits 27-29,
    then the top 27 bits of the 30-bit Morton code of the origin quantized
    to 1,024 steps an axis."""
    def q(c, mn, mx):
        inv = 1.0 / torch.clamp_min(mx - mn, f32(1e-9))
        return torch.clamp((c - mn) * inv * 1023.0, 0.0, 1023.0).to(torch.int64)

    morton = (_part1by2(q(o.x, lo.x, hi.x))
              | (_part1by2(q(o.y, lo.y, hi.y)) << 1)
              | (_part1by2(q(o.z, lo.z, hi.z)) << 2))
    octant = ((d.x < 0).to(torch.int64) + 2 * (d.y < 0).to(torch.int64)
              + 4 * (d.z < 0).to(torch.int64))
    return ((octant << 27) | (morton >> 3)).to(torch.int32)


def _tile_minmax(a: torch.Tensor, tile: int):
    a2 = a.reshape(-1, tile)
    return a2.amin(dim=1), a2.amax(dim=1)


def _tile_bounds(o: Vec3, d: Vec3, tile: int):
    """Per-tile interval frustum: ``(o_lo, o_hi, d_lo, d_hi)`` Vec3s of (T,)."""
    (oxl, oxh), (oyl, oyh), (ozl, ozh) = (_tile_minmax(a, tile) for a in o)
    (dxl, dxh), (dyl, dyh), (dzl, dzh) = (_tile_minmax(a, tile) for a in d)
    return (Vec3(oxl, oyl, ozl), Vec3(oxh, oyh, ozh),
            Vec3(dxl, dyl, dzl), Vec3(dxh, dyh, dzh))


def frustum_hits(o_lo: Vec3, o_hi: Vec3, d_lo: Vec3, d_hi: Vec3,
                 bb_min: Vec3, bb_max: Vec3, t_cap=None):
    """Conservative tile-frustum vs cluster-AABB test.

    ``o_lo``/``o_hi``/``d_lo``/``d_hi``: Vec3s of (T,) per-tile component
    bounds; ``bb_min``/``bb_max``: Vec3s of (C,). Per axis, a sign-pure
    direction interval bounds the slab-crossing parameter by the eight
    products of {slab - origin bound} x {1/d_lo, 1/d_hi}; an interval
    spanning 0 constrains nothing. The entry bound also takes the
    box-to-box distance (unit directions). ``t_cap`` (T,): optional upper
    bound on useful t. Returns ``(hit, t_entry)``, both (T, C): hit bool,
    t_entry a lower bound on any tile ray's entry, clamped up to 0.
    """
    t_entry = torch.full((o_lo.x.shape[0], bb_min.x.shape[0]), -_BIG,
                         dtype=torch.float32, device=o_lo.x.device)
    t_exit = torch.full_like(t_entry, _BIG)
    for ol, oh, dl, dh, sl, sh in zip(o_lo, o_hi, d_lo, d_hi, bb_min, bb_max):
        pure = (dl > 0.0) | (dh < 0.0)  # (T,)
        # Guarded reciprocals (value unused when not pure).
        inv_a = (1.0 / torch.where(pure, dl, 1.0))[:, None]
        inv_b = (1.0 / torch.where(pure, dh, 1.0))[:, None]
        e_ll = sl[None, :] - oh[:, None]  # slab lo minus origin hi, etc.
        e_lh = sl[None, :] - ol[:, None]
        e_hl = sh[None, :] - oh[:, None]
        e_hh = sh[None, :] - ol[:, None]
        p = [e_ll * inv_a, e_ll * inv_b, e_lh * inv_a, e_lh * inv_b,
             e_hl * inv_a, e_hl * inv_b, e_hh * inv_a, e_hh * inv_b]
        t_lo = p[0]
        t_hi = p[0]
        for v in p[1:]:
            t_lo = torch.minimum(t_lo, v)
            t_hi = torch.maximum(t_hi, v)
        pure_c = pure[:, None]
        t_entry = torch.maximum(t_entry, torch.where(pure_c, t_lo, -_BIG))
        t_exit = torch.minimum(t_exit, torch.where(pure_c, t_hi, _BIG))

    # Box-to-box distance lower bound (unit directions): per-axis gap,
    # clamped before squaring so that the +/-BIG bounds of empty octant
    # groups do not overflow (clamping down keeps the bound conservative).
    d2 = torch.zeros_like(t_entry)
    for ol, oh, sl, sh in zip(o_lo, o_hi, bb_min, bb_max):
        gap = torch.maximum(sl[None, :] - oh[:, None], ol[:, None] - sh[None, :])
        gap = gap.clamp_min(0.0).clamp_max(f32(1.0e18))
        d2 = d2 + gap * gap
    t_entry = torch.maximum(t_entry, torch.sqrt(d2))

    hit = (t_entry <= t_exit) & (t_exit > _EPS5)
    if t_cap is not None:
        hit = hit & (t_entry <= t_cap[:, None])
    # Inverted (empty) cluster AABBs never hit, even for a tile that no
    # axis constrains.
    nonempty = (bb_min.x <= bb_max.x)[None, :]
    return hit & nonempty, t_entry.clamp_min(0.0)


def frustum_hits_octants(o: Vec3, d: Vec3, g: int, bb_min: Vec3, bb_max: Vec3,
                         t_cap=None, live=None):
    """Octant-split group frustums vs cluster AABBs.

    Each group of ``g`` consecutive rays (N a multiple of ``g``) is split
    into eight sign-pure sub-frustums by direction octant, so that the slab
    test constrains all three axes even for hemisphere-scattered bounce
    rays; the verdicts are ORed. ``live`` (N,) bool: dead lanes add no
    demand (a group with no live lane gets no cluster). ``t_cap``: optional
    (T,) per-group bound. Returns ``(hit, t_entry)`` of (T, C): the OR over
    octants and the min entry bound over hitting octants."""
    t = o.x.shape[0] // g
    oct_id = (d.x < 0).to(torch.int32) + 2 * (d.y < 0).to(torch.int32) \
        + 4 * (d.z < 0).to(torch.int32)
    octs = torch.arange(8, dtype=torch.int32, device=o.x.device)
    m = oct_id.reshape(t, 1, g) == octs[None, :, None]  # (T, 8, g)
    if live is not None:
        m = m & live.reshape(t, 1, g)
    occ = m.any(dim=2).reshape(-1)  # (T*8,)

    def mm(a):
        a3 = a.reshape(t, 1, g)
        lo = torch.where(m, a3, _BIG).amin(dim=2).reshape(-1)
        hi = torch.where(m, a3, -_BIG).amax(dim=2).reshape(-1)
        return lo, hi

    ox, oy, oz = mm(o.x), mm(o.y), mm(o.z)
    dx, dy, dz = mm(d.x), mm(d.y), mm(d.z)
    cap8 = None if t_cap is None else t_cap[:, None].expand(t, 8).reshape(-1)
    hit8, te8 = frustum_hits(
        Vec3(ox[0], oy[0], oz[0]), Vec3(ox[1], oy[1], oz[1]),
        Vec3(dx[0], dy[0], dz[0]), Vec3(dx[1], dy[1], dz[1]),
        bb_min, bb_max, cap8,
    )  # (T*8, C)
    hit8 = hit8 & occ[:, None]
    c = bb_min.x.shape[0]
    hit = hit8.reshape(t, 8, c).any(dim=1)
    t_entry = torch.where(hit8, te8, _BIG).reshape(t, 8, c).amin(dim=1)
    return hit, t_entry


def fine_hit_mask(o: Vec3, d: Vec3, clusters, tile: int, t_cap=None,
                  octants: bool = True, live=None) -> torch.Tensor:
    """(T, C) bool fine-cluster verdicts for ray tiles of ``tile`` rays: the
    gated sweep's input. ``clusters``: anything with ``bb_min``/``bb_max``
    Vec3s of (C,) (``scene.ClusterTables``). ``octants`` (default): the
    sign-pure sub-frustum verdicts of ``frustum_hits_octants``; otherwise
    one interval frustum per tile (``live`` is then not used, as in the
    JAX version)."""
    if octants:
        hit, _ = frustum_hits_octants(o, d, tile, clusters.bb_min, clusters.bb_max,
                                      t_cap, live=live)
        return hit
    hit, _ = frustum_hits(*_tile_bounds(o, d, tile), clusters.bb_min, clusters.bb_max, t_cap)
    return hit


def candidates(o: Vec3, d: Vec3, clusters, tile: int, t_cap=None):
    """Per-tile candidate cluster lists, supercluster near-to-far: the
    slotted cull-and-sweep's input (``pbr_tpu/ops/cull.py::candidates``).

    ``o``/``d``: flat (N,) rays (sorted, in the wrapper), N a multiple of
    ``tile``; ``clusters``: a ``scene.ClusterTables``. The interval frustum
    of each tile is tested against the supercluster AABBs, hit
    superclusters are ordered by their entry bound with a stable argsort
    (ties keep ascending ids), and each expands to its ``SUPER``
    consecutive fine clusters. Returns ``(cand, counts, tent)``:

    - ``cand`` (T, C) int32: fine cluster ids, padding slots repeating the
      last valid entry; ``CAND_MISS`` is added where the tile's frustum
      misses that fine cluster;
    - ``counts`` (T,) int32: valid entries per tile;
    - ``tent`` (T, C) float32: each slot's entry lower bound, inherited from
      its supercluster; 3e38 on padding slots.
    """
    c2 = clusters.sup_min.x.shape[0]
    c = c2 * SUPER
    bounds = _tile_bounds(o, d, tile)
    hit, t_entry = frustum_hits(*bounds, clusters.sup_min, clusters.sup_max, t_cap)
    counts2 = hit.sum(dim=1, dtype=torch.int32)
    key = torch.where(hit, t_entry, _BIG)
    order = torch.argsort(key, dim=1, stable=True)
    j2 = torch.arange(c2, dtype=torch.int32, device=o.x.device)[None, :]
    take = torch.minimum(j2, torch.clamp_min(counts2[:, None] - 1, 0))
    sup = torch.gather(order, 1, take.long())  # (T, C2) int64
    tent2 = torch.where(j2 < counts2[:, None], torch.gather(t_entry, 1, sup), _BIG)
    fine_off = torch.arange(SUPER, dtype=torch.int64, device=o.x.device)[None, None, :]
    cand = (sup[:, :, None] * SUPER + fine_off).reshape(-1, c)
    tent = tent2[:, :, None].expand(*tent2.shape, SUPER).reshape(-1, c)
    hit_f, _ = frustum_hits(*bounds, clusters.bb_min, clusters.bb_max, t_cap)
    ok = torch.gather(hit_f, 1, cand)
    cand = torch.where(ok, cand, cand + CAND_MISS).to(torch.int32)
    return cand, counts2 * SUPER, tent


def candidates_fine(o: Vec3, d: Vec3, clusters, tile: int, t_cap=None):
    """Per-tile candidate lists over the fine clusters, near-to-far: the
    Phong-tessellated cluster search's input
    (``pbr_tpu/ops/cull.py::candidates_fine``). No supercluster expansion
    and no miss bit: the search runs one cluster a tile a round, and a
    slot it cannot hit would waste a whole round.

    Arguments as ``candidates``. Returns ``(cand, counts, tent)``: ``cand``
    (T, C) int32 fine cluster ids ordered by their entry bound (stable
    argsort: ties keep ascending ids), padding slots repeating the last
    valid entry; ``counts`` (T,) int32 valid entries; ``tent`` (T, C)
    float32 each slot's entry lower bound, 3e38 on padding slots.
    """
    c = clusters.bb_min.x.shape[0]
    hit, t_entry = frustum_hits(*_tile_bounds(o, d, tile), clusters.bb_min, clusters.bb_max,
                                t_cap)
    counts = hit.sum(dim=1, dtype=torch.int32)
    order = torch.argsort(torch.where(hit, t_entry, _BIG), dim=1, stable=True)
    j = torch.arange(c, dtype=torch.int32, device=o.x.device)[None, :]
    take = torch.minimum(j, torch.clamp_min(counts[:, None] - 1, 0))
    cand = torch.gather(order, 1, take.long())
    tent = torch.where(j < counts[:, None], torch.gather(t_entry, 1, cand), _BIG)
    return cand.to(torch.int32), counts, tent


def _row_verdicts(o: Vec3, d: Vec3, rg: int, bb_min: Vec3, bb_max: Vec3, t_cap, octants: bool,
                  live):
    """(hit, t_entry) of every ``rg``-ray row against the boxes: the
    octant-split frustums, or one interval frustum a row (``live`` then not
    used, as in the JAX version)."""
    if octants:
        return frustum_hits_octants(o, d, rg, bb_min, bb_max, t_cap, live=live)
    return frustum_hits(*_tile_bounds(o, d, rg), bb_min, bb_max, t_cap)


def candidates_rows(o: Vec3, d: Vec3, clusters, tile: int, groups: int, t_cap=None,
                    octants: bool = True, live=None):
    """Per-tile candidate lists at lin-cluster granularity with per-row
    verdict bits: the slotted row sweep's input
    (``pbr_tpu/ops/cull.py::candidates_rows``).

    ``o``/``d``: flat (N,) rays (sorted, in the wrapper), N a multiple of
    ``tile``; each tile is ``groups`` rows of ``tile // groups`` rays.
    ``clusters``: a ``scene.ClusterTables`` with lin tables. ``t_cap``:
    optional (T * groups,) per-row upper bound on useful t; ``live``: (N,)
    bool, dead lanes add no demand (octant verdicts only). The row
    frustums are tested against the supercluster AABBs; a tile lists the
    superclusters any of its rows hits, ordered by the least entry bound
    of its hitting rows (stable argsort: ties keep ascending ids), each
    expanding to its ``lps = CL / C2`` consecutive lin clusters. Returns
    ``(cand, counts, tent)``:

    - ``cand`` (T, CL) int32: lin cluster id in bits 0-15, the tile's rows
      whose frustum hits that lin cluster in bits 16-23 (row g at bit
      16 + g); padding slots repeat the last valid entry;
    - ``counts`` (T,) int32: valid entries per tile;
    - ``tent`` (T, CL) float32: each slot's entry lower bound, inherited
      from its supercluster; 3e38 on padding slots.
    """
    rg = tile // groups
    cl = clusters.lin.shape[0]
    c2 = clusters.sup_min.x.shape[0]
    lps = cl // c2
    dev = o.x.device
    hit8s, te8s = _row_verdicts(o, d, rg, clusters.sup_min, clusters.sup_max, t_cap, octants,
                                live)  # (T * groups, C2)
    t = hit8s.shape[0] // groups
    hit_s = hit8s.reshape(t, groups, c2).any(dim=1)
    # the least entry bound over hitting rows: a sound per-tile bound
    te_s = torch.where(hit8s, te8s, _BIG).reshape(t, groups, c2).amin(dim=1)
    counts2 = hit_s.sum(dim=1, dtype=torch.int32)
    order = torch.argsort(torch.where(hit_s, te_s, _BIG), dim=1, stable=True)
    j2 = torch.arange(c2, dtype=torch.int32, device=dev)[None, :]
    take = torch.minimum(j2, torch.clamp_min(counts2[:, None] - 1, 0))
    sup = torch.gather(order, 1, take.long())  # (T, C2) int64
    tent2 = torch.where(j2 < counts2[:, None], torch.gather(te_s, 1, sup), _BIG)
    fine_off = torch.arange(lps, dtype=torch.int64, device=dev)[None, None, :]
    cand = (sup[:, :, None] * lps + fine_off).reshape(-1, cl)
    tent = tent2[:, :, None].expand(*tent2.shape, lps).reshape(-1, cl)
    hit8l, _ = _row_verdicts(o, d, rg, clusters.lbb_min, clusters.lbb_max, t_cap, octants,
                             live)  # (T * groups, CL)
    bits = torch.gather(hit8l.reshape(t, groups, cl), 2,
                        cand[:, None, :].expand(t, groups, cl)).to(torch.int32)
    shifts = torch.arange(groups, dtype=torch.int32, device=dev)[None, :, None]
    mask = (bits << shifts).sum(dim=1, dtype=torch.int32)
    return cand.to(torch.int32) | (mask << 16), counts2 * lps, tent


def row_hit_words(o: Vec3, d: Vec3, clusters, tile: int, groups: int, t_cap=None,
                  octants: bool = True, live=None) -> torch.Tensor:
    """(T, ceil(CL / 2)) int32 per-row lin-cluster verdicts, the masked row
    sweep's input (``pbr_tpu/ops/cull.py::row_hit_words``): cluster ``c``,
    row ``g`` is bit ``(c % 2) * 8 + g`` of word ``c // 2``. Arguments as in
    ``candidates_rows``."""
    rg = tile // groups
    cl = clusters.lin.shape[0]
    hit8, _ = _row_verdicts(o, d, rg, clusters.lbb_min, clusters.lbb_max, t_cap, octants,
                            live)  # (T * groups, CL)
    t = hit8.shape[0] // groups
    shifts = torch.arange(groups, dtype=torch.int32, device=o.x.device)[None, :, None]
    per_c = (hit8.reshape(t, groups, cl).to(torch.int32) << shifts).sum(dim=1,
                                                                         dtype=torch.int32)
    if cl % 2:
        per_c = torch.cat([per_c, per_c.new_zeros((t, 1))], dim=1)
    pc = per_c.reshape(t, -1, 2)
    return pc[:, :, 0] | (pc[:, :, 1] << 8)
