"""Kernel K4m's sweep (``csrc/cull_intersect.cu::masked_kernel``), modelled
in torch ops on the CPU: t first, u and v only where t is below the ray's
bound, lanes and 32-ray warps leaving once nothing can change them. The
model follows the kernel's rule face by face and is held bitwise to
``cuda_cull._masked_plain`` (per-cluster minima merged lexicographically)
on adversarial seeds: equal t with a larger face id, dead lanes, NaN and
+inf seeds, padding faces, t_limit 0 and +inf, any-hit seeded 1 or
negative. The kernel itself runs only on a card (``test_torch_cull_sweep``'s
``cuda``-marked test)."""

import numpy as np
import pytest
import torch

from pbr_tpu_torch.ops import cuda_cull as cc
from pbr_tpu_torch.ops.intersect import EPS5, INF
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.device import to_torch
from pbr_tpu_torch.scene.procedural import multi_room

torch.set_num_threads(1)
WARP = 32


def _t_first_model(feats, table, mask, seed_t, seed_f, any_hit):
    """The kernel's sweep: every gated-in cluster in ascending order, a
    32-ray warp skipping it once none of its lanes can change (bound <=
    1e-5); in each, face by face, t from det and tnum, and u and v only
    where ``1e-5 <= t < bound``, in the compact table's summation order.
    bound (``MaskBest``): nearest, the best t, or the next float above it
    while the seed's face may still lose a tie (face > 0); any-hit,
    t_limit until occluded (a seed <= 0 is not occluded), then -inf."""
    f = torch.stack(list(feats))  # (11, N)
    best = seed_t.clone()
    face = None if any_hit else seed_f.clone()
    if any_hit:
        bound = torch.where(best <= 0.0, f[10], -INF)
    else:
        bound = torch.where(face > 0, torch.nextafter(best, torch.tensor(INF)), best)
    gate = mask.repeat_interleave(cc.TILE, dim=0)  # (N, C)
    s = table.shape[1]
    for c in range(table.shape[0]):
        warp_open = (bound > EPS5).reshape(-1, WARP).any(dim=1).repeat_interleave(WARP)
        on = gate[:, c] & warp_open
        for j in range(s):
            k = table[c, j]
            det = k[0] * f[3] + k[1] * f[4] + k[2] * f[5]
            tnum = k[3] * f[0] + k[4] * f[1] + k[5] * f[2] + k[6]
            inv = 1.0 / det
            t = tnum * inv
            cand = on & (t >= EPS5) & (t < bound)
            unum = (k[7] * f[3] + k[8] * f[4] + k[9] * f[5] + k[10] * f[6] + k[11] * f[7]
                    + k[12] * f[8])
            vnum = (k[13] * f[3] + k[14] * f[4] + k[15] * f[5] + k[16] * f[6] + k[17] * f[7]
                    + k[18] * f[8])
            u, v = unum * inv, vnum * inv
            hit = cand & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            if any_hit:
                best = torch.where(hit, 1.0, best)
                bound = torch.where(hit, -INF, bound)
                continue
            fid = c * s + j
            upd = hit & ((t < best) | ((t == best) & (fid < face)))
            best = torch.where(upd, t, best)
            face = torch.where(upd, torch.tensor(fid, dtype=torch.int32), face)
            bound = torch.where(upd, t, bound)
    return best if any_hit else (best, face)


def _case(seed: int, any_hit: bool):
    """Multiroom's compact table (32 clusters of 64, the last ones padded)
    and 2,048 rays in its rooms (8 tiles), a random verdict mask with one
    tile all off, and adversarial seeds."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    ts = to_torch(scene, "cpu")
    table = ts.clusters.compact
    n = 8 * cc.TILE
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2.8, 2.8, n), rng.uniform(0.1, 1.9, n),
                  rng.uniform(-4.8, 0.8, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o_t = [torch.tensor(a) for a in o]
    d_t = [torch.tensor(a) for a in d]
    t_limit = None
    if any_hit:
        t_lim = rng.uniform(0.0, 4.0, n).astype(np.float32)
        t_lim[::7], t_lim[1::7] = 0.0, np.inf
        t_limit = torch.tensor(t_lim)
    feats = cc._features(cc.Vec3(*o_t), cc.Vec3(*d_t), t_limit)
    mask = torch.tensor(rng.random((n // cc.TILE, table.shape[0])) < 0.7)
    mask[3] = False
    return feats, table, mask, rng


def _nearest_seeds(feats, table, mask, rng):
    """(t, face) seeds: +inf and -1 on most lanes; dead lanes (-3e38);
    NaN; and on every 5th lane the lane's true winner's t with a larger
    face id, so that only the lexicographic merge keeps the winner."""
    n = feats[0].shape[0]
    ref_t, ref_f = cc._masked_plain(feats, table, mask, torch.full((n,), INF),
                                    torch.full((n,), -1, dtype=torch.int32), False)
    seed_t = torch.full((n,), INF)
    seed_f = torch.full((n,), -1, dtype=torch.int32)
    lane = torch.arange(n)
    dead, nan = lane % 11 == 3, lane % 97 == 5
    tie = (lane % 5 == 0) & (ref_f >= 0) & ~dead & ~nan
    seed_t[tie] = ref_t[tie]
    seed_f[tie] = ref_f[tie] + torch.tensor(rng.integers(1, 500, int(tie.sum())),
                                            dtype=torch.int32)
    seed_t[dead] = -3.0e38
    seed_t[nan] = float("nan")
    return seed_t, seed_f, tie


@pytest.mark.parametrize("seed", [0, 1])
def test_t_first_model_matches_plain_nearest(seed):
    """Nearest: the t-first sweep with its exits equals the plain version
    bitwise, the tied seeds lose to the smaller face id of equal t, and
    dead lanes keep their seeds."""
    feats, table, mask, rng = _case(seed, False)
    seed_t, seed_f, tie = _nearest_seeds(feats, table, mask, rng)
    assert int(tie.sum()) > 20
    ref = cc._masked_plain(feats, table, mask, seed_t, seed_f, False)
    got = _t_first_model(feats, table, mask, seed_t, seed_f, False)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(ref[0][tie], seed_t[tie]) and bool((ref[1][tie] < seed_f[tie]).all())
    assert bool((ref[0][seed_t == -3.0e38] == -3.0e38).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_t_first_model_matches_plain_any_hit(seed):
    """Any-hit: t_limit 0 (never occluded), +inf, ordinary; seeds 0, 1
    (kept) and -1 (occluded where a face is): equal to the plain version,
    whose 0/1 result the kernel writes as best > 0."""
    feats, table, mask, rng = _case(seed, True)
    n = feats[0].shape[0]
    seed_occ = torch.zeros(n)
    seed_occ[torch.arange(n) % 6 == 1] = 1.0
    seed_occ[torch.arange(n) % 13 == 2] = -1.0
    ref = cc._masked_plain(feats, table, mask, seed_occ, None, True)
    got = _t_first_model(feats, table, mask, seed_occ, None, True)
    assert torch.equal(got > 0.0, ref > 0.0)
    lim = feats[10]
    assert not bool((ref[(lim == 0.0) & (seed_occ <= 0.0)] > 0.0).any())
    assert bool((ref[seed_occ == 1.0] > 0.0).all())
    assert 0 < int((ref > 0.0).sum()) < n


def test_padding_faces_never_pass():
    """A cluster of padding faces only (det 0: t is +-inf or NaN) changes
    no lane, in the model and in the plain version, seeded +inf or t_limit
    +inf."""
    feats, table, mask, rng = _case(2, True)
    n = feats[0].shape[0]
    pad = torch.zeros_like(table[:1])
    pad[0, :, 3:7] = torch.tensor(rng.normal(size=(table.shape[1], 4)), dtype=torch.float32)
    one = torch.ones((n // cc.TILE, 1), dtype=torch.bool)
    feats[10] = torch.full((n,), INF)
    occ = _t_first_model(feats, pad, one, torch.zeros(n), None, True)
    assert not bool((occ > 0.0).any())
    assert not bool((cc._masked_plain(feats, pad, one, torch.zeros(n), None, True) > 0).any())
    t, f = _t_first_model(feats, pad, one, torch.full((n,), INF),
                          torch.full((n,), -1, dtype=torch.int32), False)
    assert bool((t == INF).all()) and bool((f == -1).all())
