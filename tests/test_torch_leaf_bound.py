"""The tree walks' leaf bound: every public walk given no ``max_leaf``
walks the tree's own bound (``cuda_bvh.leaf_bound``: its largest leaf),
and a bound below the tree's largest leaf raises, in the walk functions
and in the kernels' input check (``cuda_bvh._check``).

The scene is soup:20001 as the band table builds it
(``pbr_tpu_torch/tools/band_table.py::build_row``): above 20,000 faces a
default build makes 64-face leaves, where a walk bounded at 2 faces a leaf
would skip faces without an error. On 2,048 rays each walk finds the face
``intersect_brute`` finds on every ray (the any-hit walk: the bit
``t < t_limit`` of that face).
"""

import functools

import numpy as np
import pytest
import torch

from pbr_tpu_torch import to_torch
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import phongtess
from pbr_tpu_torch.ops import traverse as tt
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.tools.band_table import build_row

torch.set_num_threads(1)

N_RAYS = 2048


@functools.lru_cache(maxsize=None)
def _case():
    """(SceneParams of soup:20001 on the CPU, 2,048 rays, the brute-force
    (t, face) of each): half from around the bench's eye toward points of
    the soup's box, half from inside the box in random directions."""
    scene, _ = build_row("soup", 20_001)
    ts = to_torch(scene, "cpu")
    rng = np.random.default_rng(20_001)
    half = N_RAYS // 2
    eye = np.array([0.0, 0.0, 3.5])[:, None] + rng.uniform(-0.2, 0.2, (3, half))
    inner = rng.uniform(-1.0, 1.0, (3, N_RAYS - half))
    o = np.concatenate([eye, inner], axis=1)
    d = np.concatenate([rng.uniform(-1.0, 1.0, (3, half)) - eye,
                        rng.normal(size=(3, N_RAYS - half))], axis=1)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = Vec3(*(torch.tensor(c, dtype=torch.float32) for c in o))
    d = Vec3(*(torch.tensor(c, dtype=torch.float32) for c in d))
    return ts, o, d, tt.intersect_brute(o, d, ts.tris)


def test_the_scene_has_big_leaves():
    """The case is the one the fault needs: 64-face leaves, and the rays
    hit faces in many of them."""
    ts, _, _, (_, face) = _case()
    assert ts.bvh.leaf_max == 64 and cb.leaf_bound(ts.bvh) == 64
    assert int((face >= 0).sum()) > N_RAYS // 2


def _t_limit(t):
    """Shadow-ray bounds for the any-hit walk: on even lanes past the
    nearest hit (1.5 t, or 2 on a miss), on odd lanes before it (t / 2)."""
    lim = torch.where(torch.isfinite(t), t * 1.5, torch.full_like(t, 2.0))
    return torch.where(torch.arange(t.shape[0]) % 2 == 0, lim, t * 0.5)


WALKS = {
    "intersect_bvh": lambda o, d, ts, **kw: tt.intersect_bvh(o, d, ts.bvh, ts.tris, **kw)[1],
    "intersect_bvh_chunked": lambda o, d, ts, **kw: tt.intersect_bvh_chunked(
        o, d, ts.bvh, ts.tris, chunk=512, **kw)[1],
    "intersect_bvh_walk": lambda o, d, ts, **kw: cb.intersect_bvh_walk(
        o, d, ts.bvh, ts.tris, **kw)[1],
    "intersect_bvh_packet": lambda o, d, ts, **kw: cb.intersect_bvh_packet(
        o, d, ts.bvh, ts.tris, **kw)[1],
    "intersect_bvh_packet_hbm": lambda o, d, ts, **kw: cb.intersect_bvh_packet_hbm(
        o, d, ts.bvh, ts.tris, **kw)[1],
    "intersect_bvh_phongtess": lambda o, d, ts, **kw: phongtess.intersect_bvh_phongtess(
        o, d, ts.bvh, ts.tris, 0.75, **kw)[1],
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_walk_without_a_bound_finds_every_face(name):
    """With no ``max_leaf`` the walk tests every face of a leaf: its face
    equals the brute-force sweep's on all 2,048 rays."""
    ts, o, d, (_, ref) = _case()
    face = WALKS[name](o, d, ts)
    assert torch.equal(face, ref), f"{int((face != ref).sum())} rays differ"


def test_occluded_walk_without_a_bound_sees_every_face():
    """K8's any-hit walk with no ``max_leaf``: occluded exactly where the
    brute-force nearest face lies before ``t_limit``."""
    ts, o, d, (t, _) = _case()
    lim = _t_limit(t)
    occ = cb.occluded_bvh_walk(o, d, lim, ts.bvh, ts.tris)
    assert torch.equal(occ, t < lim)
    assert 0 < int(occ.sum()) < N_RAYS


@pytest.mark.parametrize("name", sorted(WALKS) + ["occluded_bvh_walk"])
def test_bound_below_the_largest_leaf_raises(name):
    """A bound below the tree's largest leaf (64) raises, where a walk
    would otherwise skip the faces past it; the tree's own bound passes."""
    ts, o, d, (t, _) = _case()
    o, d = (Vec3(*(c[:64] for c in v)) for v in (o, d))
    t = t[:64]
    if name == "occluded_bvh_walk":
        call = lambda **kw: cb.occluded_bvh_walk(o, d, _t_limit(t), ts.bvh, ts.tris, **kw)  # noqa: E731
    else:
        call = lambda **kw: WALKS[name](o, d, ts, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="below the BVH's largest leaf, 64 faces"):
        call(max_leaf=63)
    call(max_leaf=64)


def test_kernel_input_check_raises_on_a_short_bound():
    """``cuda_bvh.run`` refuses a walk record whose bound lies below the
    tree's largest leaf, before any kernel or plain version runs."""
    ts, o, d, _ = _case()
    w = cb.Walk("K8", o, d, ts.bvh, ci.face_table(ts.tris), 2, None, None)
    with pytest.raises(ValueError, match="below the BVH's largest leaf"):
        cb.run(w)
