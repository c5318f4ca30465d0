"""The port's cull verdicts (pbr_tpu_torch/ops/cull.py) against the JAX
package's backend-generic ``pbr_tpu.ops.cull``, run with NumPy and with
jax.numpy on the CPU.

The verdict masks must be equal. The one operation that could flip a bit
is the ``sqrt`` of the box-distance bound: torch's float32 CPU sqrt is 1
ULP off NumPy on ~0.7% of inputs. On these inputs no bit flips, so the
masks are held equal; the entry bounds (which carry that sqrt) are held to
rtol 1e-6. Conservativeness is checked on its own: every cluster that a
live ray of a tile really hits is set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops import cull as jcull
from pbr_tpu.ops.traverse import intersect_brute
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text
from pbr_tpu.scene.procedural import multi_room, random_soup
from pbr_tpu_torch.ops import cull
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine (measured: a
# 3 s test took 180 s with four workers).
torch.set_num_threads(1)


def _scene(kind):
    if kind == "soup":  # 400 faces: 7 real clusters padded to 16 (inverted AABBs)
        scene, _ = scene_from_text(random_soup(400, seed=3), use_bvh=True)
    else:
        scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    return scene


def _rays(kind, n, seed):
    """Bounce-like rays: origins inside the scene, unit directions over the
    whole sphere (every tile mixes direction signs), a few axis-aligned."""
    rs = np.random.RandomState(seed)
    if kind == "soup":
        o = rs.uniform(-1.2, 1.2, size=(3, n))
    else:
        o = np.stack([rs.uniform(-3.0, 3.0, n), rs.uniform(0.05, 1.95, n),
                      rs.uniform(-5.0, 1.0, n)])
    d = rs.normal(size=(3, n))
    d[:2, : n // 16] = 0.0  # straight along z: zero direction components
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t3(a):
    return Vec3(*(torch.tensor(c) for c in a))


def _tile_bounds(a, tile):
    a2 = a.reshape(3, -1, tile)
    return a2.min(axis=2), a2.max(axis=2)


@pytest.mark.parametrize("kind", ["soup", "multiroom"])
@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("capped", [False, True])
def test_frustum_hits_matches_numpy(kind, tile, capped):
    scene = _scene(kind)
    cs = scene.clusters
    o, d = _rays(kind, 16 * tile, seed=tile)
    o_lo, o_hi = _tile_bounds(o, tile)
    d_lo, d_hi = _tile_bounds(d, tile)
    cap = np.random.RandomState(1).uniform(0.05, 3.0, o_lo.shape[1]).astype(np.float32)
    with np.errstate(all="ignore"):
        ref_hit, ref_te = jcull.frustum_hits(
            np, JVec3(*o_lo), JVec3(*o_hi), JVec3(*d_lo), JVec3(*d_hi),
            cs.bb_min, cs.bb_max, cap if capped else None,
        )
    tc = to_torch(scene, "cpu").clusters
    hit, te = cull.frustum_hits(_t3(o_lo), _t3(o_hi), _t3(d_lo), _t3(d_hi),
                                tc.bb_min, tc.bb_max, torch.tensor(cap) if capped else None)
    np.testing.assert_array_equal(hit.numpy(), ref_hit)
    np.testing.assert_allclose(te.numpy(), ref_te, rtol=1e-6)
    assert 0 < ref_hit.mean() < 1  # the test cuts something and keeps something


@pytest.mark.parametrize("kind", ["soup", "multiroom"])
@pytest.mark.parametrize("live_kind", ["all", "thirds", "none_in_tile_0"])
@pytest.mark.parametrize("capped", [False, True])
def test_frustum_hits_octants_matches_numpy(kind, live_kind, capped):
    scene = _scene(kind)
    cs = scene.clusters
    g = 128
    o, d = _rays(kind, 8 * g, seed=5)
    live = np.ones(8 * g, dtype=bool)
    if live_kind == "thirds":
        live = np.arange(8 * g) % 3 != 0
    elif live_kind == "none_in_tile_0":
        live[:g] = False
    cap = np.random.RandomState(2).uniform(0.1, 2.0, 8).astype(np.float32) if capped else None
    with np.errstate(all="ignore"):
        ref_hit, ref_te = jcull.frustum_hits_octants(
            np, JVec3(*o), JVec3(*d), g, cs.bb_min, cs.bb_max, cap,
            live=None if live_kind == "all" else live,
        )
    tc = to_torch(scene, "cpu").clusters
    hit, te = cull.frustum_hits_octants(
        _t3(o), _t3(d), g, tc.bb_min, tc.bb_max, None if cap is None else torch.tensor(cap),
        live=None if live_kind == "all" else torch.tensor(live),
    )
    np.testing.assert_array_equal(hit.numpy(), ref_hit)
    np.testing.assert_allclose(te.numpy(), ref_te, rtol=1e-6)
    if live_kind == "none_in_tile_0":
        assert not hit[0].any()  # a group with no live lane gets no cluster


@pytest.mark.parametrize("octants", [True, False])
@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_fine_hit_mask_matches_jax_package(octants, backend):
    scene = _scene("multiroom")
    cs = scene.clusters
    tile = 256
    o, d = _rays("multiroom", 6 * tile, seed=9)
    live = np.arange(6 * tile) % 5 != 1
    xp = np if backend == "numpy" else jnp
    conv = (lambda a: a) if xp is np else jnp.asarray
    jcs = cs if xp is np else cs._replace(
        bb_min=JVec3(*map(jnp.asarray, cs.bb_min)), bb_max=JVec3(*map(jnp.asarray, cs.bb_max)))
    with np.errstate(all="ignore"):
        ref = np.asarray(jcull.fine_hit_mask(
            xp, JVec3(*map(conv, o)), JVec3(*map(conv, d)), jcs, tile,
            octants=octants, live=conv(live)))
    got = cull.fine_hit_mask(_t3(o), _t3(d), to_torch(scene, "cpu").clusters, tile,
                             octants=octants, live=torch.tensor(live))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["soup", "multiroom"])
def test_fine_hit_mask_is_conservative(kind):
    """Every cluster holding the nearest hit of a live ray is set for that
    ray's tile, and the octant verdicts set no more clusters than the plain
    tile frustums."""
    scene = _scene(kind)
    tile = 128
    o, d = _rays(kind, 12 * tile, seed=11)
    live = np.arange(12 * tile) % 4 != 0
    with np.errstate(all="ignore"):
        _, face = intersect_brute(np, JVec3(*o), JVec3(*d), scene.tris)
    tc = to_torch(scene, "cpu").clusters
    mask = cull.fine_hit_mask(_t3(o), _t3(d), tc, tile, live=torch.tensor(live)).numpy()
    plain = cull.fine_hit_mask(_t3(o), _t3(d), tc, tile, octants=False).numpy()
    need = (face >= 0) & live
    tiles = np.arange(o.shape[1]) // tile
    assert need.sum() > 100
    assert mask[tiles[need], face[need] // tc.size].all()
    assert mask.sum() <= plain.sum()


def test_padding_clusters_never_hit():
    """Padding clusters carry inverted AABBs: never set, even for a tile
    whose direction intervals span 0 on every axis (no slab constraint)."""
    scene = _scene("soup")
    tc = to_torch(scene, "cpu").clusters
    real = int(np.ceil(scene.tris.count / tc.size))
    assert tc.count > real
    o, d = _rays("soup", 4 * 128, seed=4)
    hit = cull.fine_hit_mask(_t3(o), _t3(d), tc, 128, octants=False)
    assert hit[:, :real].any() and not hit[:, real:].any()
    hit8 = cull.fine_hit_mask(_t3(o), _t3(d), tc, 128)
    assert not hit8[:, real:].any()


def test_tile_minmax():
    a = torch.tensor(np.random.RandomState(0).normal(size=512).astype(np.float32))
    lo, hi = cull._tile_minmax(a, 128)
    ref_lo, ref_hi = jcull._tile_minmax(np, a.numpy(), 128)
    np.testing.assert_array_equal(lo.numpy(), ref_lo)
    np.testing.assert_array_equal(hi.numpy(), ref_hi)


def _big_soup():
    """A 6,400-face soup: 112 clusters in 7 superclusters."""
    scene, _ = scene_from_text(random_soup(6400, seed=11), use_bvh=True)
    return scene


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_coherence_keys_match_jax_package(backend):
    """Octant + Morton keys, integer-exact, including origins outside the
    scene bounds (clamped) and zero direction components."""
    scene = _big_soup()
    cs = scene.clusters
    o, d = _rays("soup", 4096, seed=17)
    o[:, :256] *= 3.0  # outside the bounds on some axes
    xp = np if backend == "numpy" else jnp
    ref = np.asarray(jcull.coherence_keys(xp, JVec3(*map(xp.asarray, o)),
                                          JVec3(*map(xp.asarray, d)),
                                          cs.scene_min, cs.scene_max))
    tc = to_torch(scene, "cpu").clusters
    got = cull.coherence_keys(_t3(o), _t3(d), tc.scene_min, tc.scene_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 1000 and len(np.unique(ref >> 27)) == 8


def _sorted_rays(scene, n, seed):
    o, d = _rays("soup", n, seed=seed)
    cs = scene.clusters
    keys = jcull.coherence_keys(np, JVec3(*o), JVec3(*d), cs.scene_min, cs.scene_max)
    perm = np.argsort(keys, kind="stable")
    return o[:, perm], d[:, perm]


@pytest.mark.parametrize("kind", ["big_soup", "multiroom"])
@pytest.mark.parametrize("backend", ["numpy", "jax"])
@pytest.mark.parametrize("capped", [False, True])
def test_candidates_match_jax_package(kind, backend, capped):
    """Counts equal; each tile's listed entries (fine cluster ids with their
    CAND_MISS bits) equal as sets, since argsort ties may order differently
    across backends (tests/test_cull.py:112-116); entry bounds within 1e-6."""
    scene = _big_soup() if kind == "big_soup" else _scene("multiroom")
    cs = scene.clusters
    tile = 256
    o, d = _sorted_rays(scene, 8 * tile, seed=23)
    cap = np.random.RandomState(3).uniform(0.2, 3.0, 8).astype(np.float32) if capped else None
    xp = np if backend == "numpy" else jnp
    jcs = cs if xp is np else jax.tree_util.tree_map(jnp.asarray, cs)
    with np.errstate(all="ignore"):
        ref = [np.asarray(a) for a in jcull.candidates(
            xp, JVec3(*map(xp.asarray, o)), JVec3(*map(xp.asarray, d)), jcs, tile,
            t_cap=None if cap is None else xp.asarray(cap))]
    tc = to_torch(scene, "cpu").clusters
    got = [a.numpy() for a in cull.candidates(_t3(o), _t3(d), tc, tile,
                                              t_cap=None if cap is None else torch.tensor(cap))]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert got[2].dtype == np.float32 and got[0].shape == ref[0].shape
    np.testing.assert_array_equal(got[1], ref[1])
    for t in range(got[0].shape[0]):
        assert set(got[0][t, : got[1][t]]) == set(ref[0][t, : ref[1][t]]), t
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=1e-6)
    listed = np.arange(got[0].shape[1])[None, :] < got[1][:, None]
    miss = got[0] >= cull.CAND_MISS
    assert listed.any() and (listed & miss).any() and (listed & ~miss).any()


def test_candidates_are_near_to_far_and_conservative():
    """Listed slots come in non-decreasing entry bound, and every cluster
    holding a ray's nearest hit is listed without its miss bit."""
    scene = _big_soup()
    tile = 256
    o, d = _sorted_rays(scene, 8 * tile, seed=29)
    tc = to_torch(scene, "cpu").clusters
    cand, cnt, tent = (a.numpy() for a in cull.candidates(_t3(o), _t3(d), tc, tile))
    with np.errstate(all="ignore"):
        _, face = intersect_brute(np, JVec3(*o), JVec3(*d), scene.tris)
    for t in range(cand.shape[0]):
        row = tent[t, : cnt[t]]
        assert np.all(np.diff(row) >= 0)
        need = face[t * tile:(t + 1) * tile]
        need = np.unique(need[need >= 0] // tc.size)
        assert set(need) <= set(cand[t, : cnt[t]])
