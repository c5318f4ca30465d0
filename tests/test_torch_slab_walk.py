"""Kernel K7, the leaf-slab packet walk (``cuda_bvh.intersect_bvh_packet_hbm``,
instances "K7 nearest" and "K7 NEE"), and its shadow-leg contract.

- The plain version against the JAX package's ``_kernel_hbm`` /
  ``_kernel_hbm_nee`` (``pbr_tpu/ops/pallas_bvh.py``, through
  ``intersect_bvh_packet_hbm`` in interpret mode, as tests/test_pallas_bvh.py
  runs it), on soups whose leaves hold up to 1, 31, 33 and 64 faces: faces
  equal on every lane, t within rtol/atol 1e-6 (the tolerance of
  tests/test_torch_bvh.py: XLA may contract the Moller-Trumbore sums on the
  CPU), and the shadow bit on every lane whose nearest walk hit, at least
  99.9% equal (the shadow ray's length goes through torch's CPU sqrt). A
  lane that missed gives False: the NEE instances walk the shadow ray only
  where the nearest walk hit. With an ``alive`` mask the live lanes give
  the same and the dead ones t +inf, face -1, False.
- The ``pallas_bvh_hbm`` frame (K7 NEE) and the ``pallas_bvh`` frame (K6
  NEE, whose plain version is shared) at 32² are each bitwise the frame of
  the former contract (the shadow ray walked on every live lane), which
  reads the bit only where the nearest walk hit; the former contract did
  occlude some lanes that missed, so the two contracts differ where
  nothing reads them.
- On a card (``cuda``-marked, skipped here): both instances bitwise equal to
  the plain version at leaf sizes 1, 31, 33, 64, 100 and 256, with and
  without an ``alive`` mask.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops import pallas_bvh as jax_pallas_bvh
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.procedural import random_soup
from pbr_tpu.utils.config import BVHConfig as JaxBVHConfig
from pbr_tpu_torch import camera_to_torch, trace_rays
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.intersect import INF
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import bvh_max_leaf, scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.device import to_torch
from pbr_tpu_torch.scene.procedural import grey_soup
from pbr_tpu_torch.utils.config import BVHConfig, RenderSettings

torch.set_num_threads(1)

LIGHT = (0.3, 2.4, 0.1)
TOL = dict(rtol=1e-6, atol=1e-6)
N = 1000


@functools.lru_cache(maxsize=None)
def _scenes(leaf):
    """A 900-face soup with leaves of at most ``leaf`` faces, from both
    host layers (byte-equal, tests/test_torch_bvh_host.py): (JAX scene as
    jnp arrays, the port's SceneParams on the CPU)."""
    obj = random_soup(900, seed=leaf)
    js, _ = jax_scene_from_text(obj, use_bvh=True, bvh_cfg=JaxBVHConfig(max_faces=leaf))
    ps, _ = scene_from_text(obj, use_bvh=True, bvh_cfg=BVHConfig(max_faces=leaf))
    import jax

    return jax.tree_util.tree_map(jnp.asarray, js), to_torch(ps, "cpu")


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (3, N)).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


@functools.lru_cache(maxsize=None)
def _jax(leaf, nee):
    jsj, _ = _scenes(leaf)
    o, d = _rays(leaf)
    kw = dict(light_pos=JVec3(*(jnp.float32(v) for v in LIGHT))) if nee else {}
    out = jax_pallas_bvh.intersect_bvh_packet_hbm(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), jsj.bvh, jsj.tris,
        max_leaf=leaf, interpret=True, **kw)
    return tuple(np.asarray(a) for a in out)


def _port(leaf, nee, alive=None):
    _, ts = _scenes(leaf)
    o, d = _rays(leaf)
    light = Vec3(*(torch.tensor(v, dtype=torch.float32) for v in LIGHT)) if nee else None
    out = cb.intersect_bvh_packet_hbm(Vec3(*map(torch.tensor, o)), Vec3(*map(torch.tensor, d)),
                                      ts.bvh, ts.tris, max_leaf=leaf, light_pos=light,
                                      alive=alive)
    return tuple(a.numpy() for a in out)


def _assert_t(t, ref):
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(t[fin], ref[fin], **TOL)


@pytest.mark.parametrize("leaf", [1, 31, 33, 64])
@pytest.mark.parametrize("nee", [False, True], ids=["nearest", "nee"])
def test_slab_plain_matches_kernel_hbm(leaf, nee):
    """K7 nearest against ``_kernel_hbm``, K7 NEE against
    ``_kernel_hbm_nee``: faces equal, t within 1e-6; NEE's bit held on the
    lanes that hit, False on the others."""
    ref, got = _jax(leaf, nee), _port(leaf, nee)
    assert len(got) == len(ref) == (3 if nee else 2)
    np.testing.assert_array_equal(got[1], ref[1])
    _assert_t(got[0], ref[0])
    hit = got[1] >= 0
    assert 0 < hit.sum() < N
    if nee:
        assert (got[2][hit] == ref[2][hit]).mean() >= 0.999
        assert not got[2][~hit].any()
        assert 0 < got[2].sum() < hit.sum()


@pytest.mark.parametrize("leaf", [31, 64])
def test_slab_plain_with_alive_mask(leaf):
    """K7 NEE with every third lane dead: live lanes as without the mask,
    dead lanes t +inf, face -1 and not occluded."""
    alive = np.arange(N) % 3 != 0
    got, full = _port(leaf, True, torch.tensor(alive)), _port(leaf, True)
    for a, b in zip(got, full):
        np.testing.assert_array_equal(a[alive], b[alive])
    assert np.isinf(got[0][~alive]).all() and (got[1][~alive] == -1).all()
    assert not got[2][~alive].any()


def _frame(monkeypatch, mode: str, former: bool):
    """A 32² frame of bench.py's grey soup (600 faces, 8-face leaves, 3
    bounces) through ``mode``; ``former``: the NEE walks' shadow bit as the
    former contract gave it, the shadow ray walked on every live lane.
    Returns the colors and the number of lanes that missed but were
    occluded under the former contract."""
    ps, _ = scene_from_text(*grey_soup(600), use_bvh=True, bvh_cfg=BVHConfig(max_faces=8))
    cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    missed_occluded = [0]
    real = cb.run

    def former_run(w):
        out = real(w)
        if w.light is None:
            return out
        t, f, occ = out
        hit_p, s_dir, t_light = ci._shadow_ray(w.o, w.d, t, w.light)
        occ_all = cb.walk_plain(hit_p, s_dir, w.tree, w.faces, w.max_leaf, w.alive,
                                t_limit=t_light)[2]
        hit = t < INF
        assert torch.equal(occ_all[hit], occ[hit])
        missed_occluded[0] += int((occ_all & ~hit).sum())
        return t, f, occ_all

    if former:
        monkeypatch.setattr(cb, "run", former_run)
    settings = RenderSettings(width=32, height=32, samples=1, max_depth=3, max_added_depth=0,
                              shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
                              intersector=mode)
    ids = torch.arange(32 * 32, dtype=torch.int32)
    res = trace_rays(to_torch(ps, "cpu"), camera_to_torch(cam, "cpu"), settings, ids, 3,
                     max_leaf=bvh_max_leaf(ps))
    return res.color, missed_occluded[0]


@pytest.mark.parametrize("mode", ["pallas_bvh_hbm", "pallas_bvh"])
def test_pallas_bvh_hbm_frame_is_bitwise_the_former_contracts(monkeypatch, mode):
    """K7 NEE (``pallas_bvh_hbm``) and K6 NEE (``pallas_bvh``) share the
    shadow-leg contract."""
    now, _ = _frame(monkeypatch, mode, False)
    before, missed_occluded = _frame(monkeypatch, mode, True)
    for a, b in zip(now, before):
        assert torch.equal(a, b)
    assert missed_occluded > 0
    assert float(now.x.mean()) > 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", [1, 31, 33, 64, 100, 256])
def test_slab_kernel_matches_plain_on_card(leaf):
    """Both K7 instances against the plain version on the card, bitwise,
    at leaves of up to ``leaf`` faces (max_leaf ``leaf``), on 100,003
    rays with and without every third lane dead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel K7 has no CPU mode")
    dev = torch.device("cuda")
    obj = random_soup(3000, seed=leaf)
    ps, _ = scene_from_text(obj, use_bvh=True, bvh_cfg=BVHConfig(max_faces=leaf))
    ts = to_torch(ps, dev)
    assert int(ts.bvh.leaf_count.max()) <= leaf
    rng = np.random.default_rng(leaf)
    o = rng.uniform(-1.2, 1.2, (3, 100_003)).astype(np.float32)
    d = rng.normal(size=(3, 100_003)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    ov, dv = (Vec3(*(torch.tensor(c, device=dev) for c in a)) for a in (o, d))
    light = torch.tensor(LIGHT, device=dev)
    tab = ci.face_table(ts.tris)
    for alive in (None, torch.tensor(np.arange(100_003) % 3 != 0, device=dev)):
        order = cb.ray_order(ov, dv, ts.bvh, alive)
        for w in (cb.Walk("K7 nearest", ov, dv, ts.bvh, tab, leaf, alive, order),
                  cb.Walk("K7 NEE", ov, dv, ts.bvh, tab, leaf, alive, order, light=light)):
            got, ref = cb._run_kernel(w), cb._run_plain(w)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                assert torch.equal(a, b), (w.kernel, leaf)
            assert 0 < int((got[1] >= 0).sum()) < 100_003
