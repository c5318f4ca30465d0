"""The tree walks' module (pbr_tpu_torch/ops/cuda_bvh.py, kernels K6, K7 and
K8) and their place in the dispatch, against the JAX package.

- ``slab_box`` against ``pbr_tpu.ops.intersect.slab_box`` on random rays
  and the NaN cases (origin on a slab plane with a zero direction
  component): bitwise;
- the plain per-ray walk (``traverse.intersect_bvh``, chunked and not)
  against ``pbr_tpu.ops.traverse.intersect_bvh`` in NumPy and jax.numpy:
  faces, ``tests`` and ``visits`` equal, t within rtol/atol 1e-6 (the
  tolerance of tests/test_pallas_bvh.py: XLA may contract the
  Moller-Trumbore sums on the CPU);
- the plain versions of K6 (every instance), K7 and the forest against
  ``intersect_bvh_packet``, ``intersect_bvh_packet_hbm`` and
  ``intersect_bvh_forest`` run in interpret mode, as the JAX package's own
  tests run them (tests/test_pallas_bvh.py, tests/test_forest.py), on one
  1,024-ray tile of soups of at most 800 faces: faces equal, t within
  1e-6, occlusion on at least 99.9% of rays (the shadow ray's length goes
  through torch's CPU sqrt, which is not correctly rounded);
- ``intersect_scene`` in the four tree modes against the JAX package's.

The kernels themselves run only on a card: the ``cuda``-marked tests hold
them bitwise to the plain versions there and skip here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.accel.forest import build_forest as jax_build_forest
from pbr_tpu.ops import intersect as jax_intersect
from pbr_tpu.ops import pallas_bvh as jax_pallas_bvh
from pbr_tpu.ops import traverse as jax_traverse
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.procedural import random_soup
from pbr_tpu.utils.config import BVHConfig as JaxBVHConfig
from pbr_tpu_torch.accel.forest import build_forest
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import traverse as tt
from pbr_tpu_torch.ops.intersect import slab_box
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.device import to_torch
from pbr_tpu_torch.utils.config import BVHConfig

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

LIGHT = (0.3, 2.4, 0.1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _rays(n, seed, lo=-1.2, hi=1.2):
    """Origins uniform in a box around the soup, random unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _t(a):
    return Vec3(*(torch.tensor(c) for c in a))


def _j(a):
    return JVec3(*(jnp.asarray(c) for c in a))


def _n(a):
    return JVec3(*(np.asarray(c) for c in a))


def _light():
    return Vec3(*(torch.tensor(v, dtype=torch.float32) for v in LIGHT))


def _jlight():
    return JVec3(*(jnp.float32(v) for v in LIGHT))


def _port_scene(n, seed, max_faces=None, chunk=None):
    """The port's NumPy scene of the soup, with an explicit forest when
    ``chunk``."""
    ps, _ = scene_from_text(random_soup(n, seed=seed), use_bvh=True,
                            bvh_cfg=max_faces and BVHConfig(max_faces=max_faces))
    return ps._replace(forest=build_forest(ps.tris, chunk=chunk)) if chunk else ps


@functools.lru_cache(maxsize=None)
def _scenes(n, seed, max_faces=None, chunk=None):
    """The same soup from both host layers (byte-equal,
    test_torch_bvh_host.py): (JAX scene as jnp arrays, JAX scene as NumPy,
    the port's SceneParams on the CPU)."""
    js, _ = jax_scene_from_text(random_soup(n, seed=seed), use_bvh=True,
                                bvh_cfg=max_faces and JaxBVHConfig(max_faces=max_faces))
    if chunk:
        js = js._replace(forest=jax_build_forest(js.tris, chunk=chunk))
    ps = _port_scene(n, seed, max_faces, chunk)
    return jax.tree_util.tree_map(jnp.asarray, js), js, to_torch(ps, "cpu")


def _assert_hit_occlusion(got, ref):
    """The fused shadow bit of a NEE packet walk: equal to the JAX
    kernel's on >= 99.9% of the lanes whose nearest walk hit (the shadow
    ray's length goes through torch's CPU sqrt), False on the others."""
    hit = got[1].numpy() >= 0
    occ = got[2].numpy()
    assert (occ[hit] == np.asarray(ref[2])[hit]).mean() >= 0.999
    assert not occ[~hit].any()


def _assert_t(t, ref):
    ref = np.asarray(ref)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(t[fin], ref[fin], **TOL)


# --- slab_box -----------------------------------------------------------------

def test_slab_box_matches_jax_package_with_nan_cases():
    """Random rays against random boxes, plus rays whose origin lies on a
    slab plane with a zero direction component on that axis (0 * inf =
    NaN): the NaN slab is no constraint, so these hit. Bitwise equal to
    NumPy's slab_box, and the NaN rows hit."""
    rng = np.random.default_rng(0)
    n = 4000
    o, d = _rays(n, 1)
    lo = rng.uniform(-1.0, 0.0, (3, n)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    # NaN cases: every third ray sits on a box face of one axis and is
    # parallel to it; half of those on the min face, half on the max face.
    k = np.arange(0, n, 3)
    ax = k % 3
    on_min = (k // 3) % 2 == 0
    o[ax, k] = np.where(on_min, lo[ax, k], hi[ax, k])
    d[ax, k] = 0.0
    with np.errstate(all="ignore"):
        inv = np.float32(1.0) / d
        ref = jax_intersect.slab_box(np, _n(o), _n(inv), _n(lo), _n(hi))
        got = slab_box(_t(o), _t(inv), _t(lo), _t(hi))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    # A NaN slab is "no constraint": on the box face and parallel to it, a
    # ray still hits when the other two slabs admit it.
    t_near, t_far, hit = got
    inside = np.ones(k.shape, bool)
    for a in range(3):
        other = ax != a
        inside &= ~other | ((lo[a, k] <= o[a, k]) & (o[a, k] <= hi[a, k]))
    assert inside.sum() > 50 and hit.numpy()[k][inside].all()
    assert not np.isnan(t_near.numpy()).any() and not np.isnan(t_far.numpy()).any()


# --- the plain per-ray walk (K8's plain version) -------------------------------

@pytest.mark.parametrize("backend", ["numpy", "jnp"])
def test_intersect_bvh_matches_jax_package_with_counts(backend):
    """700-face soup (2-face leaves) and 800-face soup (8-face leaves,
    max_leaf 8); chunked (odd chunk) and unchunked: faces, tests and visits
    exactly equal, t within 1e-6, and chunked bitwise equal to unchunked."""
    for n_faces, seed, max_faces, ml in ((700, 0, None, 2), (800, 1, 8, 8)):
        jsj, js, ts = _scenes(n_faces, seed, max_faces)
        o, d = _rays(1000, 3 + seed)
        if backend == "numpy":
            with np.errstate(all="ignore"):
                ref = jax_traverse.intersect_bvh(np, _n(o), _n(d), js.bvh, js.tris,
                                                 max_leaf=ml, with_counts=True)
        else:
            ref = jax_traverse.intersect_bvh(jnp, _j(o), _j(d), jsj.bvh, jsj.tris,
                                             max_leaf=ml, with_counts=True)
        got = tt.intersect_bvh(_t(o), _t(d), ts.bvh, ts.tris, max_leaf=ml, with_counts=True)
        chunked = tt.intersect_bvh_chunked(_t(o), _t(d), ts.bvh, ts.tris, max_leaf=ml,
                                           chunk=333, with_counts=True)
        for a, b in zip(chunked, got):
            assert torch.equal(a, b)
        _assert_t(got[0], ref[0])
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int((got[1] >= 0).sum()) > 100 and int(got[3].min()) >= 1


def test_walk_plain_alive_seeds_and_any_hit():
    """Dead lanes walk nothing (t +inf, face -1, zero counts); a seeded
    walk equals the unseeded one min-combined with its seed; an any-hit
    walk against t_limit is occluded exactly where the nearest hit is
    closer than t_limit."""
    _, _, ts = _scenes(700, 0)
    o, d = _rays(1000, 4)
    tab = ci.face_table(ts.tris)
    alive = torch.tensor(np.arange(1000) % 3 != 0)
    t, f, _, tests, visits = cb.walk_plain(_t(o), _t(d), ts.bvh, tab, 2)
    ta, fa, _, testa, visita = cb.walk_plain(_t(o), _t(d), ts.bvh, tab, 2, alive)
    assert torch.equal(ta[alive], t[alive]) and torch.equal(fa[alive], f[alive])
    assert torch.all(ta[~alive] == float("inf")) and torch.all(fa[~alive] == -1)
    assert not testa[~alive].any() and not visita[~alive].any()
    seed_t = torch.where(torch.arange(1000) % 2 == 0, t * 0.5, torch.full_like(t, 1e3))
    seed_f = torch.full_like(f, 7)
    ts_, fs_ = cb.walk_plain(_t(o), _t(d), ts.bvh, tab, 2, t_seed=seed_t, f_seed=seed_f)[:2]
    better = t < seed_t
    assert torch.equal(ts_, torch.where(better, t, seed_t))
    assert torch.equal(fs_, torch.where(better, f, seed_f))
    t_limit = torch.tensor(np.random.default_rng(5).uniform(0.0, 2.0, 1000), dtype=torch.float32)
    occ = cb.walk_plain(_t(o), _t(d), ts.bvh, tab, 2, t_limit=t_limit)[2]
    assert torch.equal(occ, t < t_limit)
    seeded = cb.walk_plain(_t(o), _t(d), ts.bvh, tab, 2, t_limit=t_limit, occ_seed=alive)[2]
    assert torch.equal(seeded, occ | alive)


# --- K6, K7 and the forest: plain versions against the Pallas kernels ----------

def _packet_case(kind):
    """(JAX call, port call) of one K6/K7 instance family on 1,000 rays."""
    if kind == "hbm":
        jsj, _, ts = _scenes(800, 1, 8)
        jfn, pfn, ml = jax_pallas_bvh.intersect_bvh_packet_hbm, cb.intersect_bvh_packet_hbm, 8
    else:
        jsj, _, ts = _scenes(700, 0)
        jfn, pfn, ml = jax_pallas_bvh.intersect_bvh_packet, cb.intersect_bvh_packet, 2
    o, d = _rays(1000, 7)
    return jsj, ts, o, d, jfn, pfn, ml


@pytest.mark.parametrize("kind", ["packet", "hbm"])
@pytest.mark.parametrize("nee", [False, True], ids=["nearest", "nee"])
def test_packet_plain_matches_pallas_interpret(kind, nee):
    """K6's nearest and NEE instances (``pallas_bvh``), K7's (``hbm``,
    8-face leaves): faces equal, t within 1e-6, occlusion on >= 99.9% of
    the lanes that hit and False on the others (the NEE instances walk the
    shadow ray only where the nearest walk hit)."""
    jsj, ts, o, d, jfn, pfn, ml = _packet_case(kind)
    kw = dict(light_pos=_jlight()) if nee else {}
    ref = jfn(jnp, _j(o), _j(d), jsj.bvh, jsj.tris, max_leaf=ml, interpret=True, **kw)
    got = pfn(_t(o), _t(d), ts.bvh, ts.tris, max_leaf=ml,
              **(dict(light_pos=_light()) if nee else {}))
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _assert_t(got[0], ref[0])
    if nee:
        _assert_hit_occlusion(got, ref)
        assert 0 < int(got[2].sum()) < 1000


def _jax_shadow_kernel(jsj, o, d, t_limit, occ_seed=None):
    """``_kernel_shadow`` / ``_kernel_shadow_seeded`` on one 1,024-ray tile
    (the JAX wrapper has no entry point for them: its forest launches them)."""
    n = o.shape[1]
    pad = 1024 - n
    prep = lambda a, v: jnp.concatenate([jnp.asarray(a), jnp.full((pad,), v, jnp.float32)]  # noqa: E731
                                        ).reshape(8, 128)
    rays = [prep(o[i], 1e30) for i in range(3)] + [prep(d[i], 1.0) for i in range(3)]
    nodes = jax_pallas_bvh._node_rows(jnp, jsj.bvh)
    tris = jax_pallas_bvh._tri_rows(jnp, jsj.tris.v0, jsj.tris.e1, jsj.tris.e2)
    call = jax_pallas_bvh._build_call(jsj.bvh.count, int(jsj.tris.v0.x.shape[0]), 8, 2,
                                      interpret=True, shadow=True, seeded=occ_seed is not None)
    args = [nodes, tris, *rays, prep(t_limit, 0.0)]
    if occ_seed is not None:
        args.append(jnp.concatenate([jnp.asarray(occ_seed, jnp.int32),
                                     jnp.zeros((pad,), jnp.int32)]).reshape(8, 128))
    return np.asarray(call(*args)).reshape(-1)[:n] != 0


@pytest.mark.parametrize("seeded", [False, True], ids=["any-hit", "seeded-any-hit"])
def test_any_hit_plain_matches_pallas_interpret(seeded):
    """K6's any-hit instances (``_kernel_shadow``, ``_kernel_shadow_seeded``)
    against the Pallas kernels on one tile: occlusion equal."""
    jsj, _, ts = _scenes(700, 0)
    o, d = _rays(1000, 8)
    t_limit = np.random.default_rng(9).uniform(0.0, 1.5, 1000).astype(np.float32)
    occ_seed = (np.arange(1000) % 5 == 0) if seeded else None
    ref = _jax_shadow_kernel(jsj, o, d, t_limit, occ_seed)
    w = cb.Walk("K6 seeded any-hit" if seeded else "K6 any-hit", _t(o), _t(d), ts.bvh,
                ci.face_table(ts.tris), 2, t_limit=torch.tensor(t_limit),
                occ_seed=None if occ_seed is None else torch.tensor(occ_seed))
    got = cb.run(w)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < 1000


def _jax_subtree0(jsj, o, d, t_limit=None):
    """``_kernel`` (nearest) or ``_kernel_shadow`` (any-hit against
    ``t_limit``) on sub-tree 0 of the JAX forest and its chunk of faces,
    one 1,024-ray tile: what the forest launches first."""
    fo = jsj.forest
    chunk = fo.chunk_size
    n = o.shape[1]
    pad = 1024 - n
    prep = lambda a, v: jnp.concatenate([jnp.asarray(a), jnp.full((pad,), v, jnp.float32)]  # noqa: E731
                                        ).reshape(8, 128)
    rays = [prep(o[i], 1e30) for i in range(3)] + [prep(d[i], 1.0) for i in range(3)]
    sl = lambda v: JVec3(v.x[:chunk], v.y[:chunk], v.z[:chunk])  # noqa: E731
    nodes = jax_pallas_bvh._node_rows(jnp, fo.bvhs[0])
    tris = jax_pallas_bvh._tri_rows(jnp, sl(fo.v0), sl(fo.e1), sl(fo.e2))
    call = jax_pallas_bvh._build_call(fo.bvhs[0].count, chunk, 8, 4, interpret=True,
                                      shadow=t_limit is not None)
    if t_limit is not None:
        return np.asarray(call(nodes, tris, *rays, prep(t_limit, 0.0))).reshape(-1)[:n] != 0
    t, f = call(nodes, tris, *rays)
    return np.asarray(t).reshape(-1)[:n], np.asarray(f).reshape(-1)[:n]


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any-hit"])
def test_forest_subtree0_on_records_matches_pallas_interpret(any_hit):
    """The forest's first walk ("K6 nearest", "K6 any-hit" on sub-tree 0),
    whose tree carries its packed records as views of the forest's (what
    the kernel reads), through the plain version against the Pallas
    kernel on one tile: sub-tree-local faces equal, t within 1e-6;
    occlusion equal."""
    jsj, _, ts = _scenes(700, 0, chunk=256)
    fo = ts.forest
    tree = fo.tree(0)
    assert tree.node_records.data_ptr() == fo.node_records.data_ptr()
    assert tree.face_records.shape == (fo.chunk, 12)
    o, d = _rays(1000, 13)
    t_limit = np.random.default_rng(14).uniform(0.0, 1.5, 1000).astype(np.float32)
    w = cb.Walk("K6 any-hit" if any_hit else "K6 nearest", _t(o), _t(d), tree,
                fo.faces[:, :fo.chunk], 4, t_limit=torch.tensor(t_limit) if any_hit else None)
    got = cb.run(w)
    ref = _jax_subtree0(jsj, o, d, t_limit if any_hit else None)
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < ref.sum() < 1000
        return
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    _assert_t(got[0], ref[0])
    assert (ref[1] >= 0).sum() > 50


@pytest.mark.parametrize("kernel", ["K6 nearest", "K6 NEE", "K6 any-hit"])
def test_k6_takes_no_tree_without_its_records(kernel):
    """K6's single-tree walks read the packed records, as K7's and K8's do:
    a tree without them raises, on the CPU as on a card, naming the
    records; the tables of to_torch have them."""
    _, _, ts = _scenes(700, 0)
    o = Vec3(*(torch.zeros(4) for _ in range(3)))
    d = Vec3(torch.ones(4), torch.zeros(4), torch.zeros(4))
    kw = dict(light=torch.tensor(LIGHT)) if kernel == "K6 NEE" else \
        dict(t_limit=torch.ones(4)) if kernel == "K6 any-hit" else {}
    tab = ci.face_table(ts.tris)
    for bare in (ts.bvh._replace(node_records=None), ts.bvh._replace(face_records=None)):
        with pytest.raises(ValueError, match="packed records"):
            cb.run(cb.Walk(kernel, o, d, bare, tab, 2, **kw))
    cb.run(cb.Walk(kernel, o, d, ts.bvh, tab, 2, **kw))


@pytest.mark.parametrize("nee", [False, True], ids=["nearest", "nee"])
def test_forest_plain_matches_pallas_interpret(nee):
    """The forest (K6's seeded chain over 3 sub-trees of 256 faces, the
    last one partial, as tests/test_forest.py builds it): main-order faces
    equal, t within 1e-6, occlusion on >= 99.9%."""
    jsj, _, ts = _scenes(700, 0, chunk=256)
    o, d = _rays(1000, 5)
    ref = jax_pallas_bvh.intersect_bvh_forest(
        jnp, _j(o), _j(d), jsj.forest, jsj.bvh, interpret=True,
        **(dict(light_pos=_jlight()) if nee else {}))
    got = cb.intersect_bvh_forest(_t(o), _t(d), ts.forest, ts.bvh,
                                  **(dict(light_pos=_light()) if nee else {}))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _assert_t(got[0], ref[0])
    if nee:
        assert (got[2].numpy() == np.asarray(ref[2])).mean() >= 0.999


def test_forest_equals_the_single_tree_walk():
    """The forest's chain gives the faces and t of the walk over the main
    tree, bitwise (both run the same classic test), with and without dead
    lanes."""
    _, _, ts = _scenes(700, 0, chunk=256)
    o, d = _rays(1000, 6)
    alive = torch.tensor(np.arange(1000) % 4 != 0)
    for al in (None, alive):
        tf, ff = cb.intersect_bvh_forest(_t(o), _t(d), ts.forest, ts.bvh, alive=al)
        tw, fw = cb.intersect_bvh_walk(_t(o), _t(d), ts.bvh, ts.tris, alive=al)
        assert torch.equal(ff, fw) and torch.equal(tf, tw)


# --- intersect_scene ---------------------------------------------------------

def _patched_interpret(monkeypatch):
    """The JAX dispatch's Pallas walks in interpret mode (the technique of
    tests/test_forest.py)."""
    for name in ("intersect_bvh_packet", "intersect_bvh_packet_hbm", "intersect_bvh_forest"):
        fn = getattr(jax_pallas_bvh, name)
        monkeypatch.setattr(jax_pallas_bvh, name,
                            functools.partial(fn, interpret=True))


@pytest.mark.parametrize("mode", ["bvh", "pallas_bvh", "pallas_bvh_forest", "pallas_bvh_hbm"])
def test_intersect_scene_tree_modes_match_jax_package(mode, monkeypatch):
    """Each tree mode through both dispatches, NEE on (occlusion is None for
    'bvh', which has no fused leg, and the packet walks' bit is held on the
    lanes that hit): faces equal, the re-evaluated t within 1e-6; with
    counts, 'bvh' gives JAX's exact (tests, visits) and the packet walks
    (None, None)."""
    _patched_interpret(monkeypatch)
    ml = 8 if mode == "pallas_bvh_hbm" else 2
    jsj, _, ts = _scenes(800, 1, 8) if mode == "pallas_bvh_hbm" else _scenes(700, 0, chunk=256)
    o, d = _rays(1000, 11)
    counts = mode in ("bvh", "pallas_bvh")
    ref = jax_traverse.intersect_scene(jnp, _j(o), _j(d), jsj, max_leaf=ml, mode=mode,
                                       light_pos=_jlight(), with_counts=counts)
    got = tt.intersect_scene(_t(o), _t(d), ts.tris, mode=mode, light_pos=_light(),
                             with_counts=counts, bvh=ts.bvh, forest=ts.forest, max_leaf=ml)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _assert_t(got[0], ref[0])
    if mode == "bvh":
        assert got[2] is None and ref[2] is None
    elif mode == "pallas_bvh_forest":
        assert (got[2].numpy() == np.asarray(ref[2])).mean() >= 0.999
    else:
        _assert_hit_occlusion(got, ref)
    if mode == "bvh":
        for a, b in zip(got[3], ref[3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    elif counts:
        assert got[3] == (None, None)


def test_intersect_scene_auto_walks_trees_without_clusters():
    """``auto`` on a scene above 10,000 faces without clusters runs the
    forest when there is one and the per-ray walk when not (the JAX TPU
    dispatch); the tree modes raise ValueError without their tables."""
    _, _, ts = _scenes(700, 0, chunk=256)
    dev = torch.device("cpu")
    assert tt.resolve_mode("auto", dev, 12_000, False, True, True) == "pallas_bvh_forest"
    assert tt.resolve_mode("auto", dev, 12_000, False, True, False) == "bvh"
    o, d = _rays(64, 12)
    for mode in ("bvh", "pallas_bvh", "pallas_bvh_hbm", "pallas_bvh_forest"):
        with pytest.raises(ValueError, match="needs a scene with"):
            tt.intersect_scene(_t(o), _t(d), ts.tris, mode=mode)
    with pytest.raises(ValueError, match="BVH forest"):
        tt.intersect_scene(_t(o), _t(d), ts.tris, mode="pallas_bvh_forest", bvh=ts.bvh)


def test_wrappers_check_capacity_and_inputs():
    """The TPU kernels' capacities are checked, not found by a crash: the
    packet walk needs nodes + faces <= PALLAS_BVH_MAX_ROWS, the slab walk
    nodes <= PACKET_HBM_MAX_NODES and max_leaf <= SLAB_MAX_LEAF; bad ray
    arrays and per-ray inputs raise."""
    _, _, ts = _scenes(700, 0)
    o, d = _rays(64, 13)
    small = cb.PALLAS_BVH_MAX_ROWS
    try:
        cb.PALLAS_BVH_MAX_ROWS = ts.bvh.count + 699
        with pytest.raises(ValueError, match="node \\+ face rows"):
            cb.intersect_bvh_packet(_t(o), _t(d), ts.bvh, ts.tris)
        cb.PALLAS_BVH_MAX_ROWS = ts.bvh.count + 700
        cb.intersect_bvh_packet(_t(o), _t(d), ts.bvh, ts.tris)
    finally:
        cb.PALLAS_BVH_MAX_ROWS = small
    assert cb.packet_hbm_fits(ts.bvh) and not cb.packet_hbm_fits(
        ts.bvh._replace(exit=torch.zeros(cb.PACKET_HBM_MAX_NODES + 1, dtype=torch.int32)))
    with pytest.raises(ValueError, match="at most 256 faces"):
        cb.intersect_bvh_packet_hbm(_t(o), _t(d), ts.bvh, ts.tris, max_leaf=257)
    with pytest.raises(ValueError, match="float32"):
        cb.intersect_bvh_walk(Vec3(*(torch.tensor(c, dtype=torch.float64) for c in o)), _t(d),
                              ts.bvh, ts.tris)
    with pytest.raises(ValueError, match="per-ray"):
        cb.intersect_bvh_walk(_t(o), _t(d), ts.bvh, ts.tris, alive=torch.ones(63, dtype=torch.bool))
    with pytest.raises(ValueError, match="max_leaf"):
        cb.intersect_bvh_walk(_t(o), _t(d), ts.bvh, ts.tris, max_leaf=0)


# --- the kernels on the card ---------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels K6, K7 and K8 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("alive", [False, True], ids=["all-live", "alive-mask"])
def test_kernels_match_plain_on_card(alive):
    """Every instance of K6, K7 and K8 against the plain version on the
    card, bitwise: 100,003 rays on a 700-face soup with a 3-tree forest
    (chunk 256) and 8-face leaves for K7."""
    dev = _card()
    n = 100_003
    o, d = _rays(n, 21)
    ov, dv = Vec3(*(torch.tensor(c, device=dev) for c in o)), Vec3(*(torch.tensor(c, device=dev)
                                                                  for c in d))
    al = torch.tensor(np.arange(n) % 3 != 0, device=dev) if alive else None
    light = torch.tensor(LIGHT, device=dev)
    t_limit = torch.tensor(np.random.default_rng(22).uniform(0, 1.5, n), dtype=torch.float32,
                           device=dev)
    for n_faces, seed, mf, ml in ((700, 0, None, 2), (800, 1, 8, 8)):
        ts = to_torch(_port_scene(n_faces, seed, mf, 256 if mf is None else None), dev)
        tab = ci.face_table(ts.tris)
        order = cb.ray_order(ov, dv, ts.bvh, al)
        seeds = cb._run_plain(cb.Walk("K8", ov, dv, ts.bvh, tab, ml, al))
        walks = [cb.Walk("K8", ov, dv, ts.bvh, tab, ml, al, order),
                 cb.Walk("K8", ov, dv, ts.bvh, tab, ml, al, order, with_counts=True),
                 cb.Walk("K7 nearest", ov, dv, ts.bvh, tab, ml, al, order),
                 cb.Walk("K7 NEE", ov, dv, ts.bvh, tab, ml, al, order, light=light),
                 cb.Walk("K6 nearest", ov, dv, ts.bvh, tab, ml, al, order),
                 cb.Walk("K6 NEE", ov, dv, ts.bvh, tab, ml, al, order, light=light),
                 cb.Walk("K6 any-hit", ov, dv, ts.bvh, tab, ml, al, order, t_limit=t_limit),
                 cb.Walk("K6 seeded", ov, dv, ts.bvh, tab, ml, al, order,
                         t_seed=seeds[0] * 1.0001, f_seed=seeds[1]),
                 cb.Walk("K6 seeded any-hit", ov, dv, ts.bvh, tab, ml, al, order,
                         t_limit=t_limit, occ_seed=torch.arange(n, device=dev) % 7 == 0)]
        for w in walks:
            got, ref = cb._run_kernel(w), cb._run_plain(w)
            torch.cuda.synchronize()
            got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
            for a, b in zip(got, ref):
                assert torch.equal(a, b), w.kernel
        if ts.forest is not None:
            for lp in (None, light):
                got = cb._forest(cb._run_kernel, ov, dv, ts.forest, order, 4, lp, al)
                ref = cb._forest(cb._run_plain, ov, dv, ts.forest, None, 4, lp, al)
                for a, b in zip(got, ref):
                    assert torch.equal(a, b), "forest"
