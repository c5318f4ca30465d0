"""Kernel K8's two instances (pbr_tpu_torch/ops/cuda_bvh.py,
csrc/bvh_walk.cu): the packed tables it reads and the any-hit shadow leg of
the ``bvh`` mode, against the JAX package and against the form it replaces.

- ``node_records`` and ``face_records`` unpack bitwise to the SoA tables of
  a soup's tree and of a forest's sub-trees; the node packer raises on a
  field it cannot hold, and never truncates;
- ``occluded_bvh_walk`` (K8 any-hit; on the CPU its plain version) equals
  the old form of the shadow leg, the nearest search on every lane then
  ``t < t_light``, on every live lane, and the JAX package's
  ``_shadow_occluded``: grey soups with 2- and 64-face leaves, rays with
  ``t_light`` 0, +inf and ordinary values, and dead lanes (False);
- its counters are those of a walk written out ray by ray here: node
  steps, and face tests up to and including the occluding face;
- K8 takes no tree without its packed records (no repacking on a launch);
- a 16² ``bvh`` frame with NEE through the new shadow leg equals, bitwise,
  the same frame through the old form (tests/test_torch_bvh_render.py
  holds the frame to the JAX package).

The kernels run only on a card: the ``cuda``-marked test holds both K8
instances bitwise to ``walk_plain``, counters included, and skips here.
"""

import functools

import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.utils.config import BVHConfig as JaxBVHConfig
from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.accel.forest import build_forest
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import traverse as tt
from pbr_tpu_torch.ops.intersect import EPS5, moller_trumbore, slab_box
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import bvh_max_leaf, scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import grey_soup
from pbr_tpu_torch.utils.config import BVHConfig, RenderSettings

torch.set_num_threads(1)

LIGHT = (0.3, 2.4, 0.1)


@functools.lru_cache(maxsize=None)
def _scenes(n_faces, leaves):
    """bench.py's grey soup at ``n_faces`` with ``leaves``-face leaves, in
    both host layers (byte-equal, test_torch_bvh_host.py), with a forest of
    256-face chunks on the port's: (JAX NumPy scene, port scene, its
    SceneParams on the CPU)."""
    obj = grey_soup(n_faces)
    js, _ = jax_scene_from_text(*obj, use_bvh=True, bvh_cfg=JaxBVHConfig(max_faces=leaves))
    ps, _ = scene_from_text(*obj, use_bvh=True, bvh_cfg=BVHConfig(max_faces=leaves))
    ps = ps._replace(forest=build_forest(ps.tris, chunk=256))
    return js, ps, to_torch(ps, "cpu")


def _unpack(rec, frec):
    """The SoA tables back from the packed records (the test's own decoding
    of the layout csrc/bvh_walk.cu reads)."""
    bits = rec.view(torch.int32)
    word = bits[:, 7]
    leaf = word >= 0
    first = torch.where(leaf, word >> cb.LEAF_COUNT_BITS, -1)
    count = torch.where(leaf, (word & ((1 << cb.LEAF_COUNT_BITS) - 1)) + 1, 0)
    faces = frec.reshape(-1, 3, 4)[:, :, :3].reshape(-1, 9).T
    return rec[:, 0:3].T, rec[:, 4:7].T, first, count, bits[:, 3], faces, frec.reshape(-1, 3, 4)


@pytest.mark.parametrize("tree", ["soup", "forest"])
def test_records_unpack_bitwise_to_the_soa_tables(tree):
    """The scene's tree (64-face leaves; its records built by to_torch) and
    each sub-tree of a forest (padding nodes with inverted boxes; its
    records the views ``ForestTables.tree`` cuts from the forest's): bounds,
    leaf_first, leaf_count and exit, and the faces, bitwise; the face
    records' padding is zero."""
    _, _, ts = _scenes(3000, 64)
    tab = ci.face_table(ts.tris)
    if tree == "soup":
        cases = [(ts.bvh, ts.bvh.node_records, ts.bvh.face_records, tab)]
        assert ts.bvh.node_records.shape == (ts.bvh.count, 8)
    else:
        fo = ts.forest
        cases = [(fo.tree(i), fo.tree(i).node_records, fo.tree(i).face_records,
                  fo.faces[:, i * fo.chunk:(i + 1) * fo.chunk]) for i in range(fo.count)]
        assert fo.count == 12
        # a sub-tree's records are views of the forest's, which to_torch built
        assert fo.tree(0).node_records.data_ptr() == fo.node_records.data_ptr()
        assert fo.tree(1).face_records.data_ptr() == fo.face_records[fo.chunk].data_ptr()
    for bvh, rec, frec, faces in cases:
        lo, hi, first, count, exit_, fun, padded = _unpack(rec, frec)
        for a, b in ((lo, bvh.bb_min), (hi, bvh.bb_max), (first, bvh.leaf_first),
                     (count, bvh.leaf_count), (exit_, bvh.exit), (fun, faces)):
            assert a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.int32),
                                                      b.contiguous().view(torch.int32))
        assert not padded[:, :, 3].any()
        assert int((bvh.leaf_first >= 0).sum()) > 10


@pytest.mark.parametrize("field, value, what", [
    ("leaf_count", 0, "a leaf of no faces"),
    ("leaf_count", (1 << cb.LEAF_COUNT_BITS) + 1, "a leaf of too many faces"),
    ("leaf_first", 1 << (31 - cb.LEAF_COUNT_BITS), "a first face past the field"),
    ("inner_count", 3, "an inner node with a count"),
])
def test_node_records_raise_on_a_field_they_cannot_hold(field, value, what):
    """The node packer raises, naming the node, where a field does not fit
    its encoding; at the largest values that fit it packs them exactly."""
    _, _, ts = _scenes(3000, 64)
    bvh = ts.bvh
    leaf = int(torch.nonzero(bvh.leaf_first >= 0)[0])
    inner = int(torch.nonzero(bvh.leaf_first < 0)[0])
    row = inner if field == "inner_count" else leaf
    name = "leaf_count" if field == "inner_count" else field
    bad = getattr(bvh, name).clone()
    bad[row] = value
    with pytest.raises(ValueError, match=f"node {row} "):
        cb.node_records(bvh._replace(**{name: bad}))
    if field != "inner_count":
        fits = getattr(bvh, name).clone()
        fits[row] = max(1, value - 1) if value else 1
        rec = cb.node_records(bvh._replace(**{name: fits}))
        got = _unpack(rec, ts.bvh.face_records)[2 if name == "leaf_first" else 3]
        assert int(got[row]) == int(fits[row]), what


def _shadow_rays(ts, n, seed):
    """``n`` rays from points of the soup's faces toward the light, as the
    integrator casts them, with a spread of t_light: the light's distance,
    and 0, +inf and random values on some lanes; and a liveness mask."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, int(ts.tris.mtl.shape[0]), n)
    u, v = rng.random(n).astype(np.float32) * 0.5, rng.random(n).astype(np.float32) * 0.5
    v0, e1, e2 = (np.stack([c.numpy() for c in vec])[:, f] for vec in
                  (ts.tris.v0, ts.tris.e1, ts.tris.e2))
    p = (v0 + e1 * u + e2 * v).astype(np.float32)
    p[:, ::5] = rng.uniform(-1.2, 1.2, (3, p[:, ::5].shape[1]))  # some from open space
    lv = np.array(LIGHT, np.float32)[:, None] - p
    t_light = np.sqrt((lv * lv).sum(axis=0)).astype(np.float32)
    d = (lv / t_light).astype(np.float32)
    t_light[1::7] = 0.0
    t_light[2::7] = np.inf
    t_light[3::7] = rng.uniform(0.0, 1.0, t_light[3::7].shape).astype(np.float32)
    alive = np.arange(n) % 4 != 0
    return p, d, t_light, alive


@pytest.mark.parametrize("n_faces, leaves", [(700, 2), (3000, 64)])
def test_any_hit_wrapper_equals_the_old_form_and_the_jax_package(n_faces, leaves):
    """``occluded_bvh_walk`` on live lanes: the old form's bit (the nearest
    search of ``intersect_scene(mode='bvh')`` on every lane, then t <
    t_light) and the JAX package's ``_shadow_occluded`` (its NumPy
    backend); False on dead lanes; its counters are the any-hit walk's,
    never more than the nearest walk's."""
    js, ps, ts = _scenes(n_faces, leaves)
    ml = bvh_max_leaf(ps)
    p, d, t_light, alive = _shadow_rays(ts, 1500, n_faces)
    tp, td = Vec3(*(torch.tensor(c) for c in p)), Vec3(*(torch.tensor(c) for c in d))
    tl, al = torch.tensor(t_light), torch.tensor(alive)
    occ, tests, visits = cb.occluded_bvh_walk(tp, td, tl, ts.bvh, ts.tris, ml, alive=al,
                                              with_counts=True)
    t_old = tt.intersect_scene(tp, td, ts.tris, mode="bvh", bvh=ts.bvh, max_leaf=ml)[0]
    old = (t_old < tl).numpy()
    with np.errstate(all="ignore"):
        ref = np.asarray(jax_integrator._shadow_occluded(
            np, js, JVec3(*p), JVec3(*d), t_light, ml, "bvh"))
    got = occ.numpy()
    assert not got[~alive].any()
    np.testing.assert_array_equal(got[alive], old[alive])
    np.testing.assert_array_equal(got[alive], ref[alive])
    assert 0 < got.sum() < alive.sum() and not got[1::7].any()
    _, _, n_tests, n_visits = tt.intersect_bvh(tp, td, ts.bvh, ts.tris, ml, with_counts=True)
    live = torch.tensor(alive)
    assert not tests[~live].any() and not visits[~live].any()
    assert bool((visits[live] <= n_visits[live]).all()) and int(visits[live].min()) >= 1
    assert int(tests.sum()) < int(n_tests[live].sum())


def _any_hit_by_hand(o, d, t_limit, bvh, faces, max_leaf):
    """Each ray's any-hit walk, one node step at a time in Python: its bit,
    its face tests (a leaf's faces up to and including the occluding one,
    where it stops; the whole leaf otherwise), the tests of the same walk
    counting every hit leaf whole, and its node steps."""
    out = []
    for j in range(o.x.shape[0]):
        oj, dj = Vec3(o.x[j:j + 1], o.y[j:j + 1], o.z[j:j + 1]), \
            Vec3(d.x[j:j + 1], d.y[j:j + 1], d.z[j:j + 1])
        inv = Vec3(1.0 / dj.x, 1.0 / dj.y, 1.0 / dj.z)
        i, occ, tests, whole, visits = 0, False, 0, 0, 0
        while i < bvh.count and not occ:
            visits += 1
            lo, hi = bvh.bb_min[:, i:i + 1], bvh.bb_max[:, i:i + 1]
            t_near, t_far, hit = slab_box(oj, inv, Vec3(*lo), Vec3(*hi))
            hit = bool(hit & (t_far > EPS5) & (lo[0] <= hi[0]) & (t_limit[j] > t_near))
            first = int(bvh.leaf_first[i])
            if hit and first >= 0:
                cnt = min(int(bvh.leaf_count[i]), max_leaf)
                tab = faces[:, first:first + cnt]
                t, valid = moller_trumbore(oj, dj, Vec3(*tab[0:3]), Vec3(*tab[3:6]),
                                           Vec3(*tab[6:9]))
                below = torch.nonzero(valid & (t < t_limit[j])).flatten()
                occ = below.numel() > 0
                tests += int(below[0]) + 1 if occ else cnt
                whole += cnt
            i = i + 1 if hit else int(bvh.exit[i])
        out.append((occ, tests, whole, visits))
    return [torch.tensor(c) for c in zip(*out)]


@pytest.mark.parametrize("n_faces, leaves", [(700, 2), (3000, 64)])
def test_any_hit_counters_stop_at_the_occluding_face(n_faces, leaves):
    """``occluded_bvh_walk``'s counters on the CPU equal a walk written out
    ray by ray: node steps, and face tests up to and including each ray's
    occluding face; a dead lane counts nothing. With 64-face leaves the
    count is below the hit leaves' faces summed on some rays."""
    _, ps, ts = _scenes(n_faces, leaves)
    ml = bvh_max_leaf(ps)
    p, d, t_light, alive = _shadow_rays(ts, 160, n_faces + 1)
    tp, td = Vec3(*(torch.tensor(c) for c in p)), Vec3(*(torch.tensor(c) for c in d))
    tl, al = torch.tensor(t_light), torch.tensor(alive)
    occ, tests, visits = cb.occluded_bvh_walk(tp, td, tl, ts.bvh, ts.tris, ml, alive=al,
                                              with_counts=True)
    live = torch.nonzero(al).flatten()
    ref_occ, ref_tests, whole, ref_visits = _any_hit_by_hand(
        Vec3(tp.x[live], tp.y[live], tp.z[live]), Vec3(td.x[live], td.y[live], td.z[live]),
        tl[live], ts.bvh, ci.face_table(ts.tris), ml)
    assert torch.equal(occ[live], ref_occ) and int(ref_occ.sum()) > 10
    assert torch.equal(tests[live], ref_tests.to(torch.int32))
    assert torch.equal(visits[live], ref_visits.to(torch.int32))
    assert not tests[~al].any() and not visits[~al].any()
    assert bool((ref_tests <= whole).all())
    if leaves == 64:
        assert int((ref_tests < whole).sum()) > 10


def _uv_by_hand(o, d, t_limit, trees, max_leaf):
    """Each ray's walk over ``trees`` ((tree, faces, face offset) in order,
    the best of one seeding the next), one node step at a time in Python:
    its face tests whose t can change the result. Nearest (``t_limit``
    None): ``1e-5 <= t <=`` the ray's final t over every tree; any-hit:
    ``1e-5 <= t < t_limit`` up to and including the occluding face."""
    out = []
    for j in range(o.x.shape[0]):
        oj, dj = Vec3(o.x[j:j + 1], o.y[j:j + 1], o.z[j:j + 1]), \
            Vec3(d.x[j:j + 1], d.y[j:j + 1], d.z[j:j + 1])
        inv = Vec3(1.0 / dj.x, 1.0 / dj.y, 1.0 / dj.z)
        best, occ, seen = float("inf"), False, []
        for bvh, faces, _ in trees:
            i = 0
            while i < bvh.count and not occ:
                lo, hi = bvh.bb_min[:, i:i + 1], bvh.bb_max[:, i:i + 1]
                t_near, t_far, hit = slab_box(oj, inv, Vec3(*lo), Vec3(*hi))
                gate = best if t_limit is None else float(t_limit[j])
                hit = bool(hit & (t_far > EPS5) & (lo[0] <= hi[0]) & (gate > t_near))
                first = int(bvh.leaf_first[i])
                if hit and first >= 0:
                    cnt = min(int(bvh.leaf_count[i]), max_leaf)
                    tab = faces[:, first:first + cnt]
                    t, valid = moller_trumbore(oj, dj, Vec3(*tab[0:3]), Vec3(*tab[3:6]),
                                               Vec3(*tab[6:9]))
                    for k in range(cnt):
                        tk = float(t[k])
                        if t_limit is None:
                            seen.append(tk)
                            if bool(valid[k]) and tk < best:
                                best = tk
                            continue
                        if EPS5 <= tk < float(t_limit[j]):
                            seen.append(tk)
                        if bool(valid[k]) and tk < float(t_limit[j]):
                            occ = True
                            break
                i = i + 1 if hit else int(bvh.exit[i])
        out.append(sum(1 for tk in seen if EPS5 <= tk and (t_limit is not None or tk <= best)))
    return torch.tensor(out)


@pytest.mark.parametrize("tree", ["2-face leaves", "64-face leaves", "forest"])
@pytest.mark.parametrize("leg", ["nearest", "any-hit"])
def test_uv_counts_equal_a_walk_by_hand(tree, leg):
    """The plain walk's count of the face tests whose t can change the
    result (``_run_plain``'s ``uv``, chip_smoke's walk bounds: t for every
    test, u and v only for these) equals a walk written out ray by ray: on
    the nearest leg ``1e-5 <= t <=`` the ray's final t (over a forest's
    chain, the chain's), on the any-hit leg ``1e-5 <= t < t_limit`` up to
    and including the occluding face; dead lanes count nothing. It is
    below the face tests on some rays."""
    n_faces, leaves = (3000, 64) if tree == "64-face leaves" else (700, 2)
    _, ps, ts = _scenes(n_faces, leaves)
    p, d, t_light, alive = _shadow_rays(ts, 120, n_faces + 7)
    tp, td = Vec3(*(torch.tensor(c) for c in p)), Vec3(*(torch.tensor(c) for c in d))
    tl, al = torch.tensor(t_light), torch.tensor(alive)
    t_limit = tl if leg == "any-hit" else None
    if tree == "forest":
        fo = ts.forest
        w = cb.Walk("K6 seeded" if t_limit is None else "K6 seeded any-hit", tp, td, fo,
                    fo.faces, 4, al, t_limit=t_limit)
        trees = [(fo.tree(i), fo.faces[:, i * fo.chunk:(i + 1) * fo.chunk], 0)
                 for i in range(fo.count)]
    else:
        ml = bvh_max_leaf(ps)
        tab = ci.face_table(ts.tris)
        w = cb.Walk("K8" if t_limit is None else "K8 any-hit", tp, td, ts.bvh, tab, ml, al,
                    t_limit=t_limit)
        trees = [(ts.bvh, tab, 0)]
    work, uv = [], []
    cb._run_plain(w, work, uv)
    assert len(uv) == 1
    live = torch.nonzero(al).flatten()
    ref = _uv_by_hand(Vec3(tp.x[live], tp.y[live], tp.z[live]),
                      Vec3(td.x[live], td.y[live], td.z[live]),
                      None if t_limit is None else tl[live], trees, w.max_leaf)
    assert torch.equal(uv[0][live], ref) and int(ref.sum()) > 0
    assert not uv[0][~al].any()
    tests = sum(t for t, _ in work)
    assert bool((uv[0] <= tests).all()) and int((uv[0] < tests).sum()) > 10


@pytest.mark.parametrize("kernel", ["K8", "K8 any-hit"])
def test_k8_takes_no_tree_without_its_records(kernel):
    """A K8 walk of a tree without its packed records raises, on the CPU as
    on a card, naming the records, where it might have packed them on every
    launch; the tables of to_torch have them."""
    _, ps, ts = _scenes(700, 2)
    o = Vec3(*(torch.zeros(4) for _ in range(3)))
    d = Vec3(torch.ones(4), torch.zeros(4), torch.zeros(4))
    t_limit = torch.ones(4) if kernel == "K8 any-hit" else None
    tab = ci.face_table(ts.tris)
    for bare in (ts.bvh._replace(node_records=None), ts.bvh._replace(face_records=None)):
        with pytest.raises(ValueError, match="packed records"):
            cb.run(cb.Walk(kernel, o, d, bare, tab, 2, t_limit=t_limit))
    cb.run(cb.Walk(kernel, o, d, ts.bvh, tab, 2, t_limit=t_limit))


def test_bvh_frame_through_the_new_shadow_leg_equals_the_old_form(monkeypatch):
    """A 16² frame through 'bvh' with NEE (bench.py's grey soup at 600
    faces, 3 bounces): K8 any-hit on the casting lanes gives the same
    frame, bitwise, as the nearest search on every lane that it replaces;
    the new leg ran once a bounce on fewer lanes."""
    _, ps, _ = _scenes(600, 2)
    ts = to_torch(ps._replace(forest=None), "cpu")
    cam = camera_to_torch(make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0)),
                          "cpu")
    settings = RenderSettings(width=16, height=16, samples=1, max_depth=3, max_added_depth=0,
                              shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
                              intersector="bvh")
    ids = torch.arange(256, dtype=torch.int32)
    calls = []
    real = cb.occluded_bvh_walk

    def spy(o, d, t_limit, bvh, tris, max_leaf, alive):
        calls.append(int(alive.sum()))
        return real(o, d, t_limit, bvh, tris, max_leaf, alive=alive)

    monkeypatch.setattr(cb, "occluded_bvh_walk", spy)
    new = trace_rays(ts, cam, settings, ids, 3, max_leaf=2, with_stats=True)

    def old_form(o, d, t_limit, bvh, tris, max_leaf, alive):
        return tt.intersect_scene(o, d, tris, mode="bvh", bvh=bvh, max_leaf=max_leaf)[0] < t_limit

    monkeypatch.setattr(cb, "occluded_bvh_walk", old_form)
    old = trace_rays(ts, cam, settings, ids, 3, max_leaf=2, with_stats=True)
    for a, b in zip(new.color, old.color):
        assert torch.equal(a, b)
    assert len(calls) == settings.max_total_depth
    assert 0 < sum(calls) == int(new.n_shadow_rays) < 256 * len(calls)
    assert float(new.color.stack().mean()) > 0.01


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel K8 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("alive", [False, True], ids=["all-live", "alive-mask"])
def test_k8_instances_match_walk_plain_on_card(alive):
    """Both K8 instances, with and without counters, against the plain
    version on the card, bitwise: 100,003 rays on soups with 2- and 64-face
    leaves, t_limit 0, +inf and ordinary; with to_torch's records and with
    records packed here by node_records and face_records."""
    dev = _card()
    n = 100_003
    rng = np.random.default_rng(31)
    o = rng.uniform(-1.2, 1.2, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    ov, dv = (Vec3(*(torch.tensor(c, device=dev) for c in a)) for a in (o, d))
    al = torch.tensor(np.arange(n) % 3 != 0, device=dev) if alive else None
    t_lim = rng.uniform(0.0, 1.5, n).astype(np.float32)
    t_lim[::11], t_lim[1::11] = 0.0, np.inf
    t_limit = torch.tensor(t_lim, device=dev)
    for n_faces, leaves in ((700, 2), (3000, 64)):
        _, ps, _ = _scenes(n_faces, leaves)
        ts = to_torch(ps, dev)
        ml = bvh_max_leaf(ps)
        tab = ci.face_table(ts.tris)
        order = cb.ray_order(ov, dv, ts.bvh, al)
        packed = ts.bvh._replace(node_records=cb.node_records(ts.bvh),
                                 face_records=cb.face_records(tab))
        walks = [cb.Walk(k, ov, dv, tree, tab, ml, al, order, with_counts=c,
                         t_limit=t_limit if k == "K8 any-hit" else None)
                 for k in ("K8", "K8 any-hit") for c in (False, True)
                 for tree in (ts.bvh, packed)]
        for w in walks:
            got, ref = cb._run_kernel(w), cb._run_plain(w)
            torch.cuda.synchronize()
            got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                assert torch.equal(a, b), (w.kernel, w.with_counts)
