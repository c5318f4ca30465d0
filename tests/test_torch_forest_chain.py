"""The forest's seeded chain (pbr_tpu_torch/ops/cuda_bvh.py::_forest, kernel
K6's instances "K6 seeded" and "K6 seeded any-hit"), on the CPU:

- the packed records of the forest's sub-trees and faces, built once a
  scene by ``to_torch``, padding nodes included (they pack as inner nodes
  with their inverted boxes, which the empty-box guard makes a miss);
- the chain against the JAX package's ``intersect_bvh_forest`` in
  interpret mode (as tests/test_forest.py runs it), on a soup with a face
  duplicated into a later sub-tree, so that the lower forest slot must win
  the tie: faces equal, t within 1e-6 (the tolerance of
  tests/test_pallas_bvh.py), occlusion on at least 99.9% of rays (the
  shadow ray's length goes through torch's CPU sqrt);
- one launch a pass for sub-trees 1..K-1, shown with a recording
  ``execute``, and its answer against the plain walks chained one
  sub-tree at a time, bitwise;
- the checks on a chain's walk.

The kernel itself runs only on a card (tests/test_torch_bvh.py's
``cuda``-marked test holds it bitwise to the plain chain there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.accel.forest import build_forest as jax_build_forest
from pbr_tpu.ops import pallas_bvh as jax_pallas_bvh
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.procedural import random_soup
from pbr_tpu_torch.accel.forest import build_forest
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.device import ForestTables, to_torch

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

LIGHT = (0.3, 2.4, 0.1)
CHUNK = 256
N_RAYS = 1000
DUP = (5, 600)  # main-order faces: DUP[1] becomes a copy of DUP[0]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _t(a):
    return Vec3(*(torch.tensor(c) for c in a))


def _light():
    return torch.tensor(LIGHT, dtype=torch.float32)


def _with_duplicate(tris):
    """``tris`` with face DUP[1] replaced by a copy of face DUP[0]."""
    i, j = DUP

    def copy(a):
        a = np.array(a)
        a[j] = a[i]
        return a

    fields = {}
    for name, v in tris._asdict().items():
        fields[name] = copy(v) if name == "mtl" else type(v)(*(copy(c) for c in v))
    return type(tris)(**fields)


@functools.lru_cache(maxsize=None)
def _scenes(n=700, seed=0, dup=False):
    """The same soup from both host layers, with a forest of CHUNK-face
    sub-trees (with ``dup``, built over the triangles with the duplicate):
    (the JAX scene as jnp arrays, the port's SceneParams on the CPU)."""
    js, _ = jax_scene_from_text(random_soup(n, seed=seed), use_bvh=True)
    ps, _ = scene_from_text(random_soup(n, seed=seed), use_bvh=True)
    if dup:
        js = js._replace(tris=_with_duplicate(js.tris))
        ps = ps._replace(tris=_with_duplicate(ps.tris))
    js = js._replace(forest=jax_build_forest(js.tris, chunk=CHUNK))
    ps = ps._replace(forest=build_forest(ps.tris, chunk=CHUNK))
    return jax.tree_util.tree_map(jnp.asarray, js), to_torch(ps, "cpu")


def _aimed_rays(ts, n, seed):
    """``n`` rays that meet face DUP[0] (and its copy) head on, from 0.01
    in front of a random point of it."""
    i = DUP[0]
    rng = np.random.default_rng(seed)
    tris = ts.tris
    v0, e1, e2 = (np.array([float(c[i]) for c in v]) for v in (tris.v0, tris.e1, tris.e2))
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm)
    uv = rng.uniform(0.1, 0.4, (n, 2))
    p = v0 + uv[:, :1] * e1 + uv[:, 1:] * e2
    o = (p + 0.01 * nrm).T.astype(np.float32)
    d = np.repeat(-nrm[:, None], n, axis=1).astype(np.float32)
    return o, d


def _chained_by_hand(forest, o, d, alive, t_limit=None):
    """The plain walks over the sub-trees one at a time, each seeded by the
    ones before."""
    c = forest.chunk
    t = f = occ = None
    for i in range(forest.count):
        t, f, occ, _, _ = cb.walk_plain(o, d, forest.tree(i), forest.faces[:, i * c:(i + 1) * c],
                                        4, alive, i * c, t_seed=t, f_seed=f, t_limit=t_limit,
                                        occ_seed=occ)
    return t, f, occ


def test_forest_records_pack_padding_nodes():
    """Per sub-tree, node_records of its tables (padding rows: the inverted
    box, exit = N, the inner-node word -1, which the empty-box guard turns
    into a miss); face_records of the forest's faces."""
    _, ts = _scenes()
    fo = ts.forest
    k, n = fo.count, fo.trees.count
    assert fo.node_records.shape == (k, n, 8) and fo.face_records.shape == (k * CHUNK, 12)
    assert torch.equal(fo.face_records, cb.face_records(fo.faces))
    bits = lambda a: a.view(torch.int32)  # noqa: E731  (int words stored as float bits)
    pads = 0
    for i in range(k):
        tree, rec = fo.tree(i), fo.node_records[i]
        assert torch.equal(bits(rec), bits(cb.node_records(tree)))
        assert torch.equal(rec[:, :3], tree.bb_min.T) and torch.equal(rec[:, 4:7], tree.bb_max.T)
        assert torch.equal(rec[:, 3].view(torch.int32), tree.exit)
        word = rec[:, 7].view(torch.int32)
        leaf = tree.leaf_first >= 0
        assert torch.equal(word[~leaf], torch.full_like(word[~leaf], -1))
        assert torch.equal(word[leaf] >> cb.LEAF_COUNT_BITS, tree.leaf_first[leaf])
        pad = tree.bb_min[0] > tree.bb_max[0]
        pads += int(pad.sum())
        assert torch.all(rec[pad, :3] == float("inf")) and torch.all(rec[pad, 4:7] == -float("inf"))
        assert torch.all(word[pad] == -1) and torch.all(rec[pad, 3].view(torch.int32) == n)
        assert not torch.any(rec[pad, 0] <= rec[pad, 4])  # the guard: a miss
    assert pads > 0  # the partial last sub-tree is padded


@pytest.mark.parametrize("nee", [False, True], ids=["nearest", "nee"])
def test_chain_matches_jax_forest_with_a_duplicated_face(nee):
    """A face and its copy in sub-trees 0 and 2: rays that meet them head
    on get the lower forest slot's face, DUP[0], as in the JAX package;
    every face equal, t within 1e-6 on 1,024 rays, occlusion on >= 99.9%."""
    jsj, ts = _scenes(dup=True)
    fo = ts.forest
    slots = [int(s) for s in torch.nonzero(torch.isin(fo.face_ids[:700],
                                                      torch.tensor(DUP))).flatten()]
    assert sorted(s // CHUNK for s in slots) == [0, 2]
    o, d = _rays(N_RAYS, 41)
    ao, ad = _aimed_rays(ts, 24, 42)
    o, d = np.concatenate([o, ao], 1), np.concatenate([d, ad], 1)
    ref = jax_pallas_bvh.intersect_bvh_forest(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), jsj.forest, jsj.bvh,
        interpret=True, **(dict(light_pos=JVec3(*(jnp.float32(v) for v in LIGHT))) if nee
                          else {}))
    got = cb.intersect_bvh_forest(_t(o), _t(d), fo, ts.bvh,
                                  **(dict(light_pos=Vec3(*_light())) if nee else {}))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.all(got[1].numpy()[N_RAYS:] == DUP[0])
    ref_t = np.asarray(ref[0])
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()), np.isfinite(ref_t))
    fin = np.isfinite(ref_t)
    np.testing.assert_allclose(got[0].numpy()[fin], ref_t[fin], rtol=1e-6, atol=1e-6)
    if nee:
        assert (got[2].numpy() == np.asarray(ref[2])).mean() >= 0.999


@pytest.mark.parametrize("alive", [False, True], ids=["all-live", "alive-mask"])
def test_forest_launches_once_a_pass(alive):
    """Sub-tree 0 by "K6 nearest" / "K6 any-hit", sub-trees 1..K-1 by one
    walk a pass ("K6 seeded", "K6 seeded any-hit"); each walk through
    ``run``'s checks; the answer the plain walks' chained by hand,
    bitwise."""
    _, ts = _scenes()
    fo = ts.forest
    o, d = (_t(a) for a in _rays(N_RAYS, 43))
    al = torch.tensor(np.arange(N_RAYS) % 4 != 0) if alive else None
    walks = []

    def execute(w):
        walks.append(w)
        return cb.run(w)

    got = cb._forest(execute, o, d, fo, None, 4, _light(), al)
    assert [w.kernel for w in walks] == ["K6 nearest", "K6 seeded", "K6 any-hit",
                                         "K6 seeded any-hit"]
    for w in (walks[1], walks[3]):
        assert isinstance(w.tree, ForestTables) and w.tree.count == fo.count - 1
        assert w.face_base == CHUNK and w.tree.node_records.shape[0] == fo.count - 1
    t, f, _ = _chained_by_hand(fo, o, d, al)
    face = torch.where(f >= 0, fo.face_ids[f.clamp_min(0).long()], -1)
    assert torch.equal(got[0], t) and torch.equal(got[1], face)
    hit_p, s_dir, t_light = ci._shadow_ray(o, d, t, _light())
    occ = _chained_by_hand(fo, hit_p, s_dir, al, t_light)[2]
    assert torch.equal(got[2], occ) and 0 < int(occ.sum()) < N_RAYS


def test_single_subtree_forest_has_no_chain():
    """A forest of one sub-tree walks it alone: one launch a pass, no
    seeded instance."""
    _, ts = _scenes(200, 3)
    assert ts.forest.count == 1
    o, d = (_t(a) for a in _rays(300, 44))
    walks = []
    got = cb._forest(lambda w: walks.append(w) or cb.run(w), o, d, ts.forest, None, 4,
                     _light(), None)
    assert [w.kernel for w in walks] == ["K6 nearest", "K6 any-hit"]
    t, f, _ = _chained_by_hand(ts.forest, o, d, None)
    assert torch.equal(got[0], t)


def test_chain_walk_is_checked():
    """Only the seeded instances take a forest's sub-trees; they need their
    seeds, the forest's own faces and the packed records."""
    _, ts = _scenes()
    fo = ts.forest
    rest = fo.subtrees(1, fo.count)
    o, d = (_t(a) for a in _rays(64, 45))
    t, f, _ = _chained_by_hand(fo.subtrees(0, 1), o, d, None)
    ok = cb.Walk("K6 seeded", o, d, rest, rest.faces, 4, face_base=CHUNK, t_seed=t, f_seed=f)
    assert torch.equal(cb.run(ok)[1], _chained_by_hand(fo, o, d, None)[1])
    with pytest.raises(ValueError, match="walks one tree"):
        cb.run(ok._replace(kernel="K6 nearest"))
    with pytest.raises(ValueError, match="seeds"):
        cb.run(ok._replace(t_seed=None))
    with pytest.raises(ValueError, match="own faces"):
        cb.run(ok._replace(faces=fo.faces[:, :rest.faces.shape[1]]))
    with pytest.raises(ValueError, match="packed records"):
        cb.run(ok._replace(tree=rest._replace(node_records=None)))
