"""The tree walks' host side against the JAX package: the port's BVH forest
builder (``pbr_tpu_torch/accel/forest.py``), the forest branch of its
``build_scene``, and the tables ``to_torch`` puts on the device
(``SceneParams.bvh``, ``SceneParams.forest``). Byte-for-byte equality, as
tests/test_torch_host.py holds the rest of the host layer.
"""

import numpy as np
import pytest
import torch

import pbr_tpu.accel.clusters as jax_clusters
import pbr_tpu.ops.pallas_bvh as jax_pallas_bvh
from pbr_tpu.accel.forest import build_forest as jax_build_forest
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.procedural import cornell_box, random_soup
import pbr_tpu_torch.accel.clusters as port_clusters
import pbr_tpu_torch.ops.cuda_bvh as port_cuda_bvh
from pbr_tpu_torch.accel.forest import FOREST_CHUNK, FOREST_MAX_LEAF, build_forest
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.device import to_torch

torch.set_num_threads(1)


def _assert_tree_equal(a, b):
    """Two NamedTuples of NumPy arrays (or Vec3s of them), byte for byte."""
    assert type(a).__name__ == type(b).__name__
    for fa, fb in zip(a, b):
        if isinstance(fa, tuple):
            _assert_tree_equal(fa, fb)
        else:
            fa, fb = np.asarray(fa), np.asarray(fb)
            assert fa.dtype == fb.dtype and fa.shape == fb.shape
            assert fa.tobytes() == fb.tobytes()


def test_build_forest_equals_the_jax_package():
    """700 faces in chunks of 256: 3 sub-trees, the last one partial, node
    tables padded to one count with inverted boxes, forest-order geometry
    and face ids, all byte-equal to ``pbr_tpu.accel.forest.build_forest``."""
    txt = random_soup(700, seed=0)
    js, _ = jax_scene_from_text(txt, use_bvh=True)
    ps, _ = scene_from_text(txt, use_bvh=True)
    jf = jax_build_forest(js.tris, chunk=256)
    pf = build_forest(ps.tris, chunk=256)
    assert len(pf.bvhs) == 3 and pf.chunk_size == 256
    assert {b.count for b in pf.bvhs} == {pf.bvhs[0].count}
    _assert_tree_equal(pf, jf)
    # Padding nodes: inverted boxes whose exit ends the walk.
    last = pf.bvhs[2]
    pad = np.asarray(last.bb_min.x) > np.asarray(last.bb_max.x)
    assert pad.any() and np.all(np.asarray(last.exit)[pad] == last.count)
    assert FOREST_CHUNK == 8192 and FOREST_MAX_LEAF == 4


@pytest.mark.parametrize("case", ["cornell-bvh", "cornell-brute", "soup-200", "soup-700",
                                  "soup-700-no-clusters"])
def test_build_scene_attaches_a_forest_when_the_jax_package_does(case, monkeypatch):
    """A forest is built for a scene with a BVH, no clusters and a tree the
    packet walk cannot hold. No default build reaches that (clusters come
    with every BVH scene above 256 faces), so the last case switches the
    cluster builder off and the packet budget down in both packages: both
    attach the same forest."""
    if case.startswith("cornell"):
        args, use_bvh = cornell_box(), case == "cornell-bvh"
    else:
        args, use_bvh = (random_soup(int(case.split("-")[1]), seed=2),), True
    if case.endswith("no-clusters"):
        monkeypatch.setattr(jax_clusters, "build_clusters", lambda *a, **k: None)
        monkeypatch.setattr(port_clusters, "build_clusters", lambda *a, **k: None)
        monkeypatch.setattr(jax_pallas_bvh, "packet_fits", lambda *a: False)
        monkeypatch.setattr(port_cuda_bvh, "packet_fits", lambda *a: False)
    js, _ = jax_scene_from_text(*args, use_bvh=use_bvh)
    ps, _ = scene_from_text(*args, use_bvh=use_bvh)
    assert (ps.forest is None) == (js.forest is None)
    assert (ps.forest is not None) == case.endswith("no-clusters")
    if ps.forest is not None:
        _assert_tree_equal(ps.forest, js.forest)


def test_device_tables_carry_the_bvh_and_the_forest():
    """``SceneParams.bvh``: (3, N) float32 bounds and (N,) int32 indices equal
    to the scene's LinearBVH; ``SceneParams.forest``: each sub-tree's
    tables, the (9, K * chunk) forest-order face table and the face ids; a
    scene without them has None."""
    ps, _ = scene_from_text(random_soup(700, seed=0), use_bvh=True)
    ps = ps._replace(forest=build_forest(ps.tris, chunk=256))
    ts = to_torch(ps, "cpu")
    b = ps.bvh
    assert ts.bvh.count == b.count
    np.testing.assert_array_equal(ts.bvh.bb_min.numpy(), np.stack(list(b.bb_min)))
    np.testing.assert_array_equal(ts.bvh.bb_max.numpy(), np.stack(list(b.bb_max)))
    for name in ("leaf_first", "leaf_count", "exit"):
        got = getattr(ts.bvh, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), getattr(b, name))
    lo, hi = ts.bvh.root
    assert float(lo.x) == b.bb_min.x[0] and float(hi.z) == b.bb_max.z[0]
    fo = ts.forest
    assert fo.count == 3 and fo.chunk == 256 and fo.faces.shape == (9, 768)
    for i, sub in enumerate(ps.forest.bvhs):
        tree = fo.tree(i)
        np.testing.assert_array_equal(tree.bb_min.numpy(), np.stack(list(sub.bb_min)))
        np.testing.assert_array_equal(tree.exit.numpy(), sub.exit)
    rows = [*ps.forest.v0, *ps.forest.e1, *ps.forest.e2]
    np.testing.assert_array_equal(fo.faces.numpy(), np.stack(rows))
    np.testing.assert_array_equal(fo.face_ids.numpy(), ps.forest.face_ids)
    brute, _ = scene_from_text(*cornell_box(), use_bvh=False)
    tb = to_torch(brute, "cpu")
    assert tb.bvh is None and tb.forest is None
