"""Kernel K3's module (pbr_tpu_torch/ops/cuda_gated.py): the gated sweep
against the JAX package's ``pbr_tpu.ops.pallas_gated.intersect_gated``,
run as tests/test_gated.py runs it on the CPU (interpret mode, the
``fori`` body: ``static_unroll=False``).

The cases cover dead lanes, a tile whose lanes are all dead (so in the
shadow pass all seeded 1, an all-occluded tile) and shadow passes whose
lanes are mostly seeded 1: what the kernel's early exits skip.

Tolerances: faces, occluded and the executed test counts must be equal; t
within rtol 1e-4 / atol 1e-5 (those of tests/test_gated.py), since XLA on
the CPU may round the linear form's dot products differently from torch.
Against the port's own full linear-form sweep (kernel K2's plain version),
which runs the same per-face arithmetic, t must be bitwise equal: the
verdicts are conservative, so gating changes nothing but the work.

The JAX reference compiles once per (clusters, rows, tiles, pass), which
costs ~10-25 s each here; the cases share shapes so that four compiles
cover them. The kernel itself runs only on a card:
``test_kernel_matches_plain_on_card`` is marked ``cuda`` and skips here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops.pallas_gated import intersect_gated as jax_gated
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text
from pbr_tpu.scene.procedural import multi_room, random_soup
from pbr_tpu_torch.accel.clusters import build_clusters
from pbr_tpu_torch.ops import cuda_gated as cg
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.cull import fine_hit_mask
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine (measured: a
# 3 s test took 180 s with four workers).
torch.set_num_threads(1)

# name: (scene, rays, rows, alive, light); alive: None (all live), or a
# pattern of ``_alive``. Soups of 257-1024 faces all pad to 16 clusters,
# and 255 and 256 rays are both two 128-ray tiles, so the rows=1 soup cases
# share the JAX reference's compiled programs, as the multiroom cases do.
CASES = {
    "soup400-nearest": ("soup:400:7", 256, 1, None, None),
    "soup700-odd-alive-nee": ("soup:700:2", 255, 1, "thirds", (0.1, 0.6, -0.2)),
    "soup500-rows2-alive": ("soup:500:4", 256, 2, "thirds", None),
    "multiroom-alive-nee": ("multiroom", 256, 1, "thirds", (0.0, 1.75, 0.0)),
    "multiroom-dead-tile-nee": ("multiroom", 256, 1, "dead-tile", (0.0, 1.75, 0.0)),
    "multiroom-sparse-nee": ("multiroom", 256, 1, "sparse", (0.0, 1.75, 0.0)),
}


def _alive(kind, n):
    """The live lanes: ``thirds``, two lanes of three; ``dead-tile``, none
    in the first 128-ray tile and one in four after it; ``sparse``, one in
    eight."""
    lane = np.arange(n)
    if kind == "dead-tile":
        return (lane % 4 == 1) & (lane >= 128)
    if kind == "sparse":
        return lane % 8 == 3
    return lane % 3 != 0


@functools.lru_cache(maxsize=None)
def _scene(spec):
    if spec == "multiroom":
        scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    else:
        _, n, seed = spec.split(":")
        scene, _ = scene_from_text(random_soup(int(n), seed=int(seed)), use_bvh=True)
    assert scene.clusters is not None and scene.clusters.size == 64
    return scene


def _rays(spec, n, seed):
    """Origins inside the scene and directions over the whole sphere, so
    that most rays hit, a few of them straight along an axis."""
    rs = np.random.RandomState(seed)
    if spec == "multiroom":
        o = np.stack([rs.uniform(-2.8, 2.8, n), rs.uniform(0.1, 1.9, n),
                      rs.uniform(-4.8, 0.8, n)])
    else:
        o = rs.uniform(-1.0, 1.0, size=(3, n))
    d = rs.normal(size=(3, n))
    d[:2, : n // 16] = 0.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t3(a, device="cpu"):
    return Vec3(*(torch.tensor(c, device=device) for c in a))


def _light(lp, device="cpu"):
    return Vec3(*(torch.tensor(v, dtype=torch.float32, device=device) for v in lp))


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    spec, n, rows, kind, lp = CASES[name]
    scene = _scene(spec)
    o, d = _rays(spec, n, seed=n + rows)
    tree = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    out = jax_gated(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)),
        tree(scene.tris), tree(scene.clusters),
        light_pos=None if lp is None else JVec3(*(jnp.float32(v) for v in lp)),
        alive=None if kind is None else jnp.asarray(_alive(kind, n)), rows=rows,
        interpret=True, with_counts=True, static_unroll=False,
    )
    return tuple(np.asarray(a) for a in out)


def _port_result(name):
    spec, n, rows, kind, lp = CASES[name]
    scene = _scene(spec)
    o, d = _rays(spec, n, seed=n + rows)
    alive = np.ones(n, bool) if kind is None else _alive(kind, n)
    ts = to_torch(scene, "cpu")
    out = cg.intersect_gated(_t3(o), _t3(d), ts.tris, ts.clusters,
                             light_pos=None if lp is None else _light(lp),
                             alive=None if kind is None else torch.tensor(alive),
                             rows=rows, with_counts=True)
    return out, (o, d, alive), ts


@pytest.fixture(autouse=True)
def _no_cuda_launch_counted():
    before = dict(cg.launches)
    yield
    assert cg.launches == before  # CPU tensors never launch the kernel


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_package(name):
    ref = _jax_result(name)
    got, (_, _, alive), _ = _port_result(name)
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[1], ref[1])  # faces
    hit = ref[1] >= 0
    assert hit.sum() > 0.1 * alive.sum()  # the case has substance
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[0][~hit], ref[0][~hit])  # +inf, or -3e38 dead
    assert np.all(got[1][~alive] == -1) and np.all(got[0][~alive] == np.float32(-3e38))
    np.testing.assert_array_equal(got[-1], ref[-1])  # exact executed tests
    if CASES[name][4] is not None:
        np.testing.assert_array_equal(got[2], ref[2])  # occluded
        assert 0 < got[2][hit].mean() < 1


@pytest.mark.parametrize("name", list(CASES))
def test_faces_and_t_equal_the_full_lin_sweep(name):
    """On live lanes the gated sweep gives the full linear-form sweep's
    (kernel K2's plain version's) faces and t, bitwise; with NEE, its
    occlusion on the lanes that hit."""
    (t, face, *rest), (o, d, alive), ts = _port_result(name)
    lp = CASES[name][4]
    table = ci.lin_table(ts.tris)
    light = None if lp is None else torch.tensor(lp, dtype=torch.float32)
    full = ci.intersect_fused_plain(_t3(o), _t3(d), table, light)
    a = torch.tensor(alive)
    assert torch.equal(face[a], full[1][a]) and torch.equal(t[a], full[0][a])
    if lp is not None:
        hit = a & (face >= 0)
        assert torch.equal(rest[0][hit], full[2][hit])
        assert torch.all(rest[0][~hit])  # missed and dead lanes seed 1


@pytest.mark.parametrize("name", list(CASES))
def test_counts_are_the_verdicts_real_faces(name):
    """n_tests = per tile, the gated-in clusters' real faces, summed over
    both passes; the nearest pass alone is at most the full sweep's F."""
    spec, n, rows, use_alive, lp = CASES[name]
    (t, face, *rest), (o, d, alive), ts = _port_result(name)
    nf, tile = ts.tris.mtl.shape[0], rows * 128
    pad = (-n) % tile
    live = torch.tensor(np.concatenate([alive, np.zeros(pad, bool)]))
    edge = lambda a: torch.tensor(np.concatenate([a, np.repeat(a[:, -1:], pad, 1)], 1))  # noqa: E731
    op, dp = Vec3(*edge(o)), Vec3(*edge(d))
    verdict = fine_hit_mask(op, dp, ts.clusters, tile, live=live)
    real = cg.real_faces(nf, ts.clusters.count, "cpu")
    nearest = ((verdict.to(torch.int32) * real).sum(1)).repeat_interleave(tile)[:n]
    assert torch.all(nearest <= nf)
    if lp is None:
        assert torch.equal(rest[-1], nearest)
    else:
        assert torch.all(rest[-1] >= nearest)


def test_cull_changes_only_the_work():
    """Verdicts from one tile of all rays, or from tiles of only live rays,
    give the same answers: the gate is conservative."""
    name = "multiroom-alive-nee"
    (t, face, occ, _), (o, d, alive), ts = _port_result(name)
    a = torch.tensor(alive)
    dense = [torch.tensor(c[alive]) for c in (*o, *d)]
    t2, f2, occ2 = cg.intersect_gated(Vec3(*dense[:3]), Vec3(*dense[3:]), ts.tris,
                                      ts.clusters, light_pos=_light(CASES[name][4]), rows=8)
    assert torch.equal(f2, face[a]) and torch.equal(t2, t[a]) and torch.equal(occ2, occ[a])


def test_gated_table_pads_with_faces_that_never_hit():
    scene = _scene("soup:400:7")
    ts = to_torch(scene, "cpu")
    tab = cg.gated_table(ts.tris, ts.clusters.count)
    assert tab.shape == (16, ts.clusters.count * 64)
    assert torch.equal(tab[:, :400], ci.lin_table(ts.tris))
    assert not tab[:, 400:].any()
    o, d = _rays("soup:400:7", 64, seed=0)
    ob, db = (Vec3(*(c[:, None] for c in _t3(a))) for a in (o, d))
    _, valid = ci.mt_lin(ob, db, ci.cross_od(ob, db), tab[:, 400:])
    assert not valid.any()
    np.testing.assert_array_equal(cg.real_faces(400, 16, "cpu").numpy()[:8],
                                  [64, 64, 64, 64, 64, 64, 16, 0])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ts = to_torch(_scene("soup:400:7"), "cpu")
    o, d = _rays("soup:400:7", 128, seed=1)
    with pytest.raises(ValueError, match="rows"):
        cg.intersect_gated(_t3(o), _t3(d), ts.tris, ts.clusters, rows=9)
    with pytest.raises(ValueError, match="64-face"):
        cg.intersect_gated(_t3(o), _t3(d), ts.tris, ts.clusters._replace(size=128))
    with pytest.raises(ValueError, match="alive"):
        cg.intersect_gated(_t3(o), _t3(d), ts.tris, ts.clusters, alive=torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32"):
        cg.intersect_gated(_t3(o.astype(np.float64)), _t3(d), ts.tris, ts.clusters)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K3 against its plain version on the card: t, face, occluded and the
    test counts bitwise equal (--fmad=false), at tiles of 128 to 1,024 rays
    (each split over several blocks), with a ragged batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel K3 has no CPU mode")
    scene = _scene("multiroom")
    ts = to_torch(scene, "cuda")
    o, d = _rays("multiroom", 100_003, seed=3)
    alive = _alive("thirds", 100_003)
    lp = _light((0.0, 1.75, 0.0), "cuda")
    for rows in (1, 3, 8):
        before = dict(cg.launches)
        args = (_t3(o, "cuda"), _t3(d, "cuda"), ts.tris, ts.clusters)
        kw = dict(light_pos=lp, alive=torch.tensor(alive, device="cuda"), rows=rows,
                  with_counts=True)
        got = cg.intersect_gated(*args, **kw)
        ref = cg.intersect_gated_plain(*args, **kw)
        torch.cuda.synchronize()
        assert cg.launches["nearest"] == before["nearest"] + 1
        assert cg.launches["any-hit"] == before["any-hit"] + 1
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        cg.launches.update(before)  # the autouse check counts CPU launches only


def test_gated_table_is_built_once_face_major():
    """to_torch builds K3's table once a scene: the (C * 64, 16) face-major
    copy of ``gated_table``, bitwise, contiguous; none for 128-face
    clusters (the gated sweep takes only 64-face ones)."""
    for spec in ("multiroom", "soup:400:7"):
        ts = to_torch(_scene(spec), "cpu")
        fm = ts.clusters.gated
        assert fm.is_contiguous() and fm.shape == (ts.clusters.count * 64, 16)
        assert torch.equal(fm, cg.gated_table(ts.tris, ts.clusters.count).t())
        assert torch.equal(fm.t(), cg.gated_table(ts.tris, ts.clusters.count))
    scene = _scene("soup:400:7")
    wide = to_torch(scene._replace(clusters=build_clusters(scene.tris, size=128)), "cpu")
    assert wide.clusters.size == 128 and wide.clusters.gated is None
    assert "clu_gated_fm" not in dict(wide.named_buffers())


def test_wrapper_needs_the_face_major_table():
    """The wrapper reads the scene's table and rebuilds none: without it,
    or with one of another shape, it raises."""
    ts = to_torch(_scene("soup:400:7"), "cpu")
    o, d = _rays("soup:400:7", 128, seed=2)
    with pytest.raises(ValueError, match="face-major"):
        cg.intersect_gated(_t3(o), _t3(d), ts.tris, ts.clusters._replace(gated=None))
    with pytest.raises(ValueError, match="gated table"):
        cg.intersect_gated(_t3(o), _t3(d), ts.tris,
                           ts.clusters._replace(gated=ts.clusters.gated[:64]))
    passes = []
    cg._gated(lambda *a: passes.append(a) or cg._sweep_plain(*a), _t3(o), _t3(d), ts.tris,
              ts.clusters, _light((0.1, 0.6, -0.2)), None, 1, False)
    assert len(passes) == 2
    for args in passes:  # both passes read a view of the scene's own table
        assert args[2].t().data_ptr() == ts.clusters.gated.data_ptr()
