"""Kernels K4 and K4m's module (pbr_tpu_torch/ops/cuda_cull.py): the
cull-and-sweep against the JAX package's
``pbr_tpu.ops.pallas_cull.intersect_cull``, run as tests/test_cull.py runs
it on the CPU (interpret mode), and against the brute-force sweep; then the
big-band slice as a whole (a frame through ``intersector='cull'``).

Tolerances: faces must be equal; t within rtol 1e-4 / atol 1e-5 on hit
lanes (those of tests/test_cull.py), since the cull-and-sweep computes t in
the linear form and XLA on the CPU sums its dot products in another order.
Occlusion may differ on at most 1% of the hit lanes: where t differs by an
ULP the shadow ray starts elsewhere, and the shadow ray's own face test
rounds in another order too, so it may turn at the t >= 1e-5 self-hit gate
(seen: 1 lane of 204 with t 4.223982 against 4.223983, and 1 of 129 with t
bitwise equal). Frames: the repo's frame gate, at least 99% of pixels
within 1e-3 (tests/test_render_golden.py), since a ULP difference can turn
a path; on the port alone, compaction on and off is bitwise equal.

The JAX reference compiles once per (clusters, tiles, slots, pass), ~2-10 s
each here. The kernels themselves run only on a card: the ``cuda``-marked
tests skip here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.accel.clusters import build_clusters
from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops.pallas_cull import intersect_cull as jax_cull
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import bvh_max_leaf, scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.scene.procedural import random_soup
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu_torch import PathTracer, camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import cuda_cull as cc
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import traverse
from pbr_tpu_torch.ops.cull import candidates, coherence_keys
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.procedural import grey_soup
from pbr_tpu_torch.utils.config import RenderSettings

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

LIGHT = (0.0, 2.4, 0.0)  # bench.py's soup orb

# name: (soup faces, seed, cluster size, rays, JAX slots, alive, light,
# share of camera rays). 2,000 faces are 32 clusters (K4m); 4,000 are 64
# (K4, one round, no sort); 6,400 are 112 and 12,000 are 192 (K4 with the
# coherence sort and the early-out); at 128 faces a cluster 6,400 faces are
# 64 clusters. slots=8 makes the JAX reference sweep 14 rounds. A tile
# early-outs only once every live ray has hit, so the early-out case traces
# camera rays only, at a soup dense enough that every one of them hits.
CASES = {
    "masked-alive-nee": (2000, 3, 64, 512, 128, True, LIGHT, 0.5),
    "slotted-one-round": (4000, 5, 64, 512, 128, False, None, 0.5),
    "sorted-early-out-alive-nee": (12000, 11, 64, 1024, 128, True, LIGHT, 1.0),
    "rounds-slots8-odd": (6400, 11, 64, 333, 8, False, None, 0.5),
    "size128-nee": (6400, 2, 128, 512, 128, False, (0.3, 2.4, 0.1), 0.5),
}


@functools.lru_cache(maxsize=None)
def _scene(n, seed, size):
    scene, _ = scene_from_text(random_soup(n, seed=seed), use_bvh=True)
    if scene.clusters.size != size:
        scene = scene._replace(clusters=build_clusters(scene.tris, size=size))
    return scene


def _rays(n, seed, cam_share=0.5):
    """Camera-like rays (a narrow cone from bench.py's eye towards the soup,
    coherent), ``cam_share`` of them, then bounce-like ones (origins inside
    the soup, directions over the sphere, a few straight along z); every
    third lane dead."""
    rs = np.random.RandomState(seed)
    k = int(n * cam_share)
    o_cam = np.stack([rs.uniform(-0.05, 0.05, k), rs.uniform(-0.05, 0.05, k),
                      np.full(k, 3.5)])
    d_cam = np.stack([rs.uniform(-0.2, 0.2, k), rs.uniform(-0.2, 0.2, k), -np.ones(k)])
    o_b = rs.uniform(-1.0, 1.0, size=(3, n - k))
    d_b = rs.normal(size=(3, n - k))
    d_b[:2, : (n - k) // 16] = 0.0  # (n - k may be 0)
    o, d = np.concatenate([o_cam, o_b], 1), np.concatenate([d_cam, d_b], 1)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    alive = np.arange(n) % 3 != 0
    return o.astype(np.float32), d.astype(np.float32), alive


def _t3(a, device="cpu"):
    return Vec3(*(torch.tensor(c, device=device) for c in a))


def _light(lp, device="cpu"):
    return Vec3(*(torch.tensor(v, dtype=torch.float32, device=device) for v in lp))


def _inputs(name, device="cpu"):
    n_faces, seed, size, n, _, use_alive, lp, cam = CASES[name]
    scene = _scene(n_faces, seed, size)
    o, d, alive = _rays(n, n + seed, cam)
    ts = to_torch(scene, device)
    kw = dict(light_pos=None if lp is None else _light(lp, device),
              alive=torch.tensor(alive, device=device) if use_alive else None)
    live = alive if use_alive else np.ones(n, bool)
    return (_t3(o, device), _t3(d, device), ts.clusters), kw, (o, d, live), ts


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    n_faces, seed, size, n, slots, use_alive, lp, cam = CASES[name]
    scene = _scene(n_faces, seed, size)
    o, d, alive = _rays(n, n + seed, cam)
    jset = jax.tree_util.tree_map(jnp.asarray, scene.clusters)
    out = jax_cull(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), jset,
        light_pos=None if lp is None else JVec3(*(jnp.float32(v) for v in lp)),
        alive=jnp.asarray(alive) if use_alive else None, slots=slots, interpret=True,
    )
    return tuple(np.asarray(a) for a in out)


@functools.lru_cache(maxsize=None)
def _port_result(name):
    args, kw, _, _ = _inputs(name)
    return tuple(a.numpy() for a in cc.intersect_cull(*args, **kw))


@pytest.fixture(autouse=True)
def _no_cuda_launch_counted():
    before = dict(cc.launches)
    yield
    assert cc.launches == before  # CPU tensors never launch a kernel


def test_cases_reach_each_kernel_path():
    """The cases cover K4m, K4 in one round without the sort, K4 with the
    sort and the early-out, and both cluster sizes."""
    counts = {name: _inputs(name)[0][2].count for name in CASES}
    sizes = {name: _inputs(name)[0][2].size for name in CASES}
    assert counts["masked-alive-nee"] <= cc.MASKED_MAX_CLUSTERS
    assert cc.MASKED_MAX_CLUSTERS < counts["slotted-one-round"] <= cc.SORT_MIN_CLUSTERS
    assert counts["sorted-early-out-alive-nee"] > cc.SORT_MIN_CLUSTERS
    assert counts["rounds-slots8-odd"] > CASES["rounds-slots8-odd"][4]
    assert sizes["size128-nee"] == 128 and counts["size128-nee"] > cc.MASKED_MAX_CLUSTERS


def _assert_occlusion(got, ref, hit):
    """Occlusion on the hit lanes, at most 1% of them differing."""
    assert (got[2][hit] != ref[2][hit]).mean() <= 0.01
    assert 0 < got[2][hit].mean() < 1


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_package(name):
    ref = _jax_result(name)
    got = _port_result(name)
    live = _inputs(name)[2][2]
    np.testing.assert_array_equal(got[1], ref[1])  # faces
    hit = ref[1] >= 0
    assert hit.sum() > 0.3 * live.sum()  # the case has substance
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[0][~hit], ref[0][~hit])  # +inf, or -3e38 dead
    assert np.all(got[1][~live] == -1) and np.all(got[0][~live] == np.float32(-3e38))
    if CASES[name][6] is not None:
        _assert_occlusion(got, ref, hit)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_brute_force(name):
    """On live lanes, the faces of the classic all-faces sweep (kernel K1's
    plain version) and t within the tolerance. With a light, the any-hit
    pass against the classic sweep's any-hit on the same shadow rays (from
    the cull-and-sweep's own t, with the wrapper's guarded math): the two
    forms of the face test round differently at the t >= 1e-5 and u, v >= 0
    gates, so at most 1% of the hit lanes may differ (seen: 1 lane in 129
    and 1 in 227)."""
    got = _port_result(name)
    (o, d, _), _, (_, _, live), ts = _inputs(name)
    table = ci.face_table(ts.tris)
    t_ref, f_ref = (a.numpy() for a in ci.intersect_fused_plain(o, d, table))
    np.testing.assert_array_equal(got[1][live], f_ref[live])
    hit = live & (f_ref >= 0)
    np.testing.assert_allclose(got[0][hit], t_ref[hit], rtol=1e-4, atol=1e-5)
    lp = CASES[name][6]
    if lp is not None:
        h, s, t_light = ci._shadow_ray(o, d, torch.tensor(got[0]), torch.tensor(lp))
        occ = ci._sweep_plain(h, s, table, t_limit=t_light).numpy()
        assert (got[2][hit] != occ[hit]).mean() <= 0.01
        assert 0 < occ[hit].mean() < 1
        assert np.all(got[2][~hit])  # missed and dead lanes are seeded occluded


def test_early_out_skips_slots_and_changes_no_answer(monkeypatch):
    """K4's plain version on the sorted case, with and without the
    early-out: the same (t, face), and fewer (tile, slot) sweeps with it."""
    (o, d, clusters), _, _, _ = _inputs("sorted-early-out-alive-nee")
    swept = []
    real = cc._SweepState.sweep

    def spy(self, coeffs, tiles, cids):
        swept.append(int(tiles.numel()))
        return real(self, coeffs, tiles, cids)

    monkeypatch.setattr(cc._SweepState, "sweep", spy)
    perm = torch.argsort(coherence_keys(o, d, clusters.scene_min, clusters.scene_max),
                         stable=True)
    o, d = Vec3(*(a[perm] for a in o)), Vec3(*(a[perm] for a in d))
    cand, cnt, tent = candidates(o, d, clusters, cc.TILE)
    tent = torch.cat([tent, tent.new_full((tent.shape[0], 1), 3e38)], dim=1)
    seed_t = torch.full_like(o.x, float("inf"))
    seed_f = torch.full(o.x.shape, -1, dtype=torch.int32)
    results = {}
    for early in (False, True):
        swept.clear()
        out = cc._slotted_plain(cc._features(o, d, None), clusters.compact, cand, cnt, tent,
                                early, seed_t, seed_f, False)
        results[early] = (out, sum(swept))
    (t0, f0), n0 = results[False]
    (t1, f1), n1 = results[True]
    assert torch.equal(t0, t1) and torch.equal(f0, f1)
    assert n1 < n0
    assert n0 == int(((cand < cc.CAND_MISS)
                      & (torch.arange(cand.shape[1]) < cnt[:, None])).sum())


def _face_test_11(coeff, feats, s):
    """The face test as the 11-row sums: each of det, tnum, unum and vnum
    sums all of rows 0-10 in ascending order, left to right (the form K4
    had before the compact table). ``coeff`` (k, 16, 4S), ``feats`` (11, k,
    TILE); returns ``(t, valid, det)`` of (k, TILE, S)."""
    def contract(g):
        blk = coeff[:, :cc.FEATURE_ROWS, g * s:(g + 1) * s]
        acc = blk[:, 0, None, :] * feats[0, :, :, None]
        for i in range(1, cc.FEATURE_ROWS):
            acc = acc + blk[:, i, None, :] * feats[i, :, :, None]
        return acc

    det, tnum, unum, vnum = (contract(g) for g in range(4))
    inv = 1.0 / det
    t, u, v = tnum * inv, unum * inv, vnum * inv
    return t, (t >= 1e-5) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0), det


def _adversarial_rays(scene, seed):
    """Two tiles: 256 of the case's rays, 128 along the axes (directions
    with zero components, half of them from a face's first vertex) and 128
    from a random point or a first vertex towards a vertex or an edge's
    midpoint of a face."""
    rs = np.random.RandomState(seed)
    v0, e1, e2 = (np.stack(list(getattr(scene.tris, k))) for k in ("v0", "e1", "e2"))
    faces = rs.randint(0, v0.shape[1], 256)
    o_axis = rs.uniform(-1.2, 1.2, (3, 128))
    o_axis[:, :64] = v0[:, faces[:64]]
    d_axis = np.zeros((3, 128))
    d_axis[np.arange(128) % 3, np.arange(128)] = np.where(np.arange(128) % 2, 1.0, -1.0)
    f2 = faces[128:]
    targets = [v0[:, f2], v0[:, f2] + e1[:, f2], v0[:, f2] + e2[:, f2],
               v0[:, f2] + 0.5 * e1[:, f2], v0[:, f2] + 0.5 * (e1[:, f2] + e2[:, f2])]
    tgt = np.stack(targets)[np.arange(128) % 5, :, np.arange(128)].T
    o_pt = rs.uniform(-1.2, 1.2, (3, 128))
    o_pt[:, ::4] = v0[:, faces[::4][:32]]
    d_pt = tgt - o_pt
    d_pt[:, np.linalg.norm(d_pt, axis=0) == 0] = 1.0
    d_pt /= np.linalg.norm(d_pt, axis=0, keepdims=True)
    o_c, d_c, _ = _rays(256, seed)
    o = np.concatenate([o_c, o_axis, o_pt], 1).astype(np.float32)
    d = np.concatenate([d_c, d_axis, d_pt], 1).astype(np.float32)
    return _t3(o), _t3(d)


@pytest.mark.parametrize("name", list(CASES))
def test_compact_form_matches_the_11_row_form(name):
    """Every cluster of the case's scene against the case's rays and the
    adversarial ones: the compact face test's validity equals the 11-row
    form's, and t is equal wherever a face is valid. Padding faces give
    det = +-0 in both forms, with signs that may differ, and stay invalid."""
    n_faces, seed, size = CASES[name][:3]
    scene = _scene(n_faces, seed, size)
    clusters = to_torch(scene, "cpu").clusters
    coeffs = torch.from_numpy(scene.clusters.coeffs)
    o, d = _adversarial_rays(scene, seed)
    feats = torch.stack(cc._features(o, d, None))  # (11, 512)
    n_valid = n_zero_det = 0
    for lo in range(0, clusters.count, 16):
        cl = torch.arange(lo, min(lo + 16, clusters.count))
        f = feats[:, None, :].expand(-1, cl.numel(), -1)
        t11, valid11, det11 = _face_test_11(coeffs[cl], f, size)
        t, valid = cc._face_test(clusters.compact[cl], f)
        assert torch.equal(valid, valid11)
        assert torch.equal(t[valid], t11[valid])
        n_valid += int(valid.sum())
        n_zero_det += int((det11 == 0).sum())
    assert n_valid > 300 and n_zero_det > 0  # the case has substance


@pytest.mark.parametrize("name", list(CASES))
def test_compact_table_drops_only_zeros(name):
    """The repack keeps the layout's 19 entries a face verbatim, in
    ``COMPACT_TERMS`` order, and every entry of rows 0-10 it drops is 0."""
    n_faces, seed, size = CASES[name][:3]
    scene = _scene(n_faces, seed, size)
    coeffs, clusters = torch.from_numpy(scene.clusters.coeffs), to_torch(scene, "cpu").clusters
    tab = clusters.compact
    assert tab.shape == (clusters.count, size, cc.COMPACT) and tab.is_contiguous()
    assert torch.equal(tab, cc.compact_table(coeffs))
    blk = coeffs[:, :cc.FEATURE_ROWS].reshape(clusters.count, cc.FEATURE_ROWS, 4, size)
    kept = torch.zeros_like(blk, dtype=torch.bool)
    for j, (g, r) in enumerate(cc.COMPACT_TERMS):
        assert torch.equal(tab[:, :, j], blk[:, r, g])
        kept[:, r, g] = True
    assert not tab[:, :, len(cc.COMPACT_TERMS):].any()
    assert not blk[~kept].any()
    assert blk[kept].count_nonzero() > 0.9 * blk[kept].numel() * n_faces / (clusters.count * size)


@pytest.mark.parametrize("group, row", [(0, 0), (0, 10), (1, 5), (2, 9), (3, 0)])
def test_compact_table_raises_on_a_dropped_nonzero(group, row):
    """A block with a nonzero entry where the layout has none cannot be
    repacked: the compact sums would leave it out."""
    coeffs = torch.tensor(_scene(2000, 3, 64).clusters.coeffs)
    cc.compact_table(coeffs)
    coeffs[5, row, group * 64 + 7] = 0.25
    with pytest.raises(ValueError, match="nonzero"):
        cc.compact_table(coeffs)


def test_tile_order_is_heaviest_first():
    """K4's blocks take the tiles by listed slots, most first, ties in
    ascending tile order: a permutation of the tiles."""
    clusters = to_torch(_scene(12000, 11, 64), "cpu").clusters
    o, d, _ = _rays(16 * cc.TILE, 3, 0.75)
    o, d = _t3(o), _t3(d)
    perm = torch.argsort(coherence_keys(o, d, clusters.scene_min, clusters.scene_max),
                         stable=True)
    o, d = Vec3(*(a[perm] for a in o)), Vec3(*(a[perm] for a in d))
    cand, cnt, _ = candidates(o, d, clusters, cc.TILE)
    order = cc.tile_order(cand, cnt)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(cand.shape[0], dtype=torch.int32))
    listed = ((cand < cc.CAND_MISS) & (torch.arange(cand.shape[1]) < cnt[:, None])).sum(dim=1)
    lo = listed[order.long()]
    assert torch.all(lo[:-1] >= lo[1:]) and lo[0] > lo[-1]
    ties = lo[:-1] == lo[1:]
    assert torch.all(order[:-1][ties] < order[1:][ties])


def test_wrapper_rejects_what_the_kernels_do_not_take():
    (o, d, clusters), _, _, _ = _inputs("slotted-one-round")
    for precision in ("high", "default", "tri"):
        with pytest.raises(NotImplementedError, match="float32"):
            cc.intersect_cull(o, d, clusters, precision=precision)
    with pytest.raises(ValueError, match="alive"):
        cc.intersect_cull(o, d, clusters, alive=torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32"):
        cc.intersect_cull(Vec3(*(a.double() for a in o)), d, clusters)


def test_dispatch_sends_big_clustered_scenes_to_cull():
    """'cull' is an explicit mode: on the H100's band table ``auto`` sends
    clustered scenes above 12,288 faces to the per-ray walk (K8), whose
    frames beat K4's in every round (docs/BAND_TABLE_H100.json)."""
    cpu = torch.device("cpu")
    gpu = torch.device("cuda")
    for dev in (cpu, gpu):
        assert traverse.resolve_mode("auto", dev, 12_289, True, True) == "bvh"
        assert traverse.resolve_mode("auto", dev, 100_000, True, True) == "bvh"
        assert traverse.resolve_mode("auto", dev, 12_288, True) == "gated"
        assert traverse.resolve_mode("cull", dev, 400, True) == "cull"
    assert traverse.resolve_mode("auto", cpu, 100_000, False) == "brute"
    assert traverse.resolve_mode("auto", gpu, 100_000, False) == "pallas"


def test_intersect_scene_cull_counts_nothing_and_needs_clusters():
    """'cull' returns (None, None) in the counts slot (its early-out is
    not counted, as in the JAX package), and raises without clusters."""
    (o, d, clusters), kw, (_, _, live), ts = _inputs("masked-alive-nee")
    out = traverse.intersect_scene(o, d, ts.tris, mode="cull", clusters=clusters,
                                   with_counts=True, **kw)
    assert len(out) == 4 and out[-1] == (None, None)
    np.testing.assert_array_equal(out[1].numpy(), _port_result("masked-alive-nee")[1])
    with pytest.raises(ValueError, match="clusters"):
        traverse.intersect_scene(o, d, ts.tris, mode="cull")


# --- The slice: a frame of a soup above 96 clusters through 'cull' --------

FRAME = dict(width=16, height=16, samples=1, max_depth=3, max_added_depth=5,
             shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
             intersector="cull")


@functools.lru_cache(maxsize=None)
def _soup_frame_scene():
    """bench.py's soup scene (grey material, orb light, eye at z = 3.5),
    6,400 faces: 112 clusters, so 'cull' sorts and early-outs."""
    scene, _ = scene_from_text(*grey_soup(6400), use_bvh=True)
    cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    assert scene.clusters.count > cc.SORT_MIN_CLUSTERS
    return scene, cam


def test_soup_frame_matches_jax_package(monkeypatch):
    """The port's PathTracer (one frame, every bounce through the cull
    wrapper with the alive mask) against JAX's jitted trace_rays with
    intersector='cull' (interpret mode)."""
    scene, cam = _soup_frame_scene()
    calls = []
    real = cc.intersect_cull

    def spy(*args, **kw):
        calls.append(kw.get("alive") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(cc, "intersect_cull", spy)
    pt = PathTracer(scene, RenderSettings(**FRAME), device="cpu", lane_order="scanline")
    pt.render(cam, 5)
    assert calls == [True] * pt.settings.max_total_depth
    got = pt.image()[::-1]  # back to pixel-row order

    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    settings = JaxSettings(**FRAME, bounce_loop="scan", no_transparency=True)
    res = jax.jit(lambda: jax_integrator.trace_rays(
        jnp, jscene, jcam, settings, jnp.arange(256, dtype=jnp.int32), jnp.uint32(5),
        max_leaf=bvh_max_leaf(scene)))()
    ref = np.stack([np.asarray(c) for c in res.color], -1).reshape(16, 16, 3)
    assert np.isfinite(got).all() and got.mean() > 0.02
    diff = np.abs(got - ref).max(axis=-1)
    assert (diff > 1e-3).mean() <= 0.01, f"{(diff > 1e-3).mean():.2%} of pixels differ"


def test_soup_compaction_on_off_bitwise():
    """Compaction regroups lanes into other tiles, so the candidate lists
    and the sort change; the answers and the counters do not. 0 dropped."""
    scene, cam = _soup_frame_scene()
    ts, tc = to_torch(scene, "cpu"), camera_to_torch(cam, "cpu")
    settings = RenderSettings(**FRAME, compact_block=16, no_transparency=True)
    ids = torch.arange(256, dtype=torch.int32)
    full = trace_rays(ts, tc, settings, ids, 9, with_stats=True)
    sched = settings.replace(compact_schedule=((3, 0.6), (5, 0.3)))
    comp = trace_rays(ts, tc, sched, ids, 9, with_stats=True)
    assert int(comp.n_dropped) == 0
    for a, b in zip(full.color, comp.color):
        assert torch.equal(a, b)
    assert torch.equal(full.focus_t, comp.focus_t)
    for name in ("n_path_rays", "n_shadow_rays", "heat_bounces", "bounce_row_live",
                 "heat_tests"):
        assert torch.equal(getattr(full, name), getattr(comp, name)), name
    assert not full.heat_tests.any()  # 'cull' counts no tests


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_plain_on_card(name):
    """K4 (nearest and any-hit) and K4m against their plain versions on the
    card: t, face and occluded bitwise equal (--fmad=false), on the cases'
    rays and on 100,003 rays of the same kinds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels K4 and K4m have no CPU mode")
    args, kw, _, _ = _inputs(name, "cuda")
    big_o, big_d, big_alive = _rays(100_003, seed=7)
    big_kw = dict(kw, alive=None if kw["alive"] is None else torch.tensor(big_alive,
                                                                        device="cuda"))
    masked = args[2].count <= cc.MASKED_MAX_CLUSTERS
    for a, k in ((args, kw), ((_t3(big_o, "cuda"), _t3(big_d, "cuda"), args[2]), big_kw)):
        before = dict(cc.launches)
        got = cc.intersect_cull(*a, **k)
        ref = cc.intersect_cull_plain(*a, **k)
        torch.cuda.synchronize()
        inst = "K4m" if masked else "K4"
        assert cc.launches[inst] == before[inst] + 1
        assert cc.launches[inst + " any-hit"] == before[inst + " any-hit"] + (
            k["light_pos"] is not None)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
        cc.launches.update(before)  # the autouse check counts CPU launches only
