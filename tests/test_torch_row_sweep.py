"""Kernels K5 and K5m's module (pbr_tpu_torch/ops/cuda_sweep.py) and the
row sweep's lists (``candidates_rows``, ``row_hit_words`` of
pbr_tpu_torch/ops/cull.py): against the JAX package's
``pbr_tpu.ops.pallas_sweep.intersect_sweep`` and ``pbr_tpu.ops.cull``, run
as tests/test_sweep.py runs them on the CPU (interpret mode,
``tile=256, groups=8``, ``MASKED_MAX_LIN`` patched to force the slotted
kernel), and against the brute-force sweep; then the slice as a whole (a
frame through ``intersector='sweep'``).

Tolerances: the integer tables (candidate entries with their row bits,
counts, verdict words) and the ``with_counts`` counters are held equal;
the entry bounds, which carry the box-distance ``sqrt`` (torch's float32
CPU sqrt is 1 ULP off on ~0.7% of inputs), to 1e-6. Faces must be equal;
t within rtol 1e-4 / atol 1e-5 on hit lanes (those of tests/test_sweep.py),
since XLA on the CPU may sum the linear form's dot products in another
order. Occlusion may differ on at most 1% of the hit lanes, the tolerance
tests/test_torch_cull_sweep.py states and explains: where t differs by an
ULP the shadow ray starts elsewhere and may turn at the t >= 1e-5 self-hit
gate. Frames: the repo's frame gate, at least 99% of pixels within 1e-3
(tests/test_render_golden.py), since a ULP difference can turn a path; on
the port alone, compaction on and off is bitwise equal.

The JAX reference compiles once per (lin clusters, tiles, slots, pass),
7-20 s each here. The kernels themselves run only on a card: the
``cuda``-marked test skips here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbr_tpu.ops.pallas_sweep as jax_sweep
from pbr_tpu.accel.clusters import build_clusters
from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops import cull as jcull
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import bvh_max_leaf, scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.scene.procedural import random_soup
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu_torch import PathTracer, camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import cuda_sweep as cs
from pbr_tpu_torch.ops import cull, traverse
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.procedural import grey_soup
from pbr_tpu_torch.utils.config import RenderSettings

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

LIGHT = (0.0, 2.4, 0.0)  # bench.py's soup orb
TILE, GROUPS = cs.TILE, cs.GROUPS

# name: (soup faces, seed, cluster size, rays, JAX slots, alive, light,
# share of camera rays, force the slotted kernel). 512 faces in 32-face
# clusters are 4 lin clusters (K5m, or K5 when forced); 6,400 faces are 56
# lin clusters (K5 in one round without the sort; slots=8 makes the JAX
# reference sweep 7 rounds); 13,000 are 104 (K5 with the coherence sort and
# the early-out). A row early-outs only once every live ray has hit, so the
# early-out case traces camera rays only, at a soup dense enough that every
# one of them hits.
CASES = {
    "masked-alive-nee": (512, 3, 32, 512, 128, True, LIGHT, 0.75, False),
    "slotted-forced-alive-nee": (512, 3, 32, 512, 128, True, LIGHT, 0.75, True),
    "slotted-one-round": (6400, 5, 64, 512, 128, False, None, 0.5, False),
    "rounds-slots8-odd": (6400, 11, 64, 333, 8, False, None, 0.5, False),
    "sorted-early-out-alive-nee": (13000, 11, 64, 1024, 128, True, LIGHT, 1.0, False),
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


@pytest.fixture
def force(monkeypatch):
    """``force(name)``: patch the port's masked bound to 0 where the case
    forces the slotted kernel (``_jax_result`` patches the JAX package's)."""
    def apply(name):
        if CASES[name][8]:
            monkeypatch.setattr(cs, "MASKED_MAX_LIN", 0)
    return apply


def _inputs(name, device="cpu"):
    n_faces, seed, size, n, _, use_alive, lp, cam, _ = CASES[name]
    scene = _scene(n_faces, seed, size)
    o, d, alive = _rays(n, n + seed, cam)
    ts = to_torch(scene, device)
    kw = dict(light_pos=None if lp is None else _light(lp, device),
              alive=torch.tensor(alive, device=device) if use_alive else None)
    live = alive if use_alive else np.ones(n, bool)
    return (_t3(o, device), _t3(d, device), ts.clusters), kw, (o, d, live), ts


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    n_faces, seed, size, n, slots, use_alive, lp, cam, forced = CASES[name]
    scene = _scene(n_faces, seed, size)
    o, d, alive = _rays(n, n + seed, cam)
    jset = jax.tree_util.tree_map(jnp.asarray, scene.clusters)
    old = jax_sweep.MASKED_MAX_LIN
    try:
        if forced:
            jax_sweep.MASKED_MAX_LIN = 0
        out = jax_sweep.intersect_sweep(
            jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), jset,
            light_pos=None if lp is None else JVec3(*(jnp.float32(v) for v in lp)),
            alive=jnp.asarray(alive) if use_alive else None, tile=TILE, groups=GROUPS,
            slots=slots, interpret=True, with_counts=True,
        )
    finally:
        jax_sweep.MASKED_MAX_LIN = old
    return tuple(np.asarray(a) for a in out)


@functools.lru_cache(maxsize=None)
def _port_result(name):
    args, kw, _, _ = _inputs(name)
    old = cs.MASKED_MAX_LIN
    try:
        if CASES[name][8]:
            cs.MASKED_MAX_LIN = 0
        return tuple(a.numpy() for a in cs.intersect_sweep(*args, **kw, with_counts=True))
    finally:
        cs.MASKED_MAX_LIN = old


@pytest.fixture(autouse=True)
def _no_cuda_launch_counted():
    before = dict(cs.launches)
    yield
    assert cs.launches == before  # CPU tensors never launch a kernel


def test_cases_reach_each_kernel_path():
    """The cases cover K5m, K5 forced on a small table, K5 in one round
    without the sort, the JAX reference's round loop, and K5 with the sort
    and the early-out."""
    lins = {name: _inputs(name)[0][2].lin.shape[0] for name in CASES}
    assert lins["masked-alive-nee"] <= cs.MASKED_MAX_LIN
    assert cs.MASKED_MAX_LIN < lins["slotted-one-round"] <= cs.SORT_MIN_LIN
    assert lins["rounds-slots8-odd"] > CASES["rounds-slots8-odd"][4]
    assert CASES["rounds-slots8-odd"][3] % TILE
    assert lins["sorted-early-out-alive-nee"] > cs.SORT_MIN_LIN


def test_lin_tables_carried_to_the_device():
    """``to_torch`` carries the lin tables and their AABBs byte for byte."""
    scene = _scene(6400, 5, 64)
    tc = to_torch(scene, "cpu").clusters
    np.testing.assert_array_equal(tc.lin.numpy(), scene.clusters.lin)
    assert tc.lin.dtype == torch.float32 and tc.lin.shape == (56, 16, 128)
    for got, ref in ((tc.lbb_min, scene.clusters.lbb_min), (tc.lbb_max, scene.clusters.lbb_max)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b)
    # 6,400 faces fill 50 lin clusters; the 6 padding ones have inverted boxes
    assert (tc.lbb_min.x[50:] > tc.lbb_max.x[50:]).all()
    assert (tc.lbb_min.x[:50] <= tc.lbb_max.x[:50]).all()


def _sorted_case_rays(name):
    """The case's rays (whole tiles), sorted as the wrapper sorts them."""
    (o, d, clusters), kw, _, _ = _inputs(name)
    perm = torch.argsort(cull.coherence_keys(o, d, clusters.scene_min, clusters.scene_max),
                         stable=True)
    return Vec3(*(a[perm] for a in o)), Vec3(*(a[perm] for a in d)), clusters


@pytest.mark.parametrize("octants", [True, False])
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_candidates_rows_match_jax_package(octants, capped, backend):
    """Counts equal; entries (lin ids with their row bits) equal to
    jax.numpy's, whose argsort is stable like the port's, and per tile
    equal as sets to NumPy's, whose default argsort may order ties
    otherwise; entry bounds within 1e-6."""
    o, d, clusters = _sorted_case_rays("sorted-early-out-alive-nee")
    scene = _scene(*CASES["sorted-early-out-alive-nee"][:3])
    n = o.x.shape[0]
    rs = np.random.RandomState(5)
    cap = rs.uniform(0.5, 6.0, n // (TILE // GROUPS)).astype(np.float32) if capped else None
    live = np.arange(n) % 5 != 2
    xp = np if backend == "numpy" else jnp
    jcs = scene.clusters if xp is np else jax.tree_util.tree_map(jnp.asarray, scene.clusters)
    with np.errstate(all="ignore"):
        ref = [np.asarray(a) for a in jcull.candidates_rows(
            xp, JVec3(*(xp.asarray(a.numpy()) for a in o)),
            JVec3(*(xp.asarray(a.numpy()) for a in d)), jcs, TILE, GROUPS,
            t_cap=None if cap is None else xp.asarray(cap), octants=octants,
            live=xp.asarray(live))]
    got = [a.numpy() for a in cull.candidates_rows(
        o, d, clusters, TILE, GROUPS, t_cap=None if cap is None else torch.tensor(cap),
        octants=octants, live=torch.tensor(live))]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert got[2].dtype == np.float32 and got[0].shape == ref[0].shape
    np.testing.assert_array_equal(got[1], ref[1])
    if backend == "jax":
        np.testing.assert_array_equal(got[0], ref[0])
    else:
        for t in range(got[0].shape[0]):
            assert sorted(got[0][t, : got[1][t]]) == sorted(ref[0][t, : ref[1][t]]), t
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=1e-6)
    listed = np.arange(got[0].shape[1])[None, :] < got[1][:, None]
    rows = got[0] >> 16  # some listed slots run for some rows only
    assert (listed & (rows != 0)).any() and (listed & (rows != 0xFF)).any()


@pytest.mark.parametrize("octants", [True, False])
@pytest.mark.parametrize("capped", [False, True])
def test_row_hit_words_match_jax_package(octants, capped):
    """Verdict words equal, with an odd lin cluster count (a zero half
    word at the end)."""
    scene = _scene(6400, 5, 64)
    cset = scene.clusters._replace(
        lin=scene.clusters.lin[:55], lbb_min=JVec3(*(a[:55] for a in scene.clusters.lbb_min)),
        lbb_max=JVec3(*(a[:55] for a in scene.clusters.lbb_max)))
    o, d, alive = _rays(4 * TILE, 31)
    cap = np.random.RandomState(6).uniform(0.2, 3.0, 4 * GROUPS).astype(np.float32)
    with np.errstate(all="ignore"):
        ref = np.asarray(jcull.row_hit_words(
            jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)),
            jax.tree_util.tree_map(jnp.asarray, cset), TILE, GROUPS,
            t_cap=jnp.asarray(cap) if capped else None, octants=octants,
            live=jnp.asarray(alive)))
    tc = to_torch(scene, "cpu").clusters
    tc = tc._replace(lin=tc.lin[:55], lbb_min=Vec3(*(a[:55] for a in tc.lbb_min)),
                     lbb_max=Vec3(*(a[:55] for a in tc.lbb_max)))
    got = cull.row_hit_words(_t3(o), _t3(d), tc, TILE, GROUPS,
                             t_cap=torch.tensor(cap) if capped else None, octants=octants,
                             live=torch.tensor(alive)).numpy()
    assert got.dtype == np.int32 and got.shape == (4, 28)
    np.testing.assert_array_equal(got, ref)
    assert not (got[:, -1] >> 8).any() and got.any() and (got != 0xFFFF).any()


def test_candidates_rows_are_near_to_far_and_conservative():
    """Listed slots come in non-decreasing entry bound, and every lin
    cluster holding a live ray's nearest hit is listed with that ray's row
    bit set."""
    o, d, clusters = _sorted_case_rays("sorted-early-out-alive-nee")
    cand, cnt, tent = (a.numpy() for a in cull.candidates_rows(o, d, clusters, TILE, GROUPS))
    _, face = ci.intersect_fused_plain(o, d, ci.face_table(_inputs(
        "sorted-early-out-alive-nee")[3].tris))
    face = face.numpy()
    rg = TILE // GROUPS
    for t in range(cand.shape[0]):
        assert np.all(np.diff(tent[t, : cnt[t]]) >= 0)
        ids, rows = cand[t, : cnt[t]] & 0xFFFF, cand[t, : cnt[t]] >> 16
        for g in range(GROUPS):
            need = face[t * TILE + g * rg: t * TILE + (g + 1) * rg]
            for c in np.unique(need[need >= 0] // cs.LIN):
                (slot,) = np.nonzero(ids == c)[0]
                assert (rows[slot] >> g) & 1, (t, g, c)


def _assert_occlusion(got, ref, hit):
    """Occlusion on the hit lanes, at most 1% of them differing."""
    assert (got[2][hit] != ref[2][hit]).mean() <= 0.01
    assert 0 < got[2][hit].mean() < 1


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_package(name):
    """Faces, t, occlusion and the ``with_counts`` counters against JAX's
    interpret-mode row sweep."""
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
    assert got[-1].dtype == np.int32
    np.testing.assert_array_equal(got[-1], ref[-1])  # verdict counts, exact
    assert (got[-1] % cs.LIN == 0).all() and (got[-1][hit] >= cs.LIN).all()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_brute_force(name, force):
    """On live lanes, the faces of the classic all-faces sweep (kernel K1's
    plain version) and t within the tolerance. With a light, the any-hit
    pass against the classic sweep's any-hit on the same shadow rays (from
    the row sweep's own t, with the wrapper's guarded math): the two forms
    of the face test round differently at the gates, so at most 1% of the
    hit lanes may differ."""
    force(name)
    (o, d, clusters), kw, (_, _, live), ts = _inputs(name)
    got = [a.numpy() for a in cs.intersect_sweep(o, d, clusters, **kw)]
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
        assert np.all(got[2][~hit])  # missed and dead lanes are seeded occluded


def _sweep_spy(monkeypatch):
    swept = []
    real = cs._RowState.sweep

    def spy(self, lin, rows, cids, work=None):
        swept.append(int(rows.numel()))
        return real(self, lin, rows, cids, work)

    monkeypatch.setattr(cs._RowState, "sweep", spy)
    return swept


@pytest.mark.parametrize("any_hit", [False, True])
def test_early_out_skips_rows_and_changes_no_answer(monkeypatch, any_hit):
    """K5's plain version on the sorted case, with and without the
    early-out: the same result, and fewer (row, slot) sweeps with it; the
    any-hit pass on shadow rays towards the light, capped per row."""
    o, d, clusters = _sorted_case_rays("sorted-early-out-alive-nee")
    swept = _sweep_spy(monkeypatch)
    n = o.x.shape[0]
    t_limit = t_cap = None
    seed_t = torch.full((n,), float("inf"))
    seed_f = torch.full((n,), -1, dtype=torch.int32)
    if any_hit:
        t, _ = cs._slotted_plain(o, d, None, clusters.lin,
                                 *_tent_lists(o, d, clusters, None), True, seed_t, seed_f)
        hit = t < float("inf")
        h = o + d * torch.where(hit, t, 1.0)
        lv = Vec3(*(torch.tensor(v) - a for v, a in zip(LIGHT, h)))
        t_limit = torch.sqrt(lv.length2())
        o, d = h, lv * (1.0 / t_limit)
        t_cap = torch.where(hit, t_limit, 0.0).reshape(-1, cs.ROW).amax(dim=1)
        seed_t = torch.where(hit, 0.0, 1.0)
    lists = _tent_lists(o, d, clusters, t_cap)
    results = {}
    for early in (False, True):
        swept.clear()
        out = cs._slotted_plain(o, d, t_limit, clusters.lin, *lists, early, seed_t, seed_f)
        results[early] = (out if any_hit else torch.cat([out[0], out[1].float()]), sum(swept))
    (r0, n0), (r1, n1) = results[False], results[True]
    assert torch.equal(r0, r1)
    assert n1 < n0
    cand, cnt = lists[0], lists[1]
    listed = torch.arange(cand.shape[1])[None, :] < cnt[:, None]
    assert n0 == sum(int(((((cand >> (16 + g)) & 1) != 0) & listed).sum())
                     for g in range(GROUPS))


def _tent_lists(o, d, clusters, t_cap):
    cand, cnt, tent = cull.candidates_rows(o, d, clusters, TILE, GROUPS, t_cap=t_cap)
    return cand, cnt, torch.cat([tent, tent.new_full((tent.shape[0], 1), 3e38)], dim=1)


@pytest.mark.parametrize("name, chunk, lists", [
    ("sorted-early-out-alive-nee", 512, "candidates_rows"),
    ("slotted-forced-alive-nee", 256, "candidates_rows"),
    ("masked-alive-nee", 256, "row_hit_words"),
])
def test_chunked_lists_change_no_answer(monkeypatch, force, name, chunk, lists):
    """The lists built ``chunk`` rays at a time (several chunks a pass):
    (t, face, occluded, tests) equal to one chunk, with NEE and the
    counters."""
    force(name)
    args, kw, _, _ = _inputs(name)
    one = cs.intersect_sweep_plain(*args, **kw, with_counts=True)
    calls = []
    real = getattr(cs, lists)

    def spy(o, *a, **k):
        calls.append(o.x.shape[0])
        return real(o, *a, **k)

    monkeypatch.setattr(cs, lists, spy)
    monkeypatch.setattr(cs, "SWEEP_CHUNK_RAYS", chunk)
    many = cs.intersect_sweep_plain(*args, **kw, with_counts=True)
    assert calls == [chunk] * (2 * CASES[name][3] // chunk)  # both passes, whole chunks
    assert len(many) == len(one) == 4
    for a, b in zip(many, one):
        assert torch.equal(a, b)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    (o, d, clusters), _, _, _ = _inputs("slotted-one-round")
    with pytest.raises(ValueError, match="alive"):
        cs.intersect_sweep(o, d, clusters, alive=torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32"):
        cs.intersect_sweep(Vec3(*(a.double() for a in o)), d, clusters)
    with pytest.raises(ValueError, match="lin tables"):
        cs.intersect_sweep(o, d, clusters._replace(lin=None))
    with pytest.raises(ValueError, match="lin tables"):
        cs.intersect_sweep(o, d, clusters._replace(lin=clusters.lin[:, :, :64].contiguous()))


def test_dispatch_runs_sweep_and_gemm_still_raises():
    """'sweep' and 'gemm' resolve on either device and 'auto' picks
    neither (every mode is ported; test_torch_render.py holds the refusal
    of what is not, Phong tessellation); 'gemm' runs on the soup and finds
    the brute sweep's faces on all but grazing rays."""
    for dev in (torch.device("cpu"), torch.device("cuda")):
        assert traverse.resolve_mode("sweep", dev, 100_000, True) == "sweep"
        assert traverse.resolve_mode("gemm", dev, 100_000, True) == "gemm"
        assert traverse.resolve_mode("auto", dev, 100_000, True, True) == "bvh"
    (o, d, _), _, _, ts = _inputs("masked-alive-nee")
    _, f_g = traverse.intersect_scene(o, d, ts.tris, mode="gemm")
    _, f_b = traverse.intersect_brute(o, d, ts.tris)
    assert (f_g == f_b).float().mean() > 0.995


@pytest.mark.parametrize("name", ["masked-alive-nee", "sorted-early-out-alive-nee"])
def test_intersect_scene_sweep_matches_brute(name):
    """``intersect_scene(mode='sweep')``: faces equal the plain brute
    sweep's on live lanes, t re-evaluated as the classic form's, the
    fused leg's occlusion and the verdict counts in the counts slot
    (visits None); without clusters or lin tables it raises JAX's
    ValueError."""
    (o, d, clusters), kw, (_, _, live), ts = _inputs(name)
    out = traverse.intersect_scene(o, d, ts.tris, mode="sweep", clusters=clusters,
                                   with_counts=True, **kw)
    t_b, f_b = traverse.intersect_brute(o, d, ts.tris)
    assert len(out) == 4
    np.testing.assert_array_equal(out[1].numpy()[live], f_b.numpy()[live])
    hit = torch.tensor(live) & (f_b >= 0)
    assert torch.equal(out[0][hit], t_b[hit])  # one Moller-Trumbore on the same face
    np.testing.assert_array_equal(out[2].numpy(), _port_result(name)[2])
    np.testing.assert_array_equal(out[3][0].numpy(), _port_result(name)[-1])
    assert out[3][1] is None
    with pytest.raises(ValueError, match="lin tables"):
        traverse.intersect_scene(o, d, ts.tris, mode="sweep")
    with pytest.raises(ValueError, match="lin tables"):
        traverse.intersect_scene(o, d, ts.tris, mode="sweep", clusters=clusters._replace(lin=None))


# --- The slice: a frame of a soup through 'sweep' -------------------------

FRAME = dict(width=16, height=16, samples=1, max_depth=3, max_added_depth=5,
             shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
             intersector="sweep")


@functools.lru_cache(maxsize=None)
def _soup_frame_scene():
    """bench.py's soup scene (grey material, orb light, eye at z = 3.5),
    6,400 faces: 56 lin clusters, so 'sweep' runs the slotted kernel."""
    scene, _ = scene_from_text(*grey_soup(6400), use_bvh=True)
    cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    assert cs.MASKED_MAX_LIN < scene.clusters.lin.shape[0]
    return scene, cam


def test_soup_frame_matches_jax_package(monkeypatch):
    """The port's PathTracer (one frame, every bounce through the row sweep
    with the alive mask) against JAX's jitted trace_rays with
    intersector='sweep' (interpret mode)."""
    scene, cam = _soup_frame_scene()
    calls = []
    real = cs.intersect_sweep

    def spy(*args, **kw):
        calls.append(kw.get("alive") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(cs, "intersect_sweep", spy)
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
    """Compaction regroups lanes into other rows, so the lists change; the
    answers and the counters do not, but for the test counts (a lane's
    count is its row's). 0 dropped."""
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
    for name in ("n_path_rays", "n_shadow_rays", "heat_bounces", "bounce_row_live"):
        assert torch.equal(getattr(full, name), getattr(comp, name)), name
    # 'sweep' counts the face tests its rows' verdicts ask for
    for res in (full, comp):
        assert int(res.heat_tests.sum()) > 0 and (res.heat_tests % cs.LIN == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_plain_on_card(name, force):
    """K5 (nearest and any-hit) and K5m against their plain versions on the
    card: t, face, occluded and the counts bitwise equal (--fmad=false), on
    the cases' rays and on 100,003 rays of the same kinds. The kernels read
    the face-major lin table; each K5 pass also replayed with its tiles in
    launch order and reversed, not heaviest first, equals the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels K5 and K5m have no CPU mode")
    force(name)
    args, kw, _, _ = _inputs(name, "cuda")
    big_o, big_d, big_alive = _rays(100_003, seed=7)
    big_kw = dict(kw, alive=None if kw["alive"] is None else torch.tensor(big_alive,
                                                                        device="cuda"))
    masked = args[2].lin.shape[0] <= cs.MASKED_MAX_LIN
    for a, k in ((args, kw), ((_t3(big_o, "cuda"), _t3(big_d, "cuda"), args[2]), big_kw)):
        before = dict(cs.launches)
        got = cs.intersect_sweep(*a, **k, with_counts=True)
        ref = cs.intersect_sweep_plain(*a, **k, with_counts=True)
        torch.cuda.synchronize()
        inst = "K5m" if masked else "K5"
        assert cs.launches[inst] == before[inst] + 1
        assert cs.launches[inst + " any-hit"] == before[inst + " any-hit"] + (
            k["light_pos"] is not None)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
        passes = []

        def slotted(*args):
            passes.append(args)
            return cs._slotted_kernel(*args)

        cs._sweep(slotted, cs._masked_kernel, *a, k["light_pos"], k["alive"], False)
        assert len(passes) == (0 if masked else 1 + (k["light_pos"] is not None))
        for args in passes:
            assert args[3].transpose(1, 2).is_contiguous()  # the face-major table
            plain = cs._slotted_plain(*args)
            n_tiles = args[4].shape[0]
            for order in (torch.arange(n_tiles), torch.arange(n_tiles - 1, -1, -1)):
                out = cs._slotted_kernel(*args, order=order.to(torch.int32).cuda())
                for x, y in zip(out if isinstance(out, tuple) else (out,),
                                plain if isinstance(plain, tuple) else (plain,)):
                    assert torch.equal(x, y)
        cs.launches.update(before)  # the autouse check counts CPU launches only
