"""The port's Phong tessellation (pbr_tpu_torch/ops/phongtess.py) against the
JAX package's backend-generic ``pbr_tpu.ops.phongtess``: its NumPy form
(``xp=np``) as the oracle, and its jax.numpy cluster search on the CPU.

Tolerances, from the JAX package's own tests: face agreement above 0.99
(tests/test_phongtess_bvh.py:242, :276), ``u`` within 2e-3 (:244), ``t``
within rtol 2e-3 / atol 2e-4 (:279-280). The cubic solve's transcendentals
(acos, cos, pow, the cube root) and torch's CPU sqrt (1 ULP off NumPy on
~0.7% of inputs) are not bitwise NumPy's. The port's cube root is the
float64 power rounded once, exact on these inputs; NumPy's float32
``cbrt`` is up to 2 ULP off it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops import cull as jcull
from pbr_tpu.ops import phongtess as J
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu_torch.ops import cull, phongtess
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch
from pbr_tpu_torch.scene.build import scene_from_text

torch.set_num_threads(1)

ALPHA = 0.8
MTL = "newmtl m\nKd 0.5 0.6 0.7\nKs 1 1 1\nrough 1\np 1\n"
BUMPY = """
o bump
v -1.0 0.0 -1.0
v 1.0 0.0 -1.0
v 0.0 1.5 -1.0
vn -0.3 0.0 0.954
vn 0.3 0.0 0.954
vn 0.0 0.3 0.954
f 1//1 2//2 3//3
"""


def wavy_sheet_obj(n: int = 6) -> str:
    """tests/test_phongtess_bvh.py::_wavy_sheet_obj: a tessellated wavy
    sheet in the z = -1 plane with smooth per-vertex normals (every face a
    curved patch), 2 n² faces."""
    xs = np.linspace(-1.5, 1.5, n + 1)
    ys = np.linspace(-1.0, 1.5, n + 1)
    lines = ["o sheet"]
    for y in ys:
        for x in xs:
            z = -1.0 + 0.15 * np.sin(2.0 * x) * np.cos(2.0 * y)
            lines.append(f"v {x:.6f} {y:.6f} {z:.6f}")
            dzdx = 0.3 * np.cos(2.0 * x) * np.cos(2.0 * y)
            dzdy = -0.3 * np.sin(2.0 * x) * np.sin(2.0 * y)
            nrm = np.array([-dzdx, -dzdy, 1.0])
            nrm /= np.linalg.norm(nrm)
            lines.append(f"vn {nrm[0]:.6f} {nrm[1]:.6f} {nrm[2]:.6f}")
    w = n + 1
    for j in range(n):
        for i in range(n):
            a, b, c, d = j * w + i + 1, j * w + i + 2, (j + 1) * w + i + 2, (j + 1) * w + i + 1
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
            lines.append(f"f {a}//{a} {c}//{c} {d}//{d}")
    return "\n".join(lines) + "\n"


def sheet_rays(n: int, seed: int):
    """tests/test_phongtess_bvh.py::_rays: rays from z = 1.5 toward the
    sheet, (3, n) float32 origins and directions."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.5, n),
                  np.full(n, 1.5)]).astype(np.float32)
    dn = rng.normal(size=(3, n)).astype(np.float32)
    dn[2] = -np.abs(dn[2]) - 0.5
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    return o, dn


def _both(obj: str, use_bvh: bool = True, alpha: float = ALPHA):
    """The same OBJ built by both packages' host layers."""
    kw = dict(use_bvh=use_bvh, phong_tess_alpha=alpha)
    return jax_scene_from_text(obj, MTL, "", **kw)[0], scene_from_text(obj, MTL, "", **kw)[0]


def _t3(a) -> Vec3:
    return Vec3(*(torch.tensor(np.ascontiguousarray(c)) for c in a))


def _assert_hits_close(got, ref, uv: bool = True):
    """(t, face, u, v) against the NumPy form at the JAX tests' tolerances
    (``uv``: also u and v, as tests/test_phongtess_bvh.py:244 does for the
    cluster search; its dispatch test, :266-281, holds t only)."""
    t, f, u, v = (a.numpy() for a in got)
    rt, rf, ru, rv = ref
    agree = f == rf
    assert agree.mean() > 0.99, f"face agreement {agree.mean():.4f}"
    hit = agree & (rf >= 0)
    assert hit.mean() > 0.1
    np.testing.assert_allclose(t[hit], rt[hit], rtol=2e-3, atol=2e-4)
    if uv:
        np.testing.assert_allclose(u[hit], ru[hit], atol=2e-3)
        np.testing.assert_allclose(v[hit], rv[hit], atol=2e-3)
    assert np.array_equal(np.isinf(t), f < 0)


# ---- the cubic solve ---------------------------------------------------------

def _coeffs(branch: str, n: int, rng):
    """(a0, a1, a2, a3) float32 arrays whose polynomials fall in ``branch``,
    with well-separated real roots (a solve's roots are ill-conditioned
    near a double root in any precision)."""
    r = np.sort(rng.uniform(-3, 3, (3, n)), axis=0)
    r[1] = r[0] + 0.3 + np.abs(r[1] - r[0])
    r[2] = r[1] + 0.3 + np.abs(r[2] - r[1])
    s = rng.uniform(0.5, 2.0, n) * rng.choice([-1.0, 1.0], n)
    zero = np.zeros(n)
    if branch == "three":  # s (x - r0)(x - r1)(x - r2)
        co = (s, -s * (r[0] + r[1] + r[2]), s * (r[0] * r[1] + r[0] * r[2] + r[1] * r[2]),
              -s * r[0] * r[1] * r[2])
    elif branch == "one":  # s (x - r0)(x² + b x + c), b² < 4c
        b = rng.uniform(-1, 1, n)
        c = b * b / 4 + rng.uniform(0.5, 2.0, n)
        co = (s, s * (b - r[0]), s * (c - r[0] * b), -s * r[0] * c)
    elif branch == "quadratic":  # s (x - r0)(x - r1)
        co = (zero, s, -s * (r[0] + r[1]), s * r[0] * r[1])
    elif branch == "linear":
        co = (zero, zero, s, -s * r[0])
    else:  # degenerate: all zero, or a quadratic without real roots
        half = n // 2
        q = np.where(np.arange(n) < half, 0.0, s)
        co = (zero, q, zero, q * rng.uniform(0.5, 2.0, n))
    return [np.asarray(c, dtype=np.float32) for c in co]


@pytest.mark.parametrize("branch, count", [("three", 3), ("one", 1), ("quadratic", 2),
                                           ("linear", 1), ("degenerate", 0)])
def test_solve_cubic_branches_match_numpy(branch, count):
    a = _coeffs(branch, 4096, np.random.default_rng(len(branch)))
    with np.errstate(all="ignore"):
        ref = J.solve_cubic(np, *a)
    got = [x.numpy() for x in phongtess.solve_cubic(*(torch.tensor(c) for c in a))]
    assert got[3].dtype == np.int32
    np.testing.assert_array_equal(got[3], ref[3])
    assert (got[3] == count).all()
    for x, rx in zip(got[:count], ref[:count]):
        np.testing.assert_allclose(x, rx, rtol=1e-5, atol=1e-4)
    for x, rx in zip(got[count:], ref[count:]):
        if count:  # the unused slots are -1, as NumPy's (x0 unless count is 0)
            np.testing.assert_array_equal(x, rx)
    if branch == "quadratic":  # the patch test's second solve: bitwise solve_cubic
        q = phongtess.solve_quadratic(*(torch.tensor(c) for c in a[1:]))
        for x, y in zip(q, (got[0], got[1], got[3])):
            np.testing.assert_array_equal(x.numpy(), y)


def test_cbrt_is_rounded_once():
    x = np.random.default_rng(0).normal(size=100_000) * 10.0 ** np.random.default_rng(
        1).integers(-30, 30, 100_000)
    x = x.astype(np.float32)
    got = phongtess.cbrt(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.cbrt(x.astype(np.float64)).astype(np.float32))
    ulp = np.abs(got.view(np.int32).astype(np.int64) - np.cbrt(x).view(np.int32))
    assert ulp.max() <= 2  # NumPy's float32 cbrt is not correctly rounded
    assert phongtess.cbrt(torch.tensor([-8.0, 0.0, 27.0])).tolist() == [-2.0, 0.0, 3.0]


# ---- the patch test, normal and flatness ------------------------------------

def _patch_rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(0.0, 1.3, n),
                  np.full(n, 2.0)]).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


@pytest.mark.parametrize("alpha", [0.01, 0.8, 1.0])
def test_patch_intersect_and_normal_match_numpy(alpha):
    jscene, scene = _both(BUMPY, use_bvh=False)
    o, d = _patch_rays(4096, 3)
    tri = jscene.tris
    p1 = JVec3(*(c[0] for c in tri.v0))
    e1, e2 = JVec3(*(c[0] for c in tri.e1)), JVec3(*(c[0] for c in tri.e2))
    n1, n2, n3 = (JVec3(*(c[0] for c in nn)) for nn in (tri.n0, tri.n1, tri.n2))
    p2, p3 = p1 + e1, p1 + e2
    inf = np.full(o.shape[1], np.inf, dtype=np.float32)
    with np.errstate(all="ignore"):
        ref = J.phongtess_patch_intersect(np, JVec3(*o), JVec3(*d), p1, p2, p3, n1, n2, n3,
                                          np.float32(alpha), inf)
    s = lambda v: Vec3(*(torch.tensor(np.float32(c)) for c in v))  # noqa: E731
    P1, P2, P3, N1, N2, N3 = (s(v) for v in (p1, p2, p3, n1, n2, n3))
    got = phongtess.phongtess_patch_intersect(_t3(o), _t3(d), P1, P2, P3, N1, N2, N3, alpha,
                                              torch.tensor(inf))
    valid = got[3].numpy()
    assert (valid == ref[3]).mean() > 0.99 and valid.mean() > 0.3
    both = valid & ref[3]
    np.testing.assert_allclose(got[0].numpy()[both], ref[0][both], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy()[both], ref[1][both], atol=2e-3)
    np.testing.assert_allclose(got[2].numpy()[both], ref[2][both], atol=2e-3)

    # The shading normal at the hit's patch coordinates, and the constants.
    consts = J.patch_constants(p1, p2, p3, n1, n2, n3, np.float32(alpha))
    cg = phongtess.patch_constants(P1, P2, P3, N1, N2, N3, alpha)
    for a, b in zip(cg, consts):
        np.testing.assert_allclose(torch.stack(list(a)).numpy(), np.stack(list(b)), rtol=1e-6,
                                   atol=1e-7)
    u, v = ref[1][both], ref[2][both]
    dd = JVec3(*(c[both] for c in d))
    with np.errstate(all="ignore"):
        nref = J.phongtess_normal(np, dd, n1, n2, n3, *consts, u, v)
    ngot = phongtess.phongtess_normal(_t3(dd), N1, N2, N3, *cg, torch.tensor(u), torch.tensor(v))
    np.testing.assert_allclose(ngot.stack().numpy(), np.stack(list(nref), -1), atol=1e-5)


def test_face_is_flat_matches_numpy():
    for obj in (BUMPY, wavy_sheet_obj(3), "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"):
        jscene, scene = _both(obj, use_bvh=False, alpha=0.0)
        ref = J.face_is_flat(np, jscene.tris)
        got = phongtess.face_is_flat(to_torch(scene, "cpu").tris).numpy()
        np.testing.assert_array_equal(got, ref)
    flat_scene = scene_from_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", use_bvh=False)[0]
    assert phongtess.face_is_flat(to_torch(flat_scene, "cpu").tris).all()
    bump = scene_from_text(BUMPY, MTL, use_bvh=False)[0]
    assert not phongtess.face_is_flat(to_torch(bump, "cpu").tris).any()


# ---- the host layer ----------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.3, ALPHA, 1.0])
def test_face_aabbs_and_build_are_the_jax_packages(alpha):
    """``phongtess_face_aabbs`` byte-equal to JAX's, and a Phong build's BVH
    and cluster bounds (NumPy build_bvh over the inflated bounds) equal."""
    jscene, scene = _both(wavy_sheet_obj(12), alpha=alpha)  # 288 faces: clusters
    t = scene.tris
    args = (t.v0.stack(np), (t.v0 + t.e1).stack(np), (t.v0 + t.e2).stack(np), t.n0.stack(np),
            t.n1.stack(np), t.n2.stack(np), alpha)
    for got, ref in zip(phongtess.phongtess_face_aabbs(*args), J.phongtess_face_aabbs(*args)):
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    q = phongtess._tess_point(*args[:6], np.float32(alpha), np.float32(0.3), np.float32(0.2))
    assert q.tobytes() == J._tess_point(*args[:6], np.float32(alpha), np.float32(0.3),
                                        np.float32(0.2)).tobytes()
    for name in ("bb_min", "bb_max"):
        for c in "xyz":
            for a, b in ((scene.bvh, jscene.bvh), (scene.clusters, jscene.clusters)):
                assert getattr(getattr(a, name), c).tobytes() == \
                    getattr(getattr(b, name), c).tobytes()
    np.testing.assert_array_equal(scene.bvh.leaf_first, jscene.bvh.leaf_first)
    np.testing.assert_array_equal(scene.tris.v0.x, jscene.tris.v0.x)
    assert scene.forest is None


# ---- the searches --------------------------------------------------------------

@pytest.mark.parametrize("obj, n", [(BUMPY, 2000), (wavy_sheet_obj(), 4096)])
def test_brute_and_bvh_match_numpy(obj, n):
    jscene, scene = _both(obj)
    o, d = sheet_rays(n, 5) if "sheet" in obj else _patch_rays(n, 5)
    ts = to_torch(scene, "cpu")
    with np.errstate(all="ignore"):
        ref_b = J.intersect_brute_phongtess(np, JVec3(*o), JVec3(*d), jscene.tris,
                                            np.float32(ALPHA))
        ref_w = J.intersect_bvh_phongtess(np, JVec3(*o), JVec3(*d), jscene.bvh, jscene.tris,
                                          np.float32(ALPHA))
    got_b = phongtess.intersect_brute_phongtess(_t3(o), _t3(d), ts.tris, ALPHA)
    got_w = phongtess.intersect_bvh_phongtess(_t3(o), _t3(d), ts.bvh, ts.tris, ALPHA)
    _assert_hits_close(got_b, ref_b)
    _assert_hits_close(got_w, ref_w)
    # The walk over inflated bounds finds what the sweep finds.
    for a, b in zip(got_w, got_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _cluster_setup(n: int, seed: int):
    jscene, scene = _both(wavy_sheet_obj(12))
    assert scene.clusters is not None
    return jscene, to_torch(scene, "cpu"), sheet_rays(n, seed)


@pytest.mark.parametrize("with_alive", [False, True])
def test_cluster_search_matches_jax(with_alive):
    """Against jnp's intersect_clusters_phongtess (tile 64); dead lanes
    report -1 and change nothing else."""
    jscene, ts, (o, d) = _cluster_setup(512, 3)
    alive = (np.arange(512) % 4) != 0 if with_alive else None
    js = jax.tree_util.tree_map(jnp.asarray, jscene)
    ref = [np.asarray(a) for a in J.intersect_clusters_phongtess(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), js.clusters, js.tris,
        np.float32(ALPHA), tile=64, alive=None if alive is None else jnp.asarray(alive))]
    got = [a.numpy() for a in phongtess.intersect_clusters_phongtess(
        _t3(o), _t3(d), ts.clusters, ts.tris, ALPHA, tile=64,
        alive=None if alive is None else torch.tensor(alive))]
    agree = got[0] == ref[0]
    assert agree.mean() > 0.99, f"face agreement {agree.mean():.4f}"
    assert (got[0] >= 0).mean() > 0.15
    np.testing.assert_allclose(got[1][agree], ref[1][agree], atol=2e-3)
    np.testing.assert_allclose(got[2][agree], ref[2][agree], atol=2e-3)
    if with_alive:
        assert (got[0][~alive] == -1).all()
        full = phongtess.intersect_clusters_phongtess(_t3(o), _t3(d), ts.clusters, ts.tris,
                                                      ALPHA, tile=64)
        for a, b in zip(got, full):
            np.testing.assert_array_equal(a[alive], b.numpy()[alive])


@pytest.mark.parametrize("capped", [False, True])
def test_candidates_fine_match_jax(capped):
    """Integer outputs bitwise equal to jnp's (its argsort is stable, as
    the port's); entry bounds within 1e-6."""
    jscene, ts, (o, d) = _cluster_setup(1024, 7)
    tile = 128
    cap = np.random.default_rng(3).uniform(0.2, 3.0, 8).astype(np.float32) if capped else None
    js = jax.tree_util.tree_map(jnp.asarray, jscene)
    ref = [np.asarray(a) for a in jcull.candidates_fine(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), js.clusters, tile,
        t_cap=None if cap is None else jnp.asarray(cap))]
    got = [a.numpy() for a in cull.candidates_fine(
        _t3(o), _t3(d), ts.clusters, tile, t_cap=None if cap is None else torch.tensor(cap))]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=1e-6)
    assert got[1].max() < ts.clusters.count  # the padding clusters are never listed
    assert capped or got[1].min() > 0


def test_dispatch_at_4608_rays(monkeypatch):
    """Under the JAX package's threshold (CLUSTER_MIN_RAYS 4,096,
    pbr_tpu/ops/phongtess.py:496) the dispatch takes the cluster search at
    4,608 rays, the BVH walk at 4,095, the sweep without a BVH; each
    matches the NumPy form's BVH walk. Under the card's band (the module's
    value) 4,608 rays take K10 only from its threshold, K9 otherwise, with
    the same faces."""
    jscene, scene = _both(wavy_sheet_obj(12))
    ts = to_torch(scene, "cpu")
    band = phongtess.CLUSTER_MIN_RAYS
    monkeypatch.setattr(phongtess, "CLUSTER_MIN_RAYS", 4096)
    taken = []
    for name in ("intersect_clusters_phongtess", "intersect_bvh_phongtess",
                 "intersect_brute_phongtess"):
        real = getattr(phongtess, name)
        monkeypatch.setattr(phongtess, name, lambda *a, _r=real, _n=name, **k: (
            taken.append(_n), _r(*a, **k))[1])
    o, d = sheet_rays(4608, 9)
    with np.errstate(all="ignore"):
        ref = J.intersect_scene_phongtess(np, JVec3(*o), JVec3(*d), jscene, np.float32(ALPHA))
    got = phongtess.intersect_scene_phongtess(_t3(o), _t3(d), ts.tris, ALPHA, bvh=ts.bvh,
                                              clusters=ts.clusters)
    assert taken == ["intersect_clusters_phongtess"]
    _assert_hits_close(got, ref, uv=False)
    cut = slice(0, 4095)
    sub = lambda a: Vec3(*(torch.tensor(c[cut]) for c in a))  # noqa: E731
    got_w = phongtess.intersect_scene_phongtess(sub(o), sub(d), ts.tris, ALPHA, bvh=ts.bvh,
                                                clusters=ts.clusters)
    got_b = phongtess.intersect_scene_phongtess(sub(o), sub(d), ts.tris, ALPHA)
    assert taken[1:] == ["intersect_bvh_phongtess", "intersect_brute_phongtess"]
    for a, b in zip(got_w, got_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _assert_hits_close(got_w, [a[cut] for a in ref], uv=False)
    monkeypatch.setattr(phongtess, "CLUSTER_MIN_RAYS", band)
    del taken[:]
    got_band = phongtess.intersect_scene_phongtess(_t3(o), _t3(d), ts.tris, ALPHA, bvh=ts.bvh,
                                                   clusters=ts.clusters)
    k10 = band is not None and 4608 >= band
    assert taken == ["intersect_clusters_phongtess" if k10 else "intersect_bvh_phongtess"]
    assert (got_band[1] == got[1]).float().mean() > 0.999


def test_cluster_search_is_independent_of_the_chunk():
    """Results are per ray: chunks of 128, 384 and 1,024 rays and one chunk
    give the same faces and patch coordinates, bitwise."""
    _, ts, (o, d) = _cluster_setup(4608, 11)
    alive = torch.tensor(np.random.default_rng(2).random(4608) < 0.8)
    outs = [phongtess.intersect_clusters_phongtess(_t3(o), _t3(d), ts.clusters, ts.tris, ALPHA,
                                                   alive=alive, chunk_rays=chunk)
            for chunk in (128, 384, 1024, phongtess.PHONG_CHUNK_RAYS)]
    assert phongtess.PHONG_CHUNK_RAYS % 128 == 0
    for out in outs[:-1]:
        for a, b in zip(out, outs[-1]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (outs[-1][0] >= 0).float().mean() > 0.15
