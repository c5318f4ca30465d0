"""Kernels K1 and K2's module (pbr_tpu_torch/ops/cuda_intersect.py) and
the intersect dispatch, against the JAX package.

On the CPU the wrapper runs the kernels' plain versions; the tests hold
K1's to ``pbr_tpu.ops.traverse.intersect_brute`` (NumPy) bitwise, and both
to the Pallas kernel in interpret mode (``variant='mt'`` and ``'lin'``)
with the tolerances of tests/test_pallas_intersect.py. The kernels
themselves run only on a card: ``test_kernel_matches_plain_on_card`` is
marked ``cuda`` and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops.pallas_intersect import _lin_table, intersect_pallas
from pbr_tpu.ops.traverse import intersect_brute
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text
from pbr_tpu.scene.procedural import cornell_box, multi_room, random_soup
from pbr_tpu_torch.ops import cuda_gated as cg
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import traverse as tt
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine (measured: a
# 3 s test took 180 s with four workers).
torch.set_num_threads(1)

LIGHT = (0.0, 1.8, 0.2)  # inside the box, near the ceiling


def _scene(kind="cornell", n_soup=300):
    if kind == "cornell":
        obj, mtl, li = cornell_box()
    else:
        obj, mtl, li = random_soup(n_soup, seed=1), "", ""
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    return scene


def _rays(n=1024, seed=3):
    """Origins inside the box, directions on the sphere (NumPy-seeded)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.8, 0.8, (3, n)).astype(np.float32)
    o[1] += 1.0
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _t3(a, device="cpu"):
    return Vec3(*(torch.tensor(c, device=device) for c in a))


def _light(device="cpu"):
    return Vec3(*(torch.tensor(v, dtype=torch.float32, device=device) for v in LIGHT))


@pytest.fixture(autouse=True)
def _no_cuda_launch_counted():
    before = dict(ci.launches), dict(cg.launches)
    yield
    assert (ci.launches, cg.launches) == before  # CPU tensors never launch a kernel


@pytest.mark.parametrize("kind", ["cornell", "soup"])
@pytest.mark.parametrize("plain_elems", [1 << 24, 1024 * 7])
def test_plain_matches_numpy_brute_bitwise(kind, plain_elems, monkeypatch):
    """The plain sweep equals the NumPy sweep bitwise, whether it takes the
    faces in one chunk or in several (7 faces a step at 1024 rays)."""
    monkeypatch.setattr(ci, "_PLAIN_ELEMS", plain_elems)
    scene = _scene(kind)
    o, d = _rays()
    with np.errstate(all="ignore"):
        t_ref, f_ref = intersect_brute(np, JVec3(*o), JVec3(*d), scene.tris)
    ts = to_torch(scene, "cpu")
    t, f = ci.intersect_fused(_t3(o), _t3(d), ts.tris)
    np.testing.assert_array_equal(f.numpy(), f_ref)
    np.testing.assert_array_equal(t.numpy(), t_ref)
    assert (f_ref >= 0).sum() > 50  # the rays do hit something


def test_plain_matches_pallas_interpret():
    """Nearest and fused-NEE legs against the Pallas kernel in interpret
    mode: face equal, t within 1e-6, occluded agreeing on >= 99.9%."""
    scene = _scene()
    o, d = _rays()
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    lp = JVec3(*(jnp.float32(v) for v in LIGHT))
    t_p, f_p, occ_p = intersect_pallas(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), jscene.tris,
        light_pos=lp, interpret=True, variant="mt",
    )
    ts = to_torch(scene, "cpu")
    t, f, occ = ci.intersect_fused(_t3(o), _t3(d), ts.tris, light_pos=_light())
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_p))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_p), rtol=1e-6, atol=1e-6)
    agree = (occ.numpy() == np.asarray(occ_p)).mean()
    assert agree >= 0.999, f"occlusion agreement {agree}"
    assert 0 < occ.numpy().mean() < 1


@pytest.mark.parametrize("kind", ["cornell", "soup"])
def test_lin_table_matches_numpy_bitwise(kind):
    """K2's (16, F) table equals ``_lin_table`` built with NumPy."""
    scene = _scene(kind)
    ref = _lin_table(np, scene.tris)
    np.testing.assert_array_equal(ci.lin_table(to_torch(scene, "cpu").tris).numpy(), ref)


@pytest.mark.parametrize("kind", ["cornell", "soup"])
@pytest.mark.parametrize("nee", [False, True])
def test_lin_plain_matches_pallas_interpret(kind, nee):
    """K2's plain version (``variant='lin'``) against the Pallas kernel's
    linear form in interpret mode, nearest and fused NEE: faces equal, t
    within 1e-6 (XLA on the CPU may round the regrouped dot products
    differently), occluded agreeing on >= 99.9%. A 64-face soup keeps the
    unrolled interpret program small."""
    scene = _scene(kind, n_soup=64)
    o, d = _rays(seed=5)
    if kind == "soup":
        o[1] -= 1.0  # the soup sits around the origin
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    lp = JVec3(*(jnp.float32(v) for v in LIGHT)) if nee else None
    ref = intersect_pallas(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), jscene.tris,
        light_pos=lp, interpret=True, variant="lin",
    )
    got = ci.intersect_fused(_t3(o), _t3(d), to_torch(scene, "cpu").tris,
                             light_pos=_light() if nee else None, variant="lin")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    assert (got[1] >= 0).sum() > 20
    if nee:
        agree = (got[2].numpy() == np.asarray(ref[2])).mean()
        assert agree >= 0.999, f"occlusion agreement {agree}"


def test_lin_and_classic_forms_agree():
    """K2 and K1 compute the same quotients in another grouping: their
    faces agree except where f32 rounding flips an edge or a tie (>= 99.9%
    of 4,096 rays on the 300-face soup), and t agrees to rtol 1e-4 (the
    tolerance of tests/test_gated.py: the regrouped dot products round
    differently)."""
    tris = to_torch(_scene("soup"), "cpu").tris
    o, d = _rays(n=4096, seed=2)
    o[1] -= 1.0
    t_m, f_m = ci.intersect_fused(_t3(o), _t3(d), tris)
    t_l, f_l = ci.intersect_fused(_t3(o), _t3(d), tris, variant="lin")
    assert (f_m == f_l).float().mean() >= 0.999
    both = (f_m == f_l) & (f_m >= 0)
    assert both.sum() > 200
    np.testing.assert_allclose(t_l[both].numpy(), t_m[both].numpy(), rtol=1e-4)
    with pytest.raises(ValueError, match="variant"):
        ci.intersect_fused(_t3(o), _t3(d), tris, variant="gemm")


def test_fused_occlusion_matches_separate_shadow_sweep():
    """The fused leg equals the integrator's separate shadow test (a second
    nearest-hit sweep from the guarded hit point, t_sh < t_light)."""
    scene = _scene()
    o, d = _rays(seed=9)
    tris = to_torch(scene, "cpu").tris
    t, f, occ = ci.intersect_fused(_t3(o), _t3(d), tris, light_pos=_light())
    hit_p, s_dir, t_light = ci._shadow_ray(_t3(o), _t3(d), t, torch.tensor(LIGHT))
    t_sh, _ = tt.intersect_brute(hit_p, s_dir, tris)
    assert torch.equal(occ, t_sh < t_light)


def test_miss_is_inf_and_minus_one():
    scene = _scene()
    o, d = _rays(n=64)
    o = o + 100.0
    d = np.zeros_like(d)
    d[1] = 1.0
    t, f = ci.intersect_fused(_t3(o), _t3(d), to_torch(scene, "cpu").tris)
    assert torch.all(t == float("inf")) and torch.all(f == -1)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tris = to_torch(_scene(), "cpu").tris
    o, d = _rays(n=16)
    with pytest.raises(ValueError, match="float32"):
        ci.intersect_fused(_t3(o.astype(np.float64)), _t3(d), tris)
    with pytest.raises(ValueError, match="one shape"):
        ci.intersect_fused(_t3(o[:, :8]), _t3(d), tris)
    bad = Vec3(torch.tensor(o[0]).reshape(4, 4), *_t3(o)[1:])
    with pytest.raises(ValueError):
        ci.intersect_fused(bad, _t3(d), tris)
    with pytest.raises(ValueError, match=r"\(3,\)"):
        ci.intersect_fused(_t3(o), _t3(d), tris,
                           light_pos=Vec3(*(torch.zeros(2) for _ in range(3))))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ci, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        ci.build()
    assert not (tmp_path / "build").exists()


def test_dispatch_modes():
    dev, cuda = torch.device("cpu"), torch.device("cuda")
    assert tt.resolve_mode("auto", dev) == "brute"
    assert tt.resolve_mode("auto", cuda) == "pallas"
    # The gated band of the H100's band table, on either device: clusters
    # and 1,025 < F <= 12,288 (multiroom has 1,428 faces).
    for device in (dev, cuda):
        assert tt.resolve_mode("auto", device, 1428, True) == "gated"
        assert tt.resolve_mode("auto", device, 12_288, True) == "gated"
    assert tt.resolve_mode("auto", dev, 1025, True) == "brute"
    assert tt.resolve_mode("auto", cuda, 1025, True) == "pallas"
    assert tt.resolve_mode("auto", cuda, 1428, False) == "pallas"
    # Above the band, clusters take the per-ray walk (K8), on either device.
    for device in (dev, cuda):
        assert tt.resolve_mode("auto", device, 12_289, True, True) == "bvh"
    assert tt.resolve_mode("auto", cuda, 12_289, False) == "pallas"
    assert tt.resolve_mode("pallas", dev) == "pallas"
    assert tt.resolve_mode("brute", dev) == "brute"
    assert tt.resolve_mode("gated", cuda) == "gated"
    assert tt.resolve_mode("cull", cuda) == "cull"
    for mode in ("bvh", "pallas_bvh", "pallas_bvh_forest", "pallas_bvh_hbm"):
        assert tt.resolve_mode(mode, dev) == tt.resolve_mode(mode, cuda) == mode
    # The tree band, on either device: no clusters and F > 10,000 walk the
    # forest if there is one, else the BVH; K1 keeps a scene with neither,
    # and every scene of at most 10,000 faces.
    for device in (dev, cuda):
        assert tt.resolve_mode("auto", device, 10_001, False, True, True) == "pallas_bvh_forest"
        assert tt.resolve_mode("auto", device, 10_001, False, True, False) == "bvh"
        assert tt.resolve_mode("auto", device, 12_289, True, True, True) == "bvh"
    assert tt.resolve_mode("auto", cuda, 10_000, False, True, True) == "pallas"
    assert tt.resolve_mode("auto", dev, 10_000, False, True, False) == "brute"
    with pytest.raises(ValueError, match="'auto' or 'pallas'"):
        tt.resolve_mode("brute", cuda)
    assert tt.resolve_mode("sweep", dev) == tt.resolve_mode("sweep", cuda) == "sweep"
    # 'gemm' (the sweep as a matrix product) resolves on either device and
    # runs: its faces are the brute sweep's on all but grazing rays.
    assert tt.resolve_mode("gemm", dev) == tt.resolve_mode("gemm", cuda) == "gemm"
    tris = to_torch(_scene(), "cpu").tris
    o, d = _rays(n=2048, seed=5)
    _, f_g = tt.intersect_scene(_t3(o), _t3(d), tris, mode="gemm")
    _, f_b = tt.intersect_scene(_t3(o), _t3(d), tris, mode="brute")
    assert (f_g == f_b).float().mean() > 0.995
    with pytest.raises(ValueError):
        tt.resolve_mode("nonsense", dev)


def test_gated_without_clusters_raises():
    tris = to_torch(_scene(), "cpu").tris
    o, d = _rays(n=64)
    with pytest.raises(ValueError, match="clusters"):
        tt.intersect_scene(_t3(o), _t3(d), tris, mode="gated")


@pytest.mark.parametrize("nee", [False, True])
def test_intersect_scene_gated_on_multiroom(nee):
    """``auto`` on multiroom (1,428 faces, 32 clusters) runs the gated
    sweep: faces equal the full linear-form sweep's (K2's plain version)
    on live lanes and K1's on >= 99% of them (the forms round differently
    at the shared edges of multiroom's boxes), dead lanes miss, the
    re-evaluated t equals the classic form's, and the counts are the gated
    sweep's executed tests."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    ts = to_torch(scene, "cpu")
    rs = np.random.default_rng(4)
    n = 1000
    o = np.stack([rs.uniform(-2.8, 2.8, n), rs.uniform(0.1, 1.9, n),
                  rs.uniform(-4.8, 0.8, n)]).astype(np.float32)
    d = rs.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    alive = torch.tensor(np.arange(n) % 4 != 0)
    light = Vec3(*(torch.tensor(v, dtype=torch.float32) for v in (0.0, 1.75, 0.0)))
    out = tt.intersect_scene(_t3(o), _t3(d), ts.tris, light_pos=light if nee else None,
                             alive=alive, clusters=ts.clusters, with_counts=True)
    t, f = out[0], out[1]
    ref = cg.intersect_gated(_t3(o), _t3(d), ts.tris, ts.clusters,
                             light_pos=light if nee else None, alive=alive, with_counts=True)
    t_k1, f_k1 = ci.intersect_fused(_t3(o), _t3(d), ts.tris)
    _, f_k2 = ci.intersect_fused(_t3(o), _t3(d), ts.tris, variant="lin")
    assert torch.equal(f, ref[1]) and torch.equal(out[-1][0], ref[-1])
    assert out[-1][1] is None  # a sweep visits no nodes
    assert torch.equal(f[alive], f_k2[alive])
    assert (f[alive] == f_k1[alive]).float().mean() >= 0.99
    assert torch.all(f[~alive] == -1) and torch.all(t[~alive] == float("inf"))
    same = alive & (f == f_k1)
    assert torch.equal(t[same], t_k1[same])  # the winner is re-evaluated classically
    if nee:
        assert torch.equal(out[2], ref[2])
    assert 0 < int(out[-1][0].max()) <= (2 if nee else 1) * scene.tris.count


@pytest.mark.parametrize("mode", ["brute", "pallas"])
def test_intersect_scene_reeval_and_counts(mode):
    """The differentiable re-evaluation gives back the sweep's t exactly;
    the counts are F per ray, 2F with the fused shadow leg."""
    scene = _scene()
    tris = to_torch(scene, "cpu").tris
    o, d = _rays()
    t_sweep, f_sweep = ci.intersect_fused(_t3(o), _t3(d), tris)
    out = tt.intersect_scene(_t3(o), _t3(d), tris, mode=mode, light_pos=_light(),
                             with_counts=True)
    t, f, occ, (tests, visits) = out
    assert torch.equal(f, f_sweep) and torch.equal(t, t_sweep) and visits is None
    nf = scene.tris.count
    if mode == "brute":
        assert occ is None and torch.all(tests == nf)
    else:
        assert occ is not None and torch.all(tests == 2 * nf)


def _ceiling_first(tris, device):
    """``tris`` after a ceiling: face 0 is one large triangle in the plane
    y = 5, between every point of the box and a light at (0, 10, 0)."""
    def cat(v, first):
        return Vec3(*(torch.cat([torch.tensor([f], dtype=torch.float32, device=device), c])
                      for f, c in zip(first, v)))

    return tris._replace(v0=cat(tris.v0, (-1e3, 5.0, -1e3)), e1=cat(tris.e1, (4e3, 0.0, 0.0)),
                         e2=cat(tris.e2, (0.0, 0.0, 4e3)), n0=cat(tris.n0, (0.0, -1.0, 0.0)),
                         n1=cat(tris.n1, (0.0, -1.0, 0.0)), n2=cat(tris.n2, (0.0, -1.0, 0.0)),
                         mtl=torch.cat([tris.mtl[:1], tris.mtl]))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K1 and K2 against their plain versions on the card: t, face and
    occluded bitwise equal (both round every operation the same way: the
    kernel is built with --fmad=false), over a ragged ray count, face
    counts on both sides of the kernels' staged chunk (256 faces) and of
    twice it, and a scene whose every shadow ray is occluded by face 0
    with more than a chunk of faces after it (the blocks leave the shadow
    leg early)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel K1 has no CPU mode")
    cases = [(_scene("cornell"), 100_003, LIGHT, False)]
    cases += [(_scene("soup", nf), 4_097, LIGHT, False)
              for nf in (1500, 1, 255, 256, 257, 511, 512, 513)]
    cases.append((_scene("soup", 600), 4_097, (0.0, 10.0, 0.0), True))
    for scene, n, light, occluded in cases:
        tris = to_torch(scene, "cuda").tris
        o, d = _rays(n=n)
        if occluded:
            tris = _ceiling_first(tris, "cuda")
            d[1] = -np.abs(d[1])  # no hit point on the ceiling
        o, d = _t3(o, "cuda"), _t3(d, "cuda")
        lp = Vec3(*(torch.tensor(v, dtype=torch.float32, device="cuda") for v in light))
        for variant, table in (("mt", ci.face_table(tris)), ("lin", ci.lin_table(tris))):
            before = dict(ci.launches)
            t, f, occ = ci.intersect_fused(o, d, tris, light_pos=lp, variant=variant)
            t1, f1 = ci.intersect_fused(o, d, tris, variant=variant)
            torch.cuda.synchronize()
            assert sum(ci.launches.values()) == sum(before.values()) + 2
            tp, fp, op = ci.intersect_fused_plain(o, d, table,
                                                  torch.tensor(light, device="cuda"))
            for a, b in ((t, tp), (f, fp), (occ, op), (t1, tp), (f1, fp)):
                assert torch.equal(a, b)
            assert bool(occ.all()) or not occluded
            ci.launches.update(before)  # the autouse check counts CPU launches only
