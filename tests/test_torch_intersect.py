"""Kernel K1's module (pbr_tpu_torch/ops/cuda_intersect.py) and the
brute-force dispatch, against the JAX package.

On the CPU the wrapper runs the kernel's plain version; the tests hold it
to ``pbr_tpu.ops.traverse.intersect_brute`` (NumPy) bitwise and to the
Pallas kernel in interpret mode with the tolerances of
tests/test_pallas_intersect.py. The kernel itself runs only on a card:
``test_kernel_matches_plain_on_card`` is marked ``cuda`` and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops.pallas_intersect import intersect_pallas
from pbr_tpu.ops.traverse import intersect_brute
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text
from pbr_tpu.scene.procedural import cornell_box, random_soup
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import traverse as tt
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch

LIGHT = (0.0, 1.8, 0.2)  # inside the box, near the ceiling


def _scene(kind="cornell"):
    if kind == "cornell":
        obj, mtl, li = cornell_box()
    else:
        obj, mtl, li = random_soup(300, seed=1), "", ""
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
    before = ci.launches
    yield
    assert ci.launches == before  # CPU tensors never launch the kernel


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
    dev = torch.device("cpu")
    assert tt.resolve_mode("auto", dev) == "brute"
    assert tt.resolve_mode("auto", torch.device("cuda")) == "pallas"
    assert tt.resolve_mode("pallas", dev) == "pallas"
    assert tt.resolve_mode("brute", dev) == "brute"
    with pytest.raises(ValueError, match="'auto' or 'pallas'"):
        tt.resolve_mode("brute", torch.device("cuda"))
    for mode in ("bvh", "gemm", "gated", "cull", "sweep", "pallas_bvh",
                 "pallas_bvh_forest", "pallas_bvh_hbm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tt.resolve_mode(mode, dev)
    with pytest.raises(ValueError):
        tt.resolve_mode("nonsense", dev)


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
    t, f, occ, tests = out
    assert torch.equal(f, f_sweep) and torch.equal(t, t_sweep)
    nf = scene.tris.count
    if mode == "brute":
        assert occ is None and torch.all(tests == nf)
    else:
        assert occ is not None and torch.all(tests == 2 * nf)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K1 against its plain version on the card: t, face and occluded
    bitwise equal (both round every operation the same way: the kernel is
    built with --fmad=false), over a ragged ray count and several
    shared-memory chunks of faces."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel K1 has no CPU mode")
    for kind, n in (("cornell", 100_003), ("soup", 4_097)):
        obj, mtl, li = cornell_box() if kind == "cornell" else (random_soup(1500), "", "")
        scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
        tris = to_torch(scene, "cuda").tris
        o, d = (_t3(a, "cuda") for a in _rays(n=n))
        before = ci.launches
        t, f, occ = ci.intersect_fused(o, d, tris, light_pos=_light("cuda"))
        t1, f1 = ci.intersect_fused(o, d, tris)
        torch.cuda.synchronize()
        assert ci.launches == before + 2
        tp, fp, op = ci.intersect_fused_plain(o, d, ci.face_table(tris),
                                              torch.tensor(LIGHT, device="cuda"))
        for a, b in ((t, tp), (f, fp), (occ, op), (t1, tp), (f1, fp)):
            assert torch.equal(a, b)
        ci.launches = before  # the autouse check counts CPU launches only
