"""The ``gemm`` intersect mode of the port (pbr_tpu_torch/ops/gemm_intersect.py)
against the JAX package's ``intersect_gemm`` (NumPy) and the port's brute
sweep, and a ``gemm`` frame against the JAX package's.

The face gate is tests/test_intersectors.py's: the product reassociates the
float32 sums, so a rare grazing hit flips; faces agree on more than 99.5%
of rays and t within 1e-4 where they do. The frame gate is the repo's: at
least 99% of pixels within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops.gemm_intersect import intersect_gemm as jax_gemm
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.scene.procedural import cornell_box, multi_room
from pbr_tpu.utils.config import RenderSettings
from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import gemm_intersect as gi
from pbr_tpu_torch.ops import traverse as tt
from pbr_tpu_torch.ops.vec import Vec3

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)


def _rays(n, seed=0):
    """tests/test_intersectors.py::_rays: origins in a box around the
    scene, directions on the sphere."""
    r = np.random.RandomState(seed)
    o = r.uniform(-2, 3, size=(3, n)).astype(np.float32)
    d = r.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _t3(a):
    return Vec3(*(torch.tensor(c) for c in a))


@functools.lru_cache(maxsize=None)
def _scene(kind):
    src = cornell_box() if kind == "cornell" else multi_room()
    return scene_from_text(*src, use_bvh=kind != "cornell")[0]


def _agree(t, f, t_ref, f_ref):
    agree = f == f_ref
    assert agree.mean() > 0.995, agree.mean()
    m = agree & np.isfinite(t_ref)
    np.testing.assert_allclose(t[m], t_ref[m], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["cornell", "multiroom"])
def test_gemm_matches_jax_gemm_and_brute(kind):
    """50,000 rays: the port's faces against the JAX package's NumPy
    ``intersect_gemm`` and against the port's brute sweep."""
    scene = _scene(kind)
    o, d = _rays(50_000)
    with np.errstate(all="ignore"):
        t_j, f_j = jax_gemm(np, JVec3(*o), JVec3(*d), scene.tris)
    tris = to_torch(scene, "cpu").tris
    t, f = (x.numpy() for x in gi.intersect_gemm(_t3(o), _t3(d), tris))
    assert f.dtype == np.int32 and t.dtype == np.float32
    _agree(t, f, t_j, f_j)
    t_b, f_b = (x.numpy() for x in tt.intersect_brute(_t3(o), _t3(d), tris))
    _agree(t, f, t_b, f_b)
    assert ((f >= 0) == np.isfinite(t)).all()


def _budget(monkeypatch, rays, nf):
    """Sets the byte budget so that a chunk is ``rays`` rays of ``nf`` faces."""
    monkeypatch.setattr(gi, "GEMM_BUDGET_BYTES", rays * 16 * nf)
    assert gi.chunk_rays(nf) == rays


def test_chunks_are_bitwise_and_within_budget(monkeypatch):
    """The rays go through the product a chunk at a time: any chunk gives
    the same answer bitwise, and the default chunk keeps the (B, 4F)
    product within the byte budget."""
    scene = _scene("multiroom")
    tris = to_torch(scene, "cpu").tris
    o, d = _t3(_rays(5_000, seed=1)[0]), _t3(_rays(5_000, seed=1)[1])
    nf = scene.tris.count
    c = gi.chunk_rays(nf)
    assert c % gi.CHUNK_ALIGN == 0 and c * 16 * nf <= gi.GEMM_BUDGET_BYTES
    assert (c + gi.CHUNK_ALIGN) * 16 * nf > gi.GEMM_BUDGET_BYTES
    assert gi.chunk_rays(34) == gi.GEMM_BUDGET_BYTES // (16 * 34) // 1024 * 1024
    assert gi.chunk_rays(10**9) == gi.CHUNK_ALIGN  # never less than one aligned chunk
    _budget(monkeypatch, 5 * 1024, nf)
    whole = gi.intersect_gemm(o, d, tris)
    for rays in (1024, 2048, 3072):
        _budget(monkeypatch, rays, nf)
        got = gi.intersect_gemm(o, d, tris)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


def test_product_runs_without_tf32_and_restores_the_setting(monkeypatch):
    """The wrapper turns TF32 off for the product and gives the caller's
    setting back, also when the call raises."""
    matmul = torch.backends.cuda.matmul
    seen = []
    real = gi._nearest

    def spy(*args):
        seen.append(matmul.allow_tf32)
        return real(*args)

    monkeypatch.setattr(gi, "_nearest", spy)
    scene = _scene("cornell")
    tris = to_torch(scene, "cpu").tris
    o, d = _rays(3000, seed=2)
    _budget(monkeypatch, 1024, scene.tris.count)
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        gi.intersect_gemm(_t3(o), _t3(d), tris)
        assert seen == [False] * 3 and matmul.allow_tf32 is True
        monkeypatch.setattr(gi, "_nearest", lambda *a: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            gi.intersect_gemm(_t3(o), _t3(d), tris)
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = saved


@pytest.mark.skipif(not hasattr(torch.backends.cuda.matmul, "fp32_precision"),
                    reason="this torch has no fp32_precision switch")
def test_newer_precision_switch_raises_rather_than_run_in_tf32():
    """A caller who asked for TF32 through torch's newer ``fp32_precision``
    switch gets torch's RuntimeError from the call (torch refuses to read
    the legacy flag then), never a TF32 product; with "ieee" the call runs."""
    matmul = torch.backends.cuda.matmul
    tris = to_torch(_scene("cornell"), "cpu").tris
    o, d = _rays(500, seed=7)
    t_b, f_b = tt.intersect_brute(_t3(o), _t3(d), tris)
    saved = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        with pytest.raises(RuntimeError, match="legacy and new APIs"):
            gi.intersect_gemm(_t3(o), _t3(d), tris)
        matmul.fp32_precision = "ieee"
        _, f = gi.intersect_gemm(_t3(o), _t3(d), tris)
        assert matmul.fp32_precision == "ieee"
        assert (f == f_b).float().mean() > 0.995
    finally:
        matmul.fp32_precision = saved


def test_dispatch_runs_gemm():
    """'gemm' resolves on either device and 'auto' never picks it; through
    ``intersect_scene`` it has no fused shadow leg (``occluded`` None, so
    the integrator casts its shadow rays through ``occluded_scene``) and
    counts F tests a ray."""
    for dev in (torch.device("cpu"), torch.device("cuda")):
        assert tt.resolve_mode("gemm", dev) == "gemm"
        assert tt.resolve_mode("auto", dev, 34) != "gemm"
    scene = _scene("cornell")
    tris = to_torch(scene, "cpu").tris
    o, d = _rays(2000, seed=3)
    light = _t3(np.array([[0.0], [1.8], [0.2]], dtype=np.float32)[:, 0])
    t, f, occ, (tests, visits) = tt.intersect_scene(_t3(o), _t3(d), tris, mode="gemm",
                                                    light_pos=light, with_counts=True)
    assert occ is None and visits is None
    assert (tests == scene.tris.count).all()
    t_b, f_b = tt.intersect_scene(_t3(o), _t3(d), tris, mode="brute")
    assert (f == f_b).float().mean() > 0.995
    lim = torch.full_like(t, 1.5)
    occ_g = tt.occluded_scene(_t3(o), _t3(d), lim, tris, mode="gemm")
    assert (occ_g == (t_b < lim)).float().mean() > 0.995


def test_gemm_frame_matches_jax_gemm_frame():
    """A 16² Cornell frame with intersector='gemm' (NEE through the
    separate shadow search) against the JAX package's 'gemm' frame."""
    scene = _scene("cornell")
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(width=16, height=16, samples=1, max_depth=3, max_added_depth=2,
                              shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
                              intersector="gemm", no_transparency=True)
    ids = torch.arange(256, dtype=torch.int32)
    got = trace_rays(to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"), settings, ids,
                     4).color.stack().numpy()
    tree = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    f = jax.jit(functools.partial(jax_integrator.trace_rays, jnp),
                static_argnames=("settings",))
    res = f(tree(scene), tree(cam), settings=settings, pixel_ids=jnp.arange(256, dtype=jnp.int32),
            frame_seed=jnp.uint32(4))
    ref = np.stack([np.asarray(res.color.x), np.asarray(res.color.y),
                    np.asarray(res.color.z)], -1)
    assert np.isfinite(got).all() and got.mean() > 0.05
    within = (np.abs(got - ref).max(axis=-1) <= 1e-3).mean()
    assert within >= 0.99, within


@pytest.mark.cuda
def test_gemm_on_card_is_full_float32_and_matches_k1(monkeypatch):
    """On the card: the product ignores a caller's TF32 setting (the answer
    is bitwise the same with TF32 asked for, and the setting comes back),
    and the faces agree with K1's nearest instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the product's precision is cuBLAS's on the card")
    from pbr_tpu_torch.ops import cuda_intersect as ci

    scene = _scene("multiroom")
    tris = to_torch(scene, "cuda").tris
    o, d = (Vec3(*(torch.tensor(c, device="cuda") for c in a)) for a in _rays(200_000, seed=6))
    _budget(monkeypatch, 65_536, scene.tris.count)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = False
        t, f = gi.intersect_gemm(o, d, tris)
        matmul.allow_tf32 = True
        t32, f32 = gi.intersect_gemm(o, d, tris)
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = saved
    assert torch.equal(t, t32) and torch.equal(f, f32)
    t_k, f_k = ci.intersect_fused(o, d, tris)
    _agree(t.cpu().numpy(), f.cpu().numpy(), t_k.cpu().numpy(), f_k.cpu().numpy())
