"""Kernels K11 and K12 and their backward, K11 bwd and K12 bwd
(``pbr_tpu_torch/ops/cuda_shade.py``), on the card; skipped without one
(the kernels have no CPU mode). A file without JAX: the CPU tests against
the JAX package are tests/test_torch_shade.py, the plain adjoints' against
autograd tests/test_torch_shade_grad.py.

- A frame through the kernels (no autograd) is bitwise the same frame
  through the plain versions (the integrator's two wrappers swapped for
  ``gen_rays_plain`` and ``shade_plain``, which launch nothing) and the
  frame that autograd records (the scene's parameters and the camera
  requiring grad), which launches K11 and K12 forward and, in its
  backward, K11 bwd once and K12 bwd once a bounce.
- Each K12 bwd instance (BRDF x NEE x transparency x Phong) on random
  lanes of the Cornell box's glass table, of multiroom's and of the
  Cornell box with a smooth sphere under Phong tessellation against its
  plain adjoint, ``shade_vjp_plain``, on the card: the lanes' gradients
  bitwise, the table's within 1e-5 of the float64 sum of the terms'
  absolute values of their float64 sum (the kernel sums in its own
  order), and bitwise the same on a second launch; the same over a table
  of 600 materials, whose warp rows live in global memory;
  K11 bwd against ``gen_rays_vjp_plain``, depth of field off and on, the
  same way.
- The wrappers refuse a CUDA input of the wrong dtype, shape or device
  before any launch.

Run on the card: ``python -m pytest tests/test_torch_shade_card.py -m cuda``.
"""

import pytest
import torch

from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.models import integrator
from pbr_tpu_torch.ops import counts, cuda_shade, zero_counts
from pbr_tpu_torch.ops.cuda_shade import Hit, Lanes, ShadeConfig, ShadeScene
from pbr_tpu_torch.ops.rng import PixelRng
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.parallel.mesh import leaf_camera
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import cornell_box
from pbr_tpu_torch.utils.config import BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN, RenderSettings
from test_torch_shade_grad import random_bounce, shade_config, shade_scene, shade_tables

SETTINGS = RenderSettings(width=64, height=64, samples=1, max_depth=3, max_added_depth=5,
                          shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
                          no_transparency=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K11 and K12 have no CPU mode")
    return torch.device("cuda")


def _cornell(dev):
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    return to_torch(scene, dev), camera_to_torch(cam, dev)


@pytest.mark.cuda
def test_frame_through_the_kernels_is_the_grad_paths_frame(monkeypatch):
    dev = _card()
    ts, ct = _cornell(dev)
    ids = torch.arange(64 * 64, dtype=torch.int32, device=dev)
    bounces = SETTINGS.max_total_depth
    zero_counts()
    with torch.no_grad():
        got = trace_rays(ts, ct, SETTINGS, ids, 3)
    torch.cuda.synchronize()
    launched = counts()
    assert launched["K11"] == 1 and launched["K12"] == bounces
    zero_counts()
    with monkeypatch.context() as plain_shading, torch.no_grad():
        plain_shading.setattr(integrator, "gen_rays", cuda_shade.gen_rays_plain)
        plain_shading.setattr(integrator, "shade", cuda_shade.shade_plain)
        plain = trace_rays(ts, ct, SETTINGS, ids, 3)
    torch.cuda.synchronize()
    assert all(counts()[k] == 0 for k in SHADE)
    ts.requires_grad_()
    cam = leaf_camera(ct)
    zero_counts()
    ref = trace_rays(ts, cam, SETTINGS, ids, 3)
    sum(c.sum() for c in ref.color).backward()
    torch.cuda.synchronize()
    want = {"K11": 1, "K12": bounces, "K12 pre": 0, "K12 post": 0, "K11 bwd": 1,
            "K12 bwd": bounces}
    assert {k: counts()[k] for k in SHADE} == want
    assert torch.isfinite(ts.mat_kd.grad).all() and torch.isfinite(cam.eye.x.grad)
    for other in (plain, ref):
        for a, b in zip((*got.color, got.focus_t), (*other.color, other.focus_t)):
            assert torch.equal(a.view(torch.int32), b.detach().view(torch.int32))


SHADE = ("K11", "K12", "K12 pre", "K12 post", "K11 bwd", "K12 bwd")
BWD_CASES = [(scene, brdf, nee, trans) for scene in ("glass", "multiroom", "sphere", "wide")
             for brdf in (BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN)
             for nee in (True, False) for trans in (False, True)]
WIDE = 600  # materials: a block's 8 warp rows of 14 x 600 + 6 floats exceed its shared memory


def _wide(ts, dev):
    """The glass table's materials repeated to WIDE, each copy's colours
    scaled, and the faces' materials drawn from all of them."""
    mats, m0 = ts.materials, int(ts.mat_d.shape[0])
    reps = -(-WIDE // m0)
    k = torch.arange(reps * m0, device=dev)[:WIDE] // m0
    rep = lambda f: f.repeat(reps)[:WIDE].contiguous()  # noqa: E731
    tint = lambda v: Vec3(*(rep(c) * (1.0 - 0.0005 * k) for c in v))  # noqa: E731
    wide = mats._replace(**{f: rep(getattr(mats, f)) for f in
                            ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd", "light")},
                         kd=tint(mats.kd), ks=tint(mats.ks))
    gen = torch.Generator(device=dev).manual_seed(9)
    mtl = torch.randint(0, WIDE, ts.tri_mtl.shape, device=dev, generator=gen, dtype=torch.int32)
    return ShadeScene(ts.tris._replace(mtl=mtl), wide, ts.lights)


def _sums_close(what: str, got, ref, abs_sum) -> None:
    """A float32 sum of terms in some order within 1e-5 of the float64 sum
    of their absolute values of ``ref``, their float64 sum."""
    err = (got.double() - ref.double()).abs()
    assert torch.isfinite(got).all() and bool((err <= 1e-5 * abs_sum).all()), \
        (what, float((err / abs_sum.clamp_min(1e-30)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("scene, brdf, nee, trans", BWD_CASES,
                         ids=[f"{c[0]}-{'schlick' if c[1] == BRDF_SCHLICK else 'sa'}-"
                              f"nee{int(c[2])}-trans{int(c[3])}" for c in BWD_CASES])
def test_k12_bwd_matches_its_plain_adjoint(scene, brdf, nee, trans):
    dev = _card()
    ts = shade_tables("glass" if scene == "wide" else scene, dev)
    phong = scene == "sphere"
    cfg = shade_config(ts, brdf, nee, trans, phong)
    lanes, hit, rng, g = random_bounce(ts, n=1 << 16, dev=dev)
    sscene = _wide(ts, dev) if scene == "wide" else shade_scene(ts, phong)
    nm = int(sscene.materials.d.shape[0])
    with torch.no_grad():
        zero_counts()
        lane, g_t, table = cuda_shade.shade_bwd_launch(cfg, lanes, hit, rng, 0, 1, sscene, g)
        again = cuda_shade.shade_bwd_launch(cfg, lanes, hit, rng, 0, 1, sscene, g)
        torch.cuda.synchronize()
        assert counts()["K12 bwd"] == 2
        ref_lane, ref_t, terms = cuda_shade.shade_vjp_terms(cfg, lanes, hit, rng, 0, 1, sscene, g)
        ref = cuda_shade.table_sum(terms, nm, ts.lights.count, torch.float64)
        t64 = terms._replace(mat=terms.mat.abs(), pos=terms.pos.abs(), rgb=terms.rgb.abs())
        abs_sum = cuda_shade.table_sum(t64, nm, ts.lights.count, torch.float64)
    mine = [c for v in lane for c in v] + [g_t]
    for i, (a, b) in enumerate(zip(mine, [c for v in ref_lane for c in v] + [ref_t])):
        bad = a.view(torch.int32) != b.view(torch.int32)
        assert not bad.any(), (i, int(bad.sum()))
    for a, b in zip(mine + [table], [c for v in again[0] for c in v] + [again[1], again[2]]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))  # repeats bitwise
    _sums_close("table", table, ref, abs_sum)
    assert float(abs_sum.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("focus", [-1.0, 2.5], ids=["pinhole", "dof"])
def test_k11_bwd_matches_its_plain_adjoint(focus):
    dev = _card()
    cam = camera_to_torch(make_camera_state(eye=(0.1, 1.0, 3.2), center_dir=(0.05, -0.1, 1.0),
                                            focus=focus, focal_length=0.05, aperture=2.0), dev)
    n = 1 << 16
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    settings = RenderSettings(width=256, height=256, anti_aliasing=0.7, fov=40.0)
    px, py = (ids % 256).float(), (ids // 256).float()
    prev_t = torch.full((n,), 2.0, device=dev)
    rng = PixelRng(7, ids)
    gen = torch.Generator(device=dev).manual_seed(5)
    g_o, g_d = (Vec3(*(torch.randn(n, device=dev, generator=gen) for _ in range(3)))
                for _ in range(2))
    with torch.no_grad():
        got = cuda_shade.gen_rays_bwd_launch(cam, settings, px, py, rng, 1, prev_t, g_o, g_d)
        again = cuda_shade.gen_rays_bwd_launch(cam, settings, px, py, rng, 1, prev_t, g_o, g_d)
        terms = cuda_shade.gen_rays_vjp_terms(cam, settings, px, py, rng, 1, prev_t, g_o, g_d)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _sums_close("camera", got, terms.double().sum(dim=1), terms.abs().double().sum(dim=1))


def _inputs(dev, n: int = 256):
    ts, _ = _cornell(dev)
    z = lambda dt=torch.float32: torch.zeros(n, dtype=dt, device=dev)  # noqa: E731
    v = lambda: Vec3(z(), z(), z())  # noqa: E731
    lanes = Lanes(v(), v(), Vec3(z() + 1, z() + 1, z() + 1), z(torch.bool) | True,
                  z(torch.bool), v(), z(torch.int32), v(), z(torch.int32) + 1)
    hit = Hit(torch.full((n,), float("inf"), device=dev), z(torch.int32) - 1,
              occluded=z(torch.bool))
    rng = PixelRng(0, torch.arange(n, dtype=torch.int32, device=dev))
    scene = ShadeScene(ts.tris, ts.materials, ts.lights)
    return ShadeConfig.of(SETTINGS, ts.lights.count), lanes, hit, rng, scene


@pytest.mark.cuda
@pytest.mark.parametrize("broken", ["t dtype", "alive shape", "material device", "px dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(broken):
    dev = _card()
    cfg, lanes, hit, rng, scene = _inputs(dev)
    with torch.no_grad():
        out, _ = cuda_shade.shade(cfg, lanes, hit, rng, 0, 0, scene)  # the valid call runs
        torch.cuda.synchronize()
        assert not bool(out.alive.any()) and bool(out.light_found.all())  # every lane missed
        zero_counts()
        with pytest.raises(ValueError):
            if broken == "t dtype":
                cuda_shade.shade(cfg, lanes, hit._replace(t=hit.t.double()), rng, 0, 0, scene)
            elif broken == "alive shape":
                cuda_shade.shade(cfg, lanes._replace(alive=lanes.alive[1:]), hit, rng, 0, 0,
                                 scene)
            elif broken == "material device":
                mats = scene.materials._replace(d=scene.materials.d.cpu())
                cuda_shade.shade(cfg, lanes, hit, rng, 0, 0, scene._replace(materials=mats))
            else:
                _, ct = _cornell(dev)
                px = torch.zeros(256, dtype=torch.float64, device=dev)
                cuda_shade.gen_rays(ct, SETTINGS, px, px.float(), rng, 0, px.float())
        assert all(v == 0 for v in counts().values())
