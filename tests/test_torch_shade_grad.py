"""The backward of the frame's shading (``pbr_tpu_torch/ops/cuda_shade.py``:
the plain adjoints of kernels K12 bwd and K11 bwd, and the autograd
Functions that run them) on the CPU. tests/test_torch_grad.py holds the
whole frame's gradients, which now come from these adjoints, to
``jax.grad``; this file holds the adjoints to torch's autograd of the plain
versions they differentiate.

- ``shade_vjp_plain`` against ``torch.autograd.grad`` of ``shade_plain`` on
  4,096 random lanes (numpy seed) over the tables of the Cornell box (its
  glossy block turned to glass) and of multiroom, for Schlick and
  Shirley-Ashikhmin x NEE on and off x transparency on and off, and of the
  Cornell box with a smooth sphere under Phong tessellation (random (u, v)
  on its curved faces: the shading normal is a constant of the
  differentiated inputs), Schlick and Shirley-Ashikhmin x NEE; "fused"
  with the occluded bit given, "post" through ``shade`` (``_ShadeFn``,
  whose forward takes the bit from the shadow leg's callback). Per lane:
  rtol 1e-5 plus 1e-6 of the larger of the field's largest magnitude and
  the lane's largest gradient (a lane's gradients come from one chain of
  float32 products and sums, whose rounding scales with its largest
  terms: a hit distance's gradient is a dot product of terms some ten
  times larger than it). The tables: rtol 1e-5 plus 1e-6 of the sum of the
  terms' absolute values (the two sum the lanes in other orders, and a
  light's position gathers terms that cancel twentyfold).
- ``gen_rays_vjp_plain`` against autograd of ``gen_rays_plain``, AA on,
  depth of field off, on and at an infinite focus: the 15 camera
  gradients, the tables' tolerance.
- A frame under autograd on the CPU: ``_ShadeFn``'s backward (the plain
  adjoint) runs once a bounce of a flat-shaded frame and of a Phong frame,
  ``_GenRaysFn``'s once a sample, and the gradients are finite.

The kernels run only on a card: tests/test_torch_shade_card.py, which
takes its lanes from ``random_bounce`` here.
"""

import numpy as np
import pytest
import torch

from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import cuda_shade
from pbr_tpu_torch.ops.cuda_shade import Hit, LaneGrads, Lanes, ShadeConfig, ShadeScene
from pbr_tpu_torch.ops.phongtess import face_is_flat
from pbr_tpu_torch.ops.rng import PixelRng
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import cornell_box, cornell_sphere, multi_room
from pbr_tpu_torch.utils.config import BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN, RenderSettings

torch.set_num_threads(1)

LANES = 4096
SCH, SA = BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN
ALPHA = 0.8  # the Phong cases' tessellation


def shade_tables(name: str, dev="cpu"):
    """``SceneParams`` of the Cornell box with its glossy block turned to
    glass (``glass``), of multiroom, or of the Cornell box with a smooth
    sphere built for Phong tessellation (``sphere``)."""
    if name == "multiroom":
        return to_torch(scene_from_text(*multi_room(), use_bvh=False)[0], dev)
    if name == "sphere":
        return to_torch(scene_from_text(*cornell_sphere(), use_bvh=False,
                                        phong_tess_alpha=ALPHA)[0], dev)
    scene = scene_from_text(*cornell_box(), use_bvh=False)[0]
    d = np.asarray(scene.materials.d).copy()
    d[-2] = 0.3
    scene = scene._replace(materials=scene.materials._replace(d=d, Ni=np.full_like(d, 1.5)))
    return to_torch(scene, dev)


def random_bounce(ts, n: int = LANES, seed: int = 3, dev="cpu") -> tuple:
    """``(lanes, hit, rng, grads)`` of a bounce over ``ts``'s faces, from a
    numpy seed: rays from random points toward a random point of their
    face (the hit distance exact), 15% missing (t inf, face -1), 90%
    alive, 30% occluded, random colours, light values and budgets, and a
    random (u, v) in the face (read by a Phong bounce alone); the outputs'
    gradients standard normal."""
    r = np.random.default_rng(seed)
    tris = ts.tris
    np3 = lambda v: np.stack([c.cpu().numpy() for c in v], 1)  # noqa: E731
    v0, e1, e2 = np3(tris.v0), np3(tris.e1), np3(tris.e2)
    face = r.integers(0, v0.shape[0], n).astype(np.int32)
    a, b = r.uniform(0, 1, n), r.uniform(0, 1, n)
    flip = a + b > 1
    a[flip], b[flip] = 1 - a[flip], 1 - b[flip]
    p = v0[face] + a[:, None] * e1[face] + b[:, None] * e2[face]
    o = p + r.normal(size=(n, 3))
    d = p - o
    t = np.linalg.norm(d, axis=1)
    d /= t[:, None]
    miss = r.uniform(size=n) < 0.15
    t[miss], face[miss] = np.inf, -1
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    v3 = lambda x: Vec3(*(f(c) for c in x))  # noqa: E731
    lanes = Lanes(v3(o.T), v3(d.T), v3(r.uniform(0.1, 1.0, (3, n))),
                  torch.tensor(r.uniform(size=n) < 0.9, device=dev),
                  torch.tensor(r.uniform(size=n) < 0.2, device=dev),
                  v3(r.uniform(0, 1, (3, n))),
                  torch.tensor(r.integers(0, 2, n).astype(np.int32), device=dev),
                  v3(r.uniform(0, 1, (3, n))), torch.ones(n, dtype=torch.int32, device=dev))
    hit = Hit(f(t), torch.tensor(face, device=dev),
              occluded=torch.tensor(r.uniform(size=n) < 0.3, device=dev))
    grads = LaneGrads(*(v3(r.normal(size=(3, n))) for _ in range(5)))
    uv = r.dirichlet((1.0, 1.0, 1.0), n)[:, :2].T
    hit = hit._replace(u=f(uv[0]), v=f(uv[1]))
    return lanes, hit, PixelRng(seed, torch.arange(n, dtype=torch.int32, device=dev)), grads


def shade_config(ts, brdf: int, nee: bool, trans: bool, phong: bool = False) -> ShadeConfig:
    return ShadeConfig.of(RenderSettings(brdf=brdf, shadow_rays=int(nee), no_transparency=not trans,
                                         max_depth=3, max_added_depth=2,
                                         phong_tessellation=ALPHA if phong else 0.0),
                          ts.lights.count)


def shade_scene(ts, phong: bool = False) -> ShadeScene:
    """What the shade reads of ``ts``: with Phong, the faces' flat flags."""
    return ShadeScene(ts.tris, ts.materials, ts.lights, face_is_flat(ts.tris) if phong else None)


def lane_leaves(lanes: Lanes, hit: Hit) -> list:
    """The 16 lane inputs K12 differentiates (o, d, colour, light value,
    final colour, t), in ``LaneGrads`` order then t."""
    return [*lanes.o, *lanes.d, *lanes.color, *lanes.light_val, *lanes.final_color, hit.t]


def table_leaves(ts) -> list:
    """The scene's parameters K12 differentiates, in ``SHADE_TABLE`` order
    when flattened."""
    return [ts.mat_d, ts.mat_Ni, ts.mat_rough, ts.mat_p, ts.mat_nu, ts.mat_nv, ts.mat_Rs,
            ts.mat_Rd, ts.mat_kd, ts.mat_ks, ts.light_pos, ts.light_rgb]


def lane_close(got: list, ref: list) -> None:
    """The per-lane tolerance of the module docstring."""
    got, ref = torch.stack(list(got)).double(), torch.stack(list(ref)).double()
    assert torch.isfinite(got).all() and torch.isfinite(ref).all()
    scale = torch.maximum(ref.abs().amax(dim=1, keepdim=True), ref.abs().amax(dim=0, keepdim=True))
    bad = (got - ref).abs() > 1e-5 * ref.abs() + 1e-6 * scale
    assert not bad.any(), f"{int(bad.sum())} lane gradients off, fields {bad.any(dim=1).nonzero()}"


def sum_close(got: torch.Tensor, ref: torch.Tensor, abs_sum: torch.Tensor) -> None:
    """The sums' tolerance: rtol 1e-5 plus 1e-6 of the terms' absolute sum."""
    got, ref, abs_sum = got.double(), ref.double(), abs_sum.double()
    assert torch.isfinite(got).all()
    bad = (got - ref).abs() > 1e-5 * ref.abs() + 1e-6 * abs_sum
    assert not bad.any(), (got[bad], ref[bad], abs_sum[bad])


def terms_abs_sum(terms, ts) -> torch.Tensor:
    """The flat table's sums of its terms' absolute values, in float64."""
    t = terms._replace(mat=terms.mat.abs(), pos=terms.pos.abs(), rgb=terms.rgb.abs())
    return cuda_shade.table_sum(t, int(ts.mat_d.shape[0]), ts.lights.count, torch.float64)


CASES = [(scene, brdf, nee, trans, path)
         for scene in ("glass", "multiroom", "sphere") for brdf in (SCH, SA)
         for nee in (True, False) for trans in ((False,) if scene == "sphere" else (False, True))
         for path in (("fused", "post") if nee else ("fused",))]


@pytest.mark.parametrize("scene, brdf, nee, trans, path", CASES,
                         ids=[f"{c[0]}-{'schlick' if c[1] == SCH else 'sa'}-nee{int(c[2])}-"
                              f"trans{int(c[3])}-{c[4]}" for c in CASES])
def test_shade_vjp_matches_autograd_of_the_plain_shade(scene, brdf, nee, trans, path):
    ts = shade_tables(scene)
    phong = scene == "sphere"
    cfg = shade_config(ts, brdf, nee, trans, phong)
    lanes, hit, rng, g = random_bounce(ts)
    depth = 1
    sscene = shade_scene(ts, phong)
    if phong:  # the curved normal differs from the geometric one on most lanes
        normals = [cuda_shade._setup(c, lanes, hit, rng, 0, depth, sscene).normal.x
                   for c in (cfg, cfg._replace(pt_alpha=0.0))]
        assert float((normals[0] != normals[1]).float().mean()) > 0.5
    with torch.no_grad():
        got_lane, got_t, terms = cuda_shade.shade_vjp_terms(cfg, lanes, hit, rng, 0, depth,
                                                            sscene, g)
    # What the adjoint touches: live lanes, and with NEE lit ones.
    assert float(terms.mat.abs().sum()) > 0
    assert (not nee) or float(terms.pos.abs().sum()) > 0

    leaves = [x.clone().requires_grad_() for x in lane_leaves(lanes, hit)]
    v = lambda j: Vec3(*leaves[j:j + 3])  # noqa: E731
    rec = lanes._replace(o=v(0), d=v(3), color=v(6), light_val=v(9), final_color=v(12))
    ts.requires_grad_()
    sscene = shade_scene(ts, phong)
    occ = hit.occluded
    if path == "fused":
        out, _ = cuda_shade.shade_plain(cfg, rec, hit._replace(t=leaves[15]), rng, 0, depth,
                                        sscene)
        tabs = table_leaves(ts)
        ref = torch.autograd.grad([c for f in out[:3] for c in f] + [*out.light_val,
                                                                      *out.final_color],
                                  leaves + tabs, [c for f in g for c in f], allow_unused=True)
        ref = [torch.zeros_like(x) if r is None else r for x, r in zip(leaves + tabs, ref)]
        got = [c for f in got_lane for c in f] + [got_t]
        ref_table = torch.cat([r.reshape(-1) for r in ref[16:]])
        got_table = cuda_shade.table_sum(terms, int(ts.mat_d.shape[0]), ts.lights.count)
    else:
        # Through the wrapper: _ShadeFn on the CPU, its bit from the leg.
        def legs(*ray):
            return occ

        def run(fn):
            xs = [x.detach().clone().requires_grad_() for x in leaves]
            w = lambda j: Vec3(*xs[j:j + 3])  # noqa: E731
            lanes_x = rec._replace(o=w(0), d=w(3), color=w(6), light_val=w(9),
                                   final_color=w(12))
            out, casts = fn(cfg, lanes_x, hit._replace(t=xs[15], occluded=None), rng, 0,
                            depth, shade_scene(ts, phong), legs)
            assert casts is not None
            outs = [*out.o, *out.d, *out.color, *out.light_val, *out.final_color]
            grads = torch.autograd.grad(outs, xs + table_leaves(ts), [c for f in g for c in f],
                                        allow_unused=True)
            grads = [torch.zeros_like(x) if r is None else r
                     for x, r in zip(xs + table_leaves(ts), grads)]
            return grads[:16], torch.cat([r.reshape(-1) for r in grads[16:]])

        calls = []
        real = cuda_shade.shade_vjp_plain

        def spy(*a):
            calls.append(a[2].occluded)
            return real(*a)

        cuda_shade.shade_vjp_plain = spy
        try:
            got, got_table = run(cuda_shade.shade)
        finally:
            cuda_shade.shade_vjp_plain = real
        assert len(calls) == 1 and torch.equal(calls[0], occ)  # the leg's bit was saved
        ref, ref_table = run(cuda_shade.shade_plain)
    ts.requires_grad_(False)
    lane_close(got, ref[:16])
    sum_close(got_table, ref_table, terms_abs_sum(terms, ts))


def _camera(focus: float):
    cam = make_camera_state(eye=(0.1, 1.0, 3.2), center_dir=(0.05, -0.1, 1.0), focus=focus,
                            focal_length=0.05, aperture=2.0)
    return camera_to_torch(cam, "cpu")


@pytest.mark.parametrize("focus", [-1.0, 2.5, float("inf")], ids=["pinhole", "dof", "dof-inf"])
def test_gen_rays_vjp_matches_autograd_of_the_plain_camera(focus):
    w, h, s = 64, 64, 1
    settings = RenderSettings(width=w, height=h, anti_aliasing=0.7, fov=40.0)
    r = np.random.default_rng(5)
    ids = torch.arange(w * h, dtype=torch.int32)
    px, py = (ids % w).float(), (ids // w).float()
    prev_t = torch.tensor(r.uniform(0.5, 4.0, w * h).astype(np.float32))
    prev_t[::5] = float("inf")
    rng = PixelRng(7, ids)
    g_o = Vec3(*(torch.tensor(r.normal(size=w * h).astype(np.float32)) for _ in range(3)))
    g_d = Vec3(*(torch.tensor(r.normal(size=w * h).astype(np.float32)) for _ in range(3)))
    cam = _camera(focus)
    leaves = [c.clone().requires_grad_() for c in cuda_shade._cam_fields(cam)]
    v = lambda j: Vec3(*leaves[j:j + 3])  # noqa: E731
    cam_x = cam._replace(eye=v(0), w=v(3), u=v(6), v=v(9), focal_length=leaves[12],
                         aperture=leaves[13], focus=leaves[14])
    o, d = cuda_shade.gen_rays_plain(cam_x, settings, px, py, rng, s, prev_t)
    ref = torch.autograd.grad([*o, *d], leaves, [*g_o, *g_d], allow_unused=True)
    ref = torch.stack([torch.zeros(()) if x is None else x for x in ref])
    with torch.no_grad():
        terms = cuda_shade.gen_rays_vjp_terms(cam, settings, px, py, rng, s, prev_t, g_o, g_d)
        got = cuda_shade.gen_rays_vjp_plain(cam, settings, px, py, rng, s, prev_t, g_o, g_d)
    assert torch.equal(got, terms.sum(dim=1))
    sum_close(got, ref, terms.abs().double().sum(dim=1))
    lens = slice(12, 15)
    assert (float(got[lens].abs().sum()) > 0) == (focus >= 0)  # the lens only with DoF
    assert float(got[:12].abs().min()) > 0


def _spied(monkeypatch) -> dict:
    """Counts the calls of the two plain adjoints (the Functions' CPU
    backward)."""
    calls = {"shade_vjp_plain": 0, "gen_rays_vjp_plain": 0}
    for name in calls:
        real = getattr(cuda_shade, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(cuda_shade, name, spy)
    return calls


@pytest.mark.parametrize("phong", [False, True], ids=["flat", "phong"])
def test_the_frames_backward_runs_through_the_functions(phong, monkeypatch):
    settings = RenderSettings(width=16, height=16, samples=1, max_depth=3, max_added_depth=2,
                              shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
                              no_transparency=True,
                              phong_tessellation=0.8 if phong else 0.0)
    src = cornell_sphere() if phong else cornell_box()
    scene = scene_from_text(*src, use_bvh=True, phong_tess_alpha=0.8 if phong else 0.0)[0]
    ts = to_torch(scene, "cpu").requires_grad_()
    cam = camera_to_torch(make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0)),
                          "cpu")
    eye_x = cam.eye.x.clone().requires_grad_()
    cam = cam._replace(eye=cam.eye._replace(x=eye_x))
    calls = _spied(monkeypatch)
    res = trace_rays(ts, cam, settings, torch.arange(256, dtype=torch.int32), 5)
    loss = sum(c.sum() for c in res.color)
    grads = torch.autograd.grad(loss, [ts.mat_kd, ts.light_rgb, eye_x])
    assert all(torch.isfinite(g).all() for g in grads) and float(grads[0].abs().sum()) > 0
    bounces = settings.samples * settings.max_total_depth
    assert calls == {"shade_vjp_plain": bounces, "gen_rays_vjp_plain": settings.samples}
