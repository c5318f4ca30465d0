"""Phong tessellation through the port's renderer (``trace_rays`` with
``phong_tessellation`` > 0, the CLI's ``render --config``) against the JAX
package: the NumPy oracle ``render_cpu`` and ``jax.grad`` on the CPU.

Frame gate: at most 2% of pixels off by more than 1e-3, the JAX package's
own figure for Phong frames (tests/test_phongtess.py:165); the scene with
clusters, whose search the port runs at 64² and the oracle does not, is
held to the repo's 1% (tests/test_render_golden.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.reference.cpu import render_cpu
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.scene.camera import make_camera_state
from pbr_tpu.utils.config import RenderSettings
from pbr_tpu_torch import app, camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.models import integrator
from pbr_tpu_torch.ops import phongtess
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.procedural import cornell_box
from test_torch_phongtess import BUMPY, MTL, wavy_sheet_obj

torch.set_num_threads(1)

ALPHA = 0.8


def cornell_sphere(rings: int = 12, segments: int = 24, center=(-0.45, 0.3, 0.45),
                   radius: float = 0.3):
    """The Cornell box with every face given its flat normal as ``vn``, and
    a smooth UV sphere (``segments`` x ``rings``: 528 faces by default, with
    radial vertex normals) on the floor: (obj, mtl, lights) text. The faces
    of a mesh keep their normals only when every face has them."""
    obj, mtl, lights = cornell_box()
    verts = [[float(c) for c in ln.split()[1:4]] for ln in obj.splitlines()
             if ln.startswith("v ")]
    out, normals = [], []
    for ln in obj.splitlines():
        if ln.startswith("f "):
            a, b, c = (int(i) - 1 for i in ln.split()[1:4])
            p = np.array([verts[a], verts[b], verts[c]])
            n = np.cross(p[1] - p[0], p[2] - p[0])
            normals.append(n / np.linalg.norm(n))
            k = len(normals)
            out.append(f"f {a + 1}//{k} {b + 1}//{k} {c + 1}//{k}")
        else:
            out.append(ln)
    out += [f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}" for n in normals]
    base_v, base_n = len(verts), len(normals)
    dirs = [(0.0, 1.0, 0.0)]
    for j in range(1, rings):
        th = np.pi * j / rings
        dirs += [(np.sin(th) * np.cos(2 * np.pi * i / segments), np.cos(th),
                  np.sin(th) * np.sin(2 * np.pi * i / segments)) for i in range(segments)]
    dirs.append((0.0, -1.0, 0.0))
    out.append("usemtl white")
    for x, y, z in dirs:
        out.append(f"v {center[0] + radius * x:.6f} {center[1] + radius * y:.6f} "
                   f"{center[2] + radius * z:.6f}")
        out.append(f"vn {x:.6f} {y:.6f} {z:.6f}")
    idx = lambda k: f"{base_v + k + 1}//{base_n + k + 1}"  # noqa: E731
    ring = lambda j, i: 1 + (j - 1) * segments + i % segments  # noqa: E731
    last = len(dirs) - 1
    for i in range(segments):
        out.append(f"f {idx(0)} {idx(ring(1, i + 1))} {idx(ring(1, i))}")
        out.append(f"f {idx(last)} {idx(ring(rings - 1, i))} {idx(ring(rings - 1, i + 1))}")
        for j in range(1, rings - 1):
            a, b, c, d = ring(j, i), ring(j, i + 1), ring(j + 1, i + 1), ring(j + 1, i)
            out.append(f"f {idx(a)} {idx(b)} {idx(c)}")
            out.append(f"f {idx(a)} {idx(c)} {idx(d)}")
    return "\n".join(out) + "\n", mtl, lights


def _settings(size, **kw):
    base = dict(width=size, height=size, samples=1, max_depth=2, max_added_depth=0,
                shadow_rays=0, anti_aliasing=0.0, phong_tessellation=ALPHA)
    base.update(kw)
    return RenderSettings(**base)


def _frame(scene, cam, settings, seed):
    ids = torch.arange(settings.width * settings.height, dtype=torch.int32)
    res = trace_rays(to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"), settings, ids, seed)
    return res.color.stack().numpy().reshape(settings.height, settings.width, 3)


def _flips(got, ref):
    return float((np.abs(got - ref).max(axis=-1) > 1e-3).mean())


_CAM_BUMP = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))
_CAM_SHEET = make_camera_state(eye=(0.0, 0.3, 2.0), center_dir=(0.0, 0.0, 1.0))
_CAM_BOX = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))


@pytest.mark.parametrize("name, obj, use_bvh, size", [
    ("bump, sweep", BUMPY, False, 32),
    ("sheet, sweep", wavy_sheet_obj(4), False, 24),
    ("sheet, walk", wavy_sheet_obj(4), True, 24),
])
def test_frames_match_the_oracle(name, obj, use_bvh, size):
    """tests/test_phongtess.py:150 and tests/test_phongtess_bvh.py:140's
    frames: the all-faces sweep without a BVH, the walk with one."""
    cam = _CAM_BUMP if "bump" in name else _CAM_SHEET
    kw = dict(use_bvh=use_bvh, phong_tess_alpha=ALPHA)
    settings = _settings(size)
    ref, _ = render_cpu(jax_scene_from_text(obj, MTL, "", **kw)[0], cam, settings, frame_seed=3)
    got = _frame(scene_from_text(obj, MTL, "", **kw)[0], cam, settings, 3)
    assert np.isfinite(got).all() and np.abs(got).sum() > 0
    assert _flips(got, ref) < 0.02


def test_phong_frame_differs_from_the_flat_one():
    scene = scene_from_text(BUMPY, MTL, use_bvh=False)[0]
    settings = _settings(32)
    got = _frame(scene, _CAM_BUMP, settings, 3)
    flat = _frame(scene, _CAM_BUMP, settings.replace(phong_tessellation=0.0), 3)
    assert np.abs(got - flat).max() > 1e-3


# The JAX package's threshold of the Phong dispatch: every pass of 4,096
# rays or more takes the cluster search (the card's band may send them all
# to the walk: phongtess.CLUSTER_MIN_RAYS).
JAX_MIN_RAYS = 4096


@pytest.fixture(scope="module")
def box_sphere():
    """The Cornell box and a smooth sphere (562 faces: 9 clusters of 64,
    built over the inflated bounds) at 64², NEE on: every pass of the
    frame has 4,096 rays, so under the JAX package's threshold the port
    runs the cluster search throughout; the oracle walks the BVH."""
    text = cornell_sphere()
    scene = scene_from_text(*text, use_bvh=True, phong_tess_alpha=ALPHA)[0]
    assert scene.tris.count == 562 and scene.clusters is not None
    settings = _settings(64, shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(phongtess, "CLUSTER_MIN_RAYS", JAX_MIN_RAYS)
        got = _frame(scene, _CAM_BOX, settings, 3)
    return text, scene, settings, got


def _box_sphere_oracle(box_sphere):
    text, _, settings, _ = box_sphere
    return render_cpu(jax_scene_from_text(*text, use_bvh=True, phong_tess_alpha=ALPHA)[0],
                      _CAM_BOX, settings, frame_seed=3)[0]


def test_cluster_path_frame_matches_the_oracle(box_sphere):
    got = box_sphere[3]
    assert np.isfinite(got).all()
    assert _flips(got, _box_sphere_oracle(box_sphere)) <= 0.01


def test_band_path_frame_matches_the_oracle(box_sphere):
    """The same frame under the card's band (``CLUSTER_MIN_RAYS`` as the
    module sets it): within the oracle's gate, and within it of the
    cluster search's frame."""
    _, scene, settings, cluster = box_sphere
    got = _frame(scene, _CAM_BOX, settings, 3)
    assert np.isfinite(got).all()
    assert _flips(got, _box_sphere_oracle(box_sphere)) <= 0.01
    assert _flips(got, cluster) <= 0.01


def test_shadow_leg_mask_changes_no_pixel(box_sphere, monkeypatch):
    """The port's Phong shadow leg closes the lanes that cast no shadow ray
    (the cluster search's ``alive``); the JAX version searches every lane.
    The frame is the same, bitwise."""
    _, scene, settings, got = box_sphere
    real = integrator._shadow_occluded
    calls = []

    def unmasked(tris, hit_p, l_dir, t_light, casts, *rest):
        calls.append(casts.shape[0])
        return real(tris, hit_p, l_dir, t_light, None, *rest)

    monkeypatch.setattr(integrator, "_shadow_occluded", unmasked)
    monkeypatch.setattr(phongtess, "CLUSTER_MIN_RAYS", JAX_MIN_RAYS)
    ref = _frame(scene, _CAM_BOX, settings, 3)
    assert calls == [64 * 64] * settings.max_total_depth
    np.testing.assert_array_equal(got, ref)


def test_rays_leaving_a_curved_patch_do_not_hit_it_again():
    """From points on the sphere, rays toward the light: the cluster search
    finds the BVH walk's faces (a curved face needs t >= EPSILON5, as in
    the walk and the sweep)."""
    scene = scene_from_text(*cornell_sphere(), use_bvh=True, phong_tess_alpha=ALPHA)[0]
    ts = to_torch(scene, "cpu")
    rng = np.random.default_rng(4)
    n = 4096
    dirs = rng.normal(size=(3, n))
    dirs /= np.linalg.norm(dirs, axis=0)
    o = Vec3(*(torch.tensor(c) for c in np.asarray(
        [[-0.45], [0.3], [0.45]] + 0.9 * dirs, dtype=np.float32)))
    d = Vec3(*(torch.tensor(c) for c in (-dirs).astype(np.float32)))
    t_s, face_s, _, _ = phongtess.intersect_scene_phongtess(o, d, ts.tris, ALPHA, bvh=ts.bvh,
                                                            clusters=ts.clusters)
    hit = Vec3(*(a + b * t_s for a, b in zip(o, d)))
    light = Vec3(*(torch.full((n,), v) for v in (0.0, 1.85, 0.0)))
    l_dir = (light - hit).normalized()
    ok = torch.isfinite(t_s)
    assert ok.float().mean() > 0.9
    hp = Vec3(*(c[ok] for c in hit))
    ld = Vec3(*(c[ok] for c in l_dir))
    face_c, _, _ = phongtess.intersect_clusters_phongtess(hp, ld, ts.clusters, ts.tris, ALPHA)
    _, face_w, _, _ = phongtess.intersect_bvh_phongtess(hp, ld, ts.bvh, ts.tris, ALPHA)
    assert (face_c == face_w).float().mean() > 0.999


def _grads_port(scene, cam, settings, weights):
    ts = to_torch(scene, "cpu").requires_grad_()
    tc = camera_to_torch(cam, "cpu")
    for c in tc.eye:
        c.requires_grad_()
    ids = torch.arange(settings.width * settings.height, dtype=torch.int32)
    res = trace_rays(ts, tc, settings, ids, 4)
    ((res.color.x + res.color.y + res.color.z) * torch.tensor(weights)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in ts.named_parameters() if p.grad is not None}
    grads["eye"] = np.array([float(c.grad) for c in tc.eye], dtype=np.float32)
    return grads, res.color.stack().detach().numpy()


def test_grads_match_jax_grad():
    """tests/test_phongtess_bvh.py::test_bvh_phongtess_grads_flow's loss
    (the frame's color sum at 8², the sheet through the BVH walk):
    materials and eye against jax.grad, rtol 1e-4 plus 1e-5 of the largest
    gradient, over the pixels whose colors agree within 1e-3 (a flipped
    path contributes another gradient; tests/test_torch_grad.py)."""
    obj = wavy_sheet_obj(3)
    settings = _settings(8)
    jscene = jax.tree_util.tree_map(
        jnp.asarray, jax_scene_from_text(obj, MTL, "", use_bvh=True, phong_tess_alpha=ALPHA)[0])
    jcam = jax.tree_util.tree_map(jnp.asarray, _CAM_SHEET)
    ids = jnp.arange(64, dtype=jnp.int32)

    def loss(mats, cam_, weights):
        res = jax_integrator.trace_rays(jnp, jscene._replace(materials=mats), cam_, settings, ids,
                                        jnp.uint32(4))
        return jnp.sum((res.color.x + res.color.y + res.color.z) * weights), jnp.stack(
            [res.color.x, res.color.y, res.color.z], -1)

    f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True, allow_int=True))
    scene = scene_from_text(obj, MTL, "", use_bvh=True, phong_tess_alpha=ALPHA)[0]
    ones = np.ones(64, dtype=np.float32)
    (_, color_j), _ = f(jscene.materials, jcam, jnp.asarray(ones))
    _, color_p = _grads_port(scene, _CAM_SHEET, settings, ones)
    agree = (np.abs(color_p - np.asarray(color_j)).max(axis=1) <= 1e-3).astype(np.float32)
    # This scene is chaotic across backends: every bounce leaves a curved
    # face. tests/test_phongtess_bvh.py:189 allows 8% of JAX's pixels to
    # flip against NumPy; here the port flips 1 of 64 against NumPy.
    assert agree.mean() >= 0.92
    _, (gm, gc) = f(jscene.materials, jcam, jnp.asarray(agree))
    got, _ = _grads_port(scene, _CAM_SHEET, settings, agree)
    st = lambda v: np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])  # noqa: E731
    ref = {f"mat_{k}": np.asarray(getattr(gm, k)) for k in ("rough", "p", "Rs", "Rd")}
    ref.update(mat_kd=st(gm.kd), mat_ks=st(gm.ks), eye=np.array(
        [gc.eye.x, gc.eye.y, gc.eye.z], dtype=np.float32))
    # The absolute part scales with the loss's largest gradient (kd's): on
    # this scene a pixel inside the color gate can still take another
    # second bounce, which moves the small gradients (Rd's is 1e-5 of kd's).
    scale = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        g = got.get(k, np.zeros_like(r))
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    assert np.abs(got["mat_kd"]).max() > 1e-3  # the eye's is 0 in both: the sky is uniform


def _control_points(tris, alpha):
    """(F, 6, 3): each face's quadratic Bézier control points (its corners
    and its three mid-edge points, ops/phongtess.py::phongtess_face_aabbs)."""
    p = [np.stack([c.numpy() for c in v], -1) for v in (tris.v0, tris.v0 + tris.e1,
                                                         tris.v0 + tris.e2)]
    n = [np.stack([c.numpy() for c in v], -1) for v in (tris.n0, tris.n1, tris.n2)]
    proj = lambda q, a, m: q - np.sum((q - a) * m, -1, keepdims=True) * m  # noqa: E731
    mids = [0.5 * ((1 - alpha) * (p[i] + p[j]) + alpha * (proj(p[j], p[i], n[i])
                                                          + proj(p[i], p[j], n[j])))
            for i, j in ((0, 1), (1, 2), (0, 2))]
    return np.stack(p + mids, axis=1)


def test_render_config_builds_the_inflated_tree(tmp_path):
    """``render --config`` with render.phong_tessellation and an OBJ with
    vertex normals: the frame is the Phong frame, and every leaf box of the
    tree the CLI built holds its faces' Bézier control points (the JAX CLI
    builds flat bounds there, which the bulges leave)."""
    obj = tmp_path / "sheet.obj"
    obj.write_text("usemtl m\n" + wavy_sheet_obj(4))
    (tmp_path / "sheet.mtl").write_text(MTL)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"render": {"phong_tessellation": ALPHA, "max_depth": 2,
                                          "max_added_depth": 0}}))
    res = app.main(["render", "--scene", str(obj), "--config", str(cfg), "--size", "16",
                    "--frames", "1", "--out", str(tmp_path / "out.png"), "--device", "cpu"])
    pt = res["tracer"]
    assert pt.settings.phong_tessellation == ALPHA
    bvh, tris = pt.scene.bvh, pt.scene.tris
    pts = _control_points(tris, np.float32(ALPHA))
    lf, cnt = bvh.leaf_first.numpy(), bvh.leaf_count.numpy()
    lo, hi = bvh.bb_min.numpy().T, bvh.bb_max.numpy().T
    leaves = np.flatnonzero(lf >= 0)
    assert cnt[leaves].sum() == tris.mtl.shape[0]
    bulge = 0.0
    for node in leaves:
        q = pts[lf[node]:lf[node] + cnt[node]].reshape(-1, 3)
        assert (q >= lo[node] - 1e-6).all() and (q <= hi[node] + 1e-6).all(), node
        corners = pts[lf[node]:lf[node] + cnt[node], :3].reshape(-1, 3)
        bulge = max(bulge, float((q.max(0) - corners.max(0)).max()),
                    float((corners.min(0) - q.min(0)).max()))
    assert bulge > 1e-3  # the control points leave the flat faces' boxes
    assert np.isfinite(res["image"]).all()
