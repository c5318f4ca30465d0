"""Kernels K9 and K10 (``pbr_tpu_torch/ops/cuda_phong.py``), the Phong
searches, on the CPU: their wrappers, their loop orders and the Phong frame
as a static step.

- (a) the wrappers route CPU tensors to the plain versions and count no
  launch; a tensor on another device raises, and the plain versions are
  not run;
- (b) a scalar emulation of each kernel's own loop order (K9: each ray's
  walk alone, every face of a leaf against the running best; K10: each
  tile's rounds, the block-wide stop, every face of a round against the
  ray's best at the round's start, the first face of the least t, the
  (t, face) merge) is bitwise the plain version, on the Cornell box with a
  smooth sphere and on two smooth spheres on a floor built with 2-face and
  64-face leaves; and it agrees with the JAX package's
  ``intersect_bvh_phongtess`` / ``intersect_clusters_phongtess`` at the
  tolerances of tests/test_torch_phongtess.py (the two searches differ on
  the listed divergences: the port's per-tile stop and t >= EPSILON5 on a
  curved face, and float32 rounding of the transcendentals);
- (c) the ``alive`` mask of K9's plain version changes no live lane;
- (d) the ctypes argtypes of the two C functions match their signatures;
- (e) with the two searches stubbed by their recorded results, a 32² Phong
  ``render_frame`` reads nothing from the host (``HostReadGuard``), and
  nor do the CUDA paths' own ops (the candidate lists, the ray order);
- (f) ``PathTracer`` on the CPU runs a Phong frame through its static
  step, bitwise ``render_frame``;
- the face table's layout, and the bounds' operation counts
  (``OPS_RAY``, ``OPS_PATCH``) against the plain version as written.

The kernels themselves run only on a card: chip_smoke.py holds them
bitwise to these plain versions there.
"""

import collections
import ctypes
import re
import unittest.mock as um
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pbr_tpu.ops import phongtess as J
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.utils.config import BVHConfig as JBVHConfig
from pbr_tpu_torch import PathTracer, bench
from pbr_tpu_torch.models.pathtracer import init_frame_state, render_frame
from pbr_tpu_torch.ops import cuda_phong, phongtess
from pbr_tpu_torch.ops.cuda_bvh import ray_order
from pbr_tpu_torch.ops.cull import candidates_fine, coherence_keys
from pbr_tpu_torch.ops.intersect import EPS5, INF, slab_box
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.device import camera_to_torch
from pbr_tpu_torch.utils.config import BVHConfig
from test_torch_graph_step import HostReadGuard
from test_torch_phongtess_render import cornell_sphere

torch.set_num_threads(1)

ALPHA = 0.8
CSRC = Path(cuda_phong.__file__).resolve().parents[1] / "csrc"
MTL = "newmtl m\nKd 0.5 0.6 0.7\nKs 1 1 1\nrough 1\np 1\n"
CAM = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))


def _sphere(center, radius, base: int, rings: int = 12, segments: int = 24) -> list:
    """OBJ lines of a smooth UV sphere (radial vertex normals), its vertex
    and normal indices starting after ``base``."""
    dirs = [(0.0, 1.0, 0.0)]
    for j in range(1, rings):
        th = np.pi * j / rings
        dirs += [(np.sin(th) * np.cos(2 * np.pi * i / segments), np.cos(th),
                  np.sin(th) * np.sin(2 * np.pi * i / segments)) for i in range(segments)]
    dirs.append((0.0, -1.0, 0.0))
    out = []
    for x, y, z in dirs:
        out.append(f"v {center[0] + radius * x:.6f} {center[1] + radius * y:.6f} "
                   f"{center[2] + radius * z:.6f}")
        out.append(f"vn {x:.6f} {y:.6f} {z:.6f}")
    idx = lambda k: f"{base + k + 1}//{base + k + 1}"  # noqa: E731
    ring = lambda j, i: 1 + (j - 1) * segments + i % segments  # noqa: E731
    last = len(dirs) - 1
    for i in range(segments):
        out.append(f"f {idx(0)} {idx(ring(1, i + 1))} {idx(ring(1, i))}")
        out.append(f"f {idx(last)} {idx(ring(rings - 1, i))} {idx(ring(rings - 1, i + 1))}")
        for j in range(1, rings - 1):
            a, b, c, d = ring(j, i), ring(j, i + 1), ring(j + 1, i + 1), ring(j + 1, i)
            out.append(f"f {idx(a)} {idx(b)} {idx(c)}")
            out.append(f"f {idx(a)} {idx(c)} {idx(d)}")
    return out, len(dirs)


def two_spheres() -> str:
    """Two smooth spheres (528 curved faces each) on a flat floor (2 flat
    faces): 1,058 faces, 17 clusters of 64."""
    lines = ["o floor", "v -2 0 -2", "v 2 0 -2", "v 2 0 2", "v -2 0 2", "vn 0 1 0", "vn 0 1 0",
             "vn 0 1 0", "vn 0 1 0", "f 1//1 3//3 2//2", "f 1//1 4//4 3//3", "o spheres"]
    a, na = _sphere((-0.5, 0.45, 0.0), 0.45, 4)
    b, _ = _sphere((0.55, 0.35, 0.3), 0.35, 4 + na)
    return "\n".join(lines + a + b) + "\n"


def _build(name: str, leaf: int):
    """(port scene, JAX scene) of ``name`` with ``leaf``-face leaves."""
    text = cornell_sphere() if name == "box_sphere" else (two_spheres(), MTL, "")
    kw = dict(use_bvh=True, phong_tess_alpha=ALPHA)
    return (scene_from_text(*text, bvh_cfg=BVHConfig(max_faces=leaf), **kw)[0],
            jax_scene_from_text(*text, bvh_cfg=JBVHConfig(max_faces=leaf), **kw)[0])


def _rays(name: str, n: int, seed: int):
    """(3, n) float32 origins and unit directions: from around the camera
    into the Cornell box, or from a shell around the two spheres toward
    points near them."""
    rng = np.random.default_rng(seed)
    if name == "box_sphere":
        o = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(0.3, 1.7, n),
                      rng.uniform(1.0, 3.0, n)])
        aim = np.stack([rng.uniform(-0.8, 0.2, n), rng.uniform(0.0, 0.8, n),
                        rng.uniform(0.1, 0.8, n)])
    else:
        o = rng.normal(size=(3, n))
        o = o / np.linalg.norm(o, axis=0) * 2.5 + np.array([[0.0], [0.5], [0.0]])
        aim = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(0.0, 0.9, n),
                        rng.uniform(-0.5, 0.7, n)])
    d = aim - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


def _t3(a) -> Vec3:
    return Vec3(*(torch.tensor(np.ascontiguousarray(c)) for c in a))


def _f1(x: float) -> torch.Tensor:
    return torch.tensor([x], dtype=torch.float32)


# ------------------------------------------------- (b) the kernels' loops --

def emulate_walk(o: Vec3, d: Vec3, bvh, faces, alpha, max_leaf: int, alive=None):
    """K9's loop order, one ray at a time: the ray's own node cursor (i + 1
    on a hit, exit on a miss), at a hit leaf its faces in ascending order,
    each tested against the running best and kept on a strict '<'."""
    fc = phongtess.record_faces(faces)
    n_rays = o.x.shape[0]
    out = (np.full(n_rays, np.inf, np.float32), np.full(n_rays, -1, np.int32),
           np.zeros(n_rays, np.float32), np.zeros(n_rays, np.float32))
    lf, lc, ex = (a.tolist() for a in (bvh.leaf_first, bvh.leaf_count, bvh.exit))
    for r in range(n_rays):
        if alive is not None and not bool(alive[r]):
            continue
        o1, d1 = Vec3(*(c[r:r + 1] for c in o)), Vec3(*(c[r:r + 1] for c in d))
        inv = Vec3(1.0 / d1.x, 1.0 / d1.y, 1.0 / d1.z)
        t_best, f_best, u_best, v_best = _f1(INF), -1, 0.0, 0.0
        i = 0
        while i < bvh.count:
            lo, hi = bvh.bb_min[:, i:i + 1], bvh.bb_max[:, i:i + 1]
            t_near, t_far, hit = slab_box(o1, inv, Vec3(*lo), Vec3(*hi))
            hit = bool(hit & (t_far > EPS5) & (lo[0] <= hi[0]) & (t_best > t_near))
            if hit and lf[i] >= 0:
                for k in range(min(lc[i], max_leaf)):
                    t, u, v, valid = phongtess._face_hit(o1, d1, fc, lf[i] + k, alpha, t_best)
                    if bool(valid & (t < t_best)):
                        t_best, f_best, u_best, v_best = t, lf[i] + k, float(u), float(v)
            i = i + 1 if hit else ex[i]
        out[0][r], out[1][r], out[2][r], out[3][r] = float(t_best), f_best, u_best, v_best
    return tuple(torch.from_numpy(a) for a in out)


def _key(t, face: int) -> int:
    """csrc/key.cuh's pack_key: the (t, face) order as one unsigned int."""
    u = int(np.float32(t).view(np.uint32))
    ord_ = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return (ord_ << 32) | ((face & 0xFFFFFFFF) ^ 0x80000000)


def emulate_clusters(o: Vec3, d: Vec3, clusters, faces, alpha, alive=None, tile: int = 128):
    """K10's loop order, one tile (a block) at a time: each live ray's last
    listed entry whose box it hits (scanned from the list's end); rounds
    while some ray is open (best t beyond the entry bound, an entry left);
    in a round the A rays open and hitting the cluster's box before their
    best t take slots in lane order, each slot's faces are dealt over q =
    min(128 / A, size) threads (thread j: slot j mod A, faces j / A + q i),
    each thread merges its tests into a packed (t, face) key, the keys
    meet in the slot's atomicMin seeded with the ray's best,
    the thread whose key won gives u and v, and the ray takes the slot's
    key. Flat faces report a hit only at t <= the round's bound. Returns
    ``(face, u, v, rounds a tile, (flat, curved) tests of real faces run,
    slab tests)``."""
    fc = phongtess.record_faces(faces)
    n, s = o.x.shape[0], clusters.size
    tiles = -(-n // tile)
    pad = tiles * tile - n
    op, dp = (Vec3(*(torch.cat([a, a[-1:].expand(pad)]) for a in v)) for v in (o, d))
    cand, cnt, tent = (a.numpy() for a in candidates_fine(op, dp, clusters, tile))
    live = np.zeros(tiles * tile, bool)
    live[:n] = True if alive is None else alive.numpy()
    f_out = np.full(tiles * tile, -1, np.int32)
    u_out = np.zeros(tiles * tile, np.float32)
    v_out = np.zeros(tiles * tile, np.float32)
    rounds = np.zeros(tiles, np.int32)
    real = np.asarray(faces[:, :18].ne(0).any(dim=1))
    flat = fc.flat.numpy()
    tests, slabs = [0, 0], 0
    inv = Vec3(1.0 / dp.x, 1.0 / dp.y, 1.0 / dp.z)

    def box(lane, cid):
        hit, t_near = phongtess.cluster_box_hits(
            Vec3(*(a[lane:lane + 1] for a in op)), Vec3(*(a[lane:lane + 1] for a in inv)),
            clusters, torch.tensor([cid]))
        return bool(hit), np.float32(t_near)

    for b in range(tiles):
        lanes = np.arange(b * tile, (b + 1) * tile)
        t_b = np.where(live[lanes], np.float32(np.inf), np.float32(-3.0e38))
        f_b = np.full(tile, -1)
        last = np.full(tile, -1)
        for j in np.flatnonzero(live[lanes]):
            for r in range(cnt[b] - 1, -1, -1):
                slabs += 1
                if box(lanes[j], cand[b, r])[0]:
                    last[j] = r
                    break
        r = 0
        while r < cnt[b]:
            is_open = live[lanes] & (t_b > tent[b, r]) & (r <= last)
            if not is_open.any():  # __syncthreads_or
                break
            cid = cand[b, r]
            act = np.zeros(tile, bool)
            for j in np.flatnonzero(is_open):
                slabs += 1
                hit, t_near = box(lanes[j], cid)
                act[j] = hit and t_b[j] > t_near
            slot = np.flatnonzero(act)  # the ballots keep lane order
            if slot.size:
                fids = cid * s + np.arange(s)
                ob = Vec3(*(a[lanes[slot], None] for a in op))
                db = Vec3(*(a[lanes[slot], None] for a in dp))
                bound = torch.from_numpy(t_b[slot])[:, None]
                t, u, v, valid = phongtess._face_hit(ob, db, fc, torch.from_numpy(fids)[None],
                                                     alpha, bound)
                valid = valid & (~fc.flat[fids][None] | (t <= bound))
                tt, u, v = torch.where(valid, t, INF).numpy(), u.numpy(), v.numpy()
                tests[0] += slot.size * int((real[fids] & flat[fids]).sum())
                tests[1] += slot.size * int((real[fids] & ~flat[fids]).sum())
                keys = [_key(t_b[j], int(f_b[j])) for j in slot]
                q = min(128 // slot.size, s)
                won = []  # (slot, key, u, v) of each thread's tests
                for th in range(slot.size * q):
                    a, best = th % slot.size, None
                    for k in range(th // slot.size, s, q):
                        if tt[a, k] < np.inf:
                            kk = _key(tt[a, k], int(fids[k]))
                            if best is None or kk < best[0]:
                                best = (kk, u[a, k], v[a, k])
                    if best is not None:
                        keys[a] = min(keys[a], best[0])  # atomicMin
                        won.append((a, *best))
                su, sv = {}, {}
                for a, kk, uu, vv in won:
                    if keys[a] == kk:
                        su[a], sv[a] = uu, vv
                for a, j in enumerate(slot):
                    if keys[a] != _key(t_b[j], int(f_b[j])):
                        face = (keys[a] & 0xFFFFFFFF) ^ 0x80000000
                        t_b[j], f_b[j] = tt[a, face - cid * s], face
                        u_out[lanes[j]], v_out[lanes[j]] = su[a], sv[a]
            r += 1
        rounds[b] = r
        f_out[lanes] = f_b
    return (torch.from_numpy(f_out[:n]), torch.from_numpy(u_out[:n]),
            torch.from_numpy(v_out[:n]), torch.from_numpy(rounds), tuple(tests), slabs)


def emulate_jax_rule(o: Vec3, d: Vec3, clusters, faces, alpha, alive=None, tile: int = 128):
    """The JAX loop's rule a tile at a time: rounds while
    some ray's best t lies beyond the entry bound, every live ray testing
    every face of the round's cluster. Returns ``(face, u, v, rounds a
    tile, (flat, curved) tests of real faces)``."""
    fc = phongtess.record_faces(faces)
    n, s = o.x.shape[0], clusters.size
    tiles = -(-n // tile)
    pad = tiles * tile - n
    op, dp = (Vec3(*(torch.cat([a, a[-1:].expand(pad)]) for a in v)) for v in (o, d))
    cand, cnt, tent = (a.numpy() for a in candidates_fine(op, dp, clusters, tile))
    live = np.zeros(tiles * tile, bool)
    live[:n] = True if alive is None else alive.numpy()
    f_out = np.full(tiles * tile, -1, np.int32)
    u_out = np.zeros(tiles * tile, np.float32)
    v_out = np.zeros(tiles * tile, np.float32)
    rounds = np.zeros(tiles, np.int32)
    real = np.asarray(faces[:, :18].ne(0).any(dim=1))
    flat = fc.flat.numpy()
    tests = [0, 0]
    for b in range(tiles):
        lanes = np.arange(b * tile, (b + 1) * tile)
        t_b = np.where(live[lanes], np.float32(np.inf), np.float32(-3.0e38))
        r = 0
        while r < clusters.count and r < cnt[b]:
            if not (t_b > tent[b, r]).any():
                break
            fids = cand[b, r] * s + np.arange(s)
            ob = Vec3(*(a[lanes, None] for a in op))
            db = Vec3(*(a[lanes, None] for a in dp))
            t, u, v, valid = phongtess._face_hit(ob, db, fc, torch.from_numpy(fids)[None],
                                                 alpha, torch.from_numpy(t_b)[:, None])
            tt = torch.where(valid, t, INF).numpy()
            u, v = u.numpy(), v.numpy()
            n_live = int(live[lanes].sum())
            tests[0] += n_live * int((real[fids] & flat[fids]).sum())
            tests[1] += n_live * int((real[fids] & ~flat[fids]).sum())
            for j, lane in enumerate(lanes):
                if not live[lane]:
                    continue
                tm, km = np.float32(np.inf), -1
                for k in range(s):
                    if tt[j, k] < tm:
                        tm, km = tt[j, k], k
                fid = fids[km]
                if tm < np.inf and (tm < t_b[j] or (tm == t_b[j] and fid < f_out[lane])):
                    t_b[j], f_out[lane], u_out[lane], v_out[lane] = tm, fid, u[j, km], v[j, km]
            r += 1
        rounds[b] = r
    return (torch.from_numpy(f_out[:n]), torch.from_numpy(u_out[:n]),
            torch.from_numpy(v_out[:n]), torch.from_numpy(rounds), tuple(tests))


def _close_to_jax(got, ref, live, min_agree: float):
    """(t, face, u, v) or (face, u, v) against the JAX package's search on
    the live lanes: faces agree on at least ``min_agree`` of them, t within
    rtol 2e-3 / atol 2e-4 where they agree (tests/test_torch_phongtess.py's
    tolerance), u and v within its 2e-3 on 99% of those lanes and within
    1e-2 on all (a patch coordinate near the patch's edge moves with the
    float32 rounding of the solves: one lane of 360 lies 3.5e-3 off on the
    box and sphere)."""
    got = [np.asarray(a)[live] for a in got]
    ref = [np.asarray(a)[live] for a in ref]
    fi = len(got) - 3
    agree = got[fi] == ref[fi]
    assert agree.mean() >= min_agree, f"face agreement {agree.mean():.4f}"
    assert (got[fi] >= 0).mean() > 0.3
    if fi:
        hit = agree & (ref[1] >= 0)
        np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=2e-3, atol=2e-4)
    for j in (fi + 1, fi + 2):  # u and v: 2e-3 on 99% of the lanes, 1e-2 on all
        err = np.abs(got[j][agree] - ref[j][agree])
        assert (err <= 2e-3).mean() >= 0.99 and err.max() <= 1e-2, err.max()


_SCENES = {}


def _scene(name: str, leaf: int):
    if (name, leaf) not in _SCENES:
        scene, jscene = _build(name, leaf)
        _SCENES[name, leaf] = (to_torch(scene, "cpu"), jscene)
    return _SCENES[name, leaf]


@pytest.mark.parametrize("name, leaf, n", [("box_sphere", 2, 48), ("two_spheres", 2, 48),
                                           ("two_spheres", 64, 12)])
def test_k9_loop_order_is_the_plain_walk_and_the_jax_walk(name, leaf, n):
    """K9's per-ray walk, emulated, against the plain version (bitwise, with
    an ``alive`` mask) and the JAX package's NumPy walk (live lanes)."""
    ts, jscene = _scene(name, leaf)
    ml = ts.bvh_leaf_max  # the largest leaf: 2, or 36 of at most 64
    assert ml == 2 if leaf == 2 else ml > 16
    o, d = _rays(name, n, 3 + leaf)
    alive = torch.from_numpy(np.arange(n) % 5 != 2)
    args = (_t3(o), _t3(d), ts.bvh, ts.phong_records, ALPHA)
    emu = emulate_walk(*args, ml, alive)
    plain = cuda_phong.intersect_walk(*args, alive=alive)
    for a, b in zip(emu, plain):
        assert torch.equal(a, b)
    assert (plain[1][~alive] == -1).all() and torch.isinf(plain[0][~alive]).all()
    with np.errstate(all="ignore"):
        ref = J.intersect_bvh_phongtess(np, JVec3(*o), JVec3(*d), jscene.bvh, jscene.tris,
                                        np.float32(ALPHA), max_leaf=ml)
    _close_to_jax(plain, ref, alive.numpy(), 0.95)


@pytest.mark.parametrize("name", ["box_sphere", "two_spheres"])
def test_k10_loop_order_is_the_plain_search_and_the_jax_search(name):
    """K10's per-tile rounds, emulated (per-ray culling and closure, dealt
    pairs, the key merge), against the plain version (bitwise: faces, u, v
    and each tile's rounds; ``cluster_work``'s slab tests and
    ``cluster_tests``' count of the tests run), the JAX loop's rule
    emulated (the same faces, u and v; its rounds are ``cluster_work``'s
    ``jax_rounds`` and its tests ``cluster_tests``' yardstick count) and the JAX package's jnp search
    (live lanes)."""
    ts, jscene = _scene(name, 2)
    n = 3 * 128 + 40  # a ragged last tile
    o, d = _rays(name, n, 11)
    alive = torch.from_numpy(np.random.default_rng(5).random(n) < 0.85)
    args = (_t3(o), _t3(d), ts.clusters, ts.phong_records, ALPHA)
    emu = emulate_clusters(*args, alive=alive)
    stats = {}
    plain = phongtess.intersect_clusters_phongtess(*args[:3], None, ALPHA, alive=alive,
                                                   stats=stats, faces=ts.phong_records)
    assert torch.equal(cuda_phong.intersect_clusters(*args, alive=alive, with_rounds=True)[3],
                       stats["per_tile"])
    for a, b in zip(emu, (*plain, stats["per_tile"])):
        assert torch.equal(a, b)
    lists = cuda_phong.candidate_lists(_t3(o), _t3(d), ts.clusters)
    work = cuda_phong.cluster_work(lists, stats)
    assert work["slabs"] == emu[5]
    assert work["staged"] == int((stats["active"] > 0).sum()) > 0
    jax_rule = emulate_jax_rule(*args, alive=alive)
    for a, b in zip(jax_rule[:3], plain):
        assert torch.equal(a, b)
    assert torch.equal(jax_rule[3], work["jax_rounds"])
    assert int(work["jax_rounds"].max()) >= 2
    live = torch.zeros(stats["per_tile"].shape[0] * 128, dtype=torch.bool)
    live[:n] = alive
    counts = cuda_phong.cluster_tests(lists[0], work["jax_rounds"], live, ts.phong_records,
                                      ts.clusters.size, active=stats["active"])
    assert counts[:2] == jax_rule[4] and counts[2:] == emu[4]
    assert emu[4][0] > 0 and emu[4][1] > 0
    assert sum(emu[4]) < sum(jax_rule[4])  # the per-ray rules test less
    js = jax.tree_util.tree_map(jnp.asarray, jscene)
    ref = J.intersect_clusters_phongtess(
        jnp, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), js.clusters, js.tris,
        np.float32(ALPHA), alive=jnp.asarray(alive.numpy()))
    _close_to_jax(plain, ref, alive.numpy(), 0.97)


@pytest.mark.parametrize("how", ["shuffled", "shifted"])
def test_k10_results_follow_the_rays_not_their_tiles(how):
    """A permutation of the rays permutes the cluster search's results,
    bitwise: shuffled (every tile's rays and lists change) or shifted by 37
    rays (each ray in another tile): a ray's result does not depend on the
    tile it sits in."""
    ts, _ = _scene("two_spheres", 2)
    n = 3 * 128 + 40
    o, d = (_t3(a) for a in _rays("two_spheres", n, 13))
    alive = torch.from_numpy(np.random.default_rng(6).random(n) < 0.9)
    rng = np.random.default_rng(7)
    perm = torch.from_numpy(rng.permutation(n) if how == "shuffled"
                            else (np.arange(n) + 37) % n)
    args = (ts.clusters, ts.phong_records, ALPHA)
    ref = cuda_phong.intersect_clusters(o, d, *args, alive=alive, with_rounds=True)
    got = cuda_phong.intersect_clusters(Vec3(*(a[perm] for a in o)),
                                        Vec3(*(a[perm] for a in d)), *args, alive=alive[perm],
                                        with_rounds=True)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b[perm])
    assert (ref[0] >= 0).float().mean() > 0.3


def test_a_ray_that_misses_everything_closes_its_tile():
    """A ray whose path misses every cluster box of its tile's list holds
    its tile no longer than the rays that hit: the tile runs the rounds it
    runs with that ray dead, where the JAX loop's rule runs every listed
    cluster."""
    ts, _ = _scene("two_spheres", 2)
    # A narrow beam into the left sphere, past the right one; ray 5 starts
    # above the scene and points up and away.
    rng = np.random.default_rng(21)
    o = np.stack([np.full(128, -2.5), 0.45 + rng.uniform(-0.05, 0.05, 128),
                  -0.3 + rng.uniform(-0.05, 0.05, 128)]).astype(np.float32)
    d = np.stack([np.ones(128), rng.uniform(-0.02, 0.02, 128), rng.uniform(-0.02, 0.02, 128)])
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    o[:, 5], d[:, 5] = (0.3, 3.0, 0.2), (0.0, 1.0, 0.0)
    o, d = _t3(o), _t3(d)
    args = (ts.clusters, ts.phong_records, ALPHA)
    lists = cuda_phong.candidate_lists(o, d, ts.clusters)
    cand, cnt, _ = lists
    inv = Vec3(*(1.0 / a[5:6] for a in d))
    hits = [bool(phongtess.cluster_box_hits(Vec3(*(a[5:6] for a in o)), inv, ts.clusters,
                                            cand[0, r:r + 1].long())[0])
            for r in range(int(cnt[0]))]
    assert not any(hits) and int(cnt[0]) >= 4
    stats = {}
    got = phongtess.intersect_clusters_phongtess(o, d, *args[:1], None, ALPHA, stats=stats,
                                                 faces=ts.phong_records)
    dead = torch.ones(128, dtype=torch.bool)
    dead[5] = False
    ref = cuda_phong.intersect_clusters(o, d, *args, alive=dead, with_rounds=True)
    assert int(got[0][5]) == -1
    assert torch.equal(stats["per_tile"], ref[3]) and int(ref[3][0]) < int(cnt[0]) // 2
    assert (got[0][dead] >= 0).all()
    assert int(cuda_phong.cluster_work(lists, stats)["jax_rounds"][0]) == int(cnt[0])
    for a, b in zip(got, ref):
        assert torch.equal(a[dead], b[dead])


def test_k9_alive_mask_changes_no_live_lane():
    """(c) K9's plain version with an ``alive`` mask: the live lanes are the
    unmasked walk's, the dead ones t = +inf, face -1, u = v = 0."""
    ts, _ = _scene("box_sphere", 2)
    o, d = _rays("box_sphere", 600, 9)
    alive = torch.from_numpy(np.random.default_rng(1).random(600) < 0.5)
    args = (_t3(o), _t3(d), ts.bvh, ts.phong_records, ALPHA)
    got = cuda_phong.intersect_walk(*args, alive=alive)
    full = cuda_phong.intersect_walk(*args)
    for a, b in zip(got, full):
        assert torch.equal(a[alive], b[alive])
    assert (got[1][~alive] == -1).all() and torch.isinf(got[0][~alive]).all()
    assert not got[2][~alive].any() and not got[3][~alive].any()
    assert (full[1][alive] >= 0).float().mean() > 0.5


# ---------------------------------------------------------- (a) wrappers --

def test_wrappers_run_the_plain_versions_on_the_cpu_and_count_no_launch(monkeypatch):
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch; the dispatch takes K10 from CLUSTER_MIN_RAYS rays on
    a scene with clusters and K9 below: under the card's band (the
    module's value, docs/PHONG_BANDS_H100.json; None: K9 for every pass)
    and under the JAX package's 4,096, the two answering alike. K9's
    any-hit wrapper runs its plain version too."""
    ts, _ = _scene("box_sphere", 2)
    calls = []
    for name in ("intersect_bvh_phongtess", "intersect_clusters_phongtess",
                 "occluded_bvh_phongtess"):
        real = getattr(phongtess, name)
        monkeypatch.setattr(phongtess, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    before = dict(cuda_phong.launches)
    o, d = _rays("box_sphere", 4096, 2)
    o, d = _t3(o), _t3(d)
    out = []
    for big in (phongtess.CLUSTER_MIN_RAYS, 4096):
        monkeypatch.setattr(phongtess, "CLUSTER_MIN_RAYS", big)
        del calls[:]
        out.append(phongtess.intersect_scene_phongtess(o, d, ts.tris, ALPHA, bvh=ts.bvh,
                                                       clusters=ts.clusters,
                                                       faces=ts.phong_records))
        k10 = big is not None and big <= 4096
        assert calls == ["intersect_clusters_phongtess" if k10 else "intersect_bvh_phongtess"]
        cut = Vec3(*(c[:200] for c in o)), Vec3(*(c[:200] for c in d))
        phongtess.intersect_scene_phongtess(*cut, ts.tris, ALPHA, bvh=ts.bvh,
                                            clusters=ts.clusters)
        assert calls[1:] == ["intersect_bvh_phongtess"]
    del calls[:]
    t_limit = torch.where(torch.isfinite(out[0][0]), out[0][0] * 0.9, 5.0)
    occ = cuda_phong.occluded_walk(o, d, t_limit, ts.bvh, ts.phong_records, ALPHA)
    assert calls == ["occluded_bvh_phongtess"] and not occ.any()
    assert cuda_phong.launches == before
    t, face, _, _ = out[1]
    assert (face >= 0).float().mean() > 0.5 and torch.isfinite(t[face >= 0]).all()
    assert (out[0][1] == face).float().mean() > 0.999


@pytest.mark.parametrize("which", ["K9", "K10"])
def test_a_tensor_off_the_cpu_raises_and_runs_no_plain_version(which, monkeypatch):
    """A tensor on another device than the CPU never reaches the plain
    version: the wrapper raises (on a card it launches the kernel)."""
    ts, _ = _scene("box_sphere", 2)
    for name in ("intersect_bvh_phongtess", "intersect_clusters_phongtess"):
        monkeypatch.setattr(phongtess, name, lambda *a, **k: pytest.fail("plain version ran"))
    meta = lambda a: Vec3(*(torch.empty(256, device="meta") for _ in a))  # noqa: E731
    o, d = meta(range(3)), meta(range(3))
    faces = torch.empty(ts.phong_records.shape, device="meta")
    with pytest.raises(ValueError, match="not meta|on meta"):
        if which == "K9":
            cuda_phong.intersect_walk(o, d, ts.bvh, faces, ALPHA)
        else:
            cuda_phong.intersect_clusters(o, d, ts.clusters, faces, ALPHA)


def test_wrappers_check_their_inputs():
    """A face table of the wrong shape, a short ``alive`` and a leaf bound
    below the tree's largest leaf raise."""
    ts, _ = _scene("box_sphere", 2)
    o, d = (_t3(a) for a in _rays("box_sphere", 256, 1))
    with pytest.raises(ValueError, match="face table"):
        cuda_phong.intersect_clusters(o, d, ts.clusters, ts.phong_records[:-1], ALPHA)
    with pytest.raises(ValueError, match="alive"):
        cuda_phong.intersect_walk(o, d, ts.bvh, ts.phong_records, ALPHA,
                                  alive=torch.ones(255, dtype=torch.bool))
    ts64, _ = _scene("two_spheres", 64)
    with pytest.raises(ValueError, match="max_leaf"):
        cuda_phong.intersect_walk(o, d, ts64.bvh, ts64.phong_records, ALPHA, max_leaf=2)


# ------------------------------------------------------------ (d) ctypes --

_CTYPE = {"float*": ctypes.c_void_p, "int*": ctypes.c_void_p, "unsignedchar*": ctypes.c_void_p,
          "void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("src, fn, argtypes", [
    ("phong_walk.cu", "pbr_phong_walk", cuda_phong._WALK_ARGTYPES),
    ("phong_clusters.cu", "pbr_phong_clusters", cuda_phong._CLUSTER_ARGTYPES),
])
def test_ctypes_argtypes_match_the_c_signatures(src, fn, argtypes):
    """Each parameter of the C entry point as ctypes passes it: a pointer as
    c_void_p (a pointer passed as an int is cut to 32 bits), an int as
    c_int, a float as c_float."""
    text = (CSRC / src).read_text()
    sig = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    kinds = []
    for param in sig.split(","):
        words = param.replace("const", "").split()
        kinds.append(_CTYPE["".join(words[:-1]) + ("*" if words[-1].startswith("*") else "")])
    assert kinds == argtypes


# ----------------------------------------------- (e) no host reads, (f) --

@pytest.mark.parametrize("search", ["K9", "K10"])
def test_phong_frame_reads_nothing_from_the_host(search, monkeypatch):
    """A 32² Phong frame (NEE, 8 bounces) with each search call stubbed by
    the result it gave in an earlier run of the same frame: nothing of the
    frame reads the host under the guard. At 32² every pass has 1,024 rays:
    CLUSTER_MIN_RAYS set to 1,024 sends them to K10, None (the card's band
    when K9 wins every pass) to K9, the shadow legs to K9's any-hit
    instance. The ops the wrappers run on the card
    before a launch read nothing either: K10's ``sorted_lists`` (the ray
    sort, the gather, the candidate lists) and cluster boxes, and K9's ray
    order."""
    ts, _ = _scene("box_sphere", 2)
    monkeypatch.setattr(phongtess, "CLUSTER_MIN_RAYS", 1024 if search == "K10" else None)
    settings = bench.bench_settings(32, phong_tessellation=ALPHA)
    cam = camera_to_torch(CAM, "cpu")
    ids = torch.arange(32 * 32, dtype=torch.int32)
    recorded = collections.defaultdict(list)
    for name in ("intersect_walk", "occluded_walk", "intersect_clusters"):
        real = getattr(cuda_phong, name)
        monkeypatch.setattr(cuda_phong, name, lambda *a, _r=real, _n=name, **k: (
            recorded[_n].append(_r(*a, **k)), recorded[_n][-1])[1])
    with torch.no_grad():
        ref = render_frame(ts, cam, settings, init_frame_state(1024, "cpu"), ids, 3)
    mtd = settings.max_total_depth
    # K10 serves both legs of a bounce; K9 the nearest leg and its any-hit
    # instance the shadow leg.
    used = ({"intersect_clusters": 2 * mtd} if search == "K10"
            else {"intersect_walk": mtd, "occluded_walk": mtd})
    assert {k: len(v) for k, v in recorded.items()} == used
    for name in used:
        monkeypatch.setattr(cuda_phong, name, lambda *a, _it=iter(recorded[name]), **k: next(_it))
    with torch.no_grad(), HostReadGuard():
        got = render_frame(ts, cam, settings, init_frame_state(1024, "cpu"), ids, 3)
    for a, b in zip((*got.rgb, got.depth), (*ref.rgb, ref.depth)):
        assert torch.equal(a, b)
    o, d = (_t3(a) for a in _rays("box_sphere", 1000, 4))
    alive = torch.ones(1000, dtype=torch.bool)
    cl = ts.clusters
    with HostReadGuard():
        staged = cuda_phong.sorted_lists(o, d, cl, alive)
        cuda_phong.cluster_boxes(cl)
        torch.argsort(coherence_keys(o, d, *ts.bvh.root))
    assert sorted(staged[3].tolist()) == list(range(1000))
    # The CPU walks each ray alone.
    assert ray_order(o, d, ts.bvh) is None


def test_pathtracer_runs_a_phong_frame_through_its_static_step():
    """(f) ``PathTracer`` on the CPU: a Phong frame goes through the static
    step (``graph`` is the step, eager here), bitwise ``render_frame`` over
    two frames."""
    scene, _ = _build("box_sphere", 2)
    settings = bench.bench_settings(16, phong_tessellation=ALPHA)
    pt = PathTracer(scene, settings, device="cpu", lane_order="scanline")
    ts = to_torch(scene, "cpu")
    ref = init_frame_state(16 * 16, "cpu")
    for i in range(2):
        pt.render(CAM, frame_seed=i)
        with torch.no_grad():
            ref = render_frame(ts, camera_to_torch(CAM, "cpu"), pt.settings, ref, pt.pixel_ids,
                               i, max_leaf=pt.max_leaf)
        assert all(torch.equal(a, b) for a, b in zip((*pt.state.rgb, pt.state.depth),
                                                    (*ref.rgb, ref.depth)))
    assert pt.graph is not None and pt.graph.graph is None and pt.sample_count == 2


# ------------------------------------------------------ the face table --

def test_face_table_layout_and_padding():
    """``phong_records``: each face's v0, e1, e2, n0, n1, n2 and flat flag
    in its row (the kernels' five 16-byte words), zero flat faces padding
    it to the clusters' faces; ``to_torch`` builds it for a scene with
    curved faces only."""
    ts, _ = _scene("box_sphere", 2)
    tab, tris = ts.phong_records, ts.tris
    nf = tris.mtl.shape[0]
    assert tab.shape == (ts.clusters.count * ts.clusters.size, 20) and tab.is_contiguous()
    for j, v in enumerate((tris.v0, tris.e1, tris.e2, tris.n0, tris.n1, tris.n2)):
        for c in range(3):
            assert torch.equal(tab[:nf, 3 * j + c], v[c])
    assert torch.equal(tab[:nf, 18], phongtess.face_is_flat(tris).float())
    assert not tab[:, 19].any() and (tab[nf:, 18] == 1).all() and not tab[nf:, :18].any()
    assert 0 < int(tab[:nf, 18].sum()) < nf
    flat_scene, _ = scene_from_text(*cornell_sphere(), use_bvh=True)
    flat_scene = flat_scene._replace(tris=flat_scene.tris._replace(
        n1=flat_scene.tris.n0, n2=flat_scene.tris.n0))
    assert to_torch(flat_scene, "cpu").phong_records is None


# ----------------------------------------------- the bounds' op counts --

_NOT_OPS = {"aten.lift_fresh.default", "aten.scalar_tensor.default", "aten._to_copy.default",
            "aten.full_like.default", "aten.zeros_like.default", "aten.ones_like.default",
            "aten.detach.default", "aten.alias.default", "aten.clone.default"}


class _Ops(TorchDispatchMode):
    """Counts the elementwise ops that run (constants and copies aside)."""

    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) not in _NOT_OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_bound_operation_counts_are_the_plain_versions():
    """``OPS_RAY``: the patch test's ray planes and dominant axis;
    ``OPS_PATCH``: the rest of ``phongtess_patch_intersect`` as written, its
    solves and tessellated points stubbed out; each elementwise op of the
    plain version one operation."""
    one = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    v3 = lambda *x: Vec3(*(one(c) for c in x))  # noqa: E731
    o, d = v3(0.1, 0.2, 0.3), v3(0.3, -0.5, 0.8)
    with _Ops() as ray:
        phongtess._ray_planes(o, d)
        phongtess._ray_domain(d)
    assert ray.n == cuda_phong.OPS_RAY
    stubs = dict(
        solve_cubic=lambda *a: (one(0.1), one(0.2), one(0.3), torch.tensor([3])),
        solve_quadratic=lambda *a: (one(0.1), one(0.2), torch.tensor([2])),
        _ray_planes=lambda o, d: (v3(0, 0.6, 0.8), v3(1, 0, 0), one(0.1), one(0.2)),
        _ray_domain=lambda d: torch.tensor([2]),
        _tess=lambda *a: v3(0.1, 0.2, 0.3))
    with um.patch.multiple(phongtess, **stubs):
        args = (o, d, v3(0, 0, 0), v3(1, 0, 0), v3(0, 1, 0), v3(0.1, 0.2, 0.97),
                v3(0.2, 0.1, 0.97), v3(0, 0, 1), ALPHA, one(5.0))
        with _Ops() as patch:
            phongtess.phongtess_patch_intersect(*args)
    assert patch.n == cuda_phong.OPS_PATCH
