"""Kernel K9's design for the H100 (``csrc/phong_walk.cu``), on the CPU:
its dealt leaf order and its any-hit instance, the Phong shadow leg.

- a scalar emulation of the kernel's loop order, a warp of 32 lanes at a
  time (the while-while walk to each lane's next hit leaf; at a leaf step
  each lane's flat faces tested inline against its leaf-start bound; where
  every lane at a leaf stands at the same leaf, each lane's curved faces
  in order, else the curved (lane, face) pairs queued in ballot order and
  drained 32 at a time, each against its owner's leaf-start bound; the (t,
  face) key merge), is bitwise the plain walk, nearest and any-hit, with
  an ``alive`` mask, on scenes with faces repeated so that two faces meet a
  ray at equal t within one leaf and across two leaves;
- ``occluded_bvh_phongtess`` is the bit ``intersect_bvh_phongtess(...)[0]
  < t_limit``, with t_limit at, just below and just above each ray's
  nearest t, +inf and 0, and agrees with the JAX package's walk's t <
  t_limit on the live lanes;
- a 32² Phong frame whose shadow leg takes the any-hit walk is bitwise the
  frame whose shadow leg takes the nearest search and t_sh < t_light (the
  JAX package's form, built here).
"""

import json
import os

import numpy as np
import pytest
import torch

from pbr_tpu.ops import phongtess as J
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.utils.config import BVHConfig as JBVHConfig
from pbr_tpu_torch import bench
from pbr_tpu_torch.models import integrator
from pbr_tpu_torch.models.pathtracer import init_frame_state, render_frame
from pbr_tpu_torch.ops import cuda_phong, phongtess
from pbr_tpu_torch.ops.intersect import EPS5, INF, slab_box
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.device import camera_to_torch
from pbr_tpu_torch.tools import k9_walk
from pbr_tpu_torch.utils.config import BVHConfig
from test_torch_phong_kernels import ALPHA, CAM, MTL, _key, _rays, _scene, _t3, two_spheres

torch.set_num_threads(1)

WARP = 32
ORDER_RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs",
                            "K9_ORDER_H100.json")


def emulate_dealt_walk(o: Vec3, d: Vec3, bvh, faces, alpha, max_leaf: int, alive=None,
                       t_limit=None):
    """K9's loop order, a warp of 32 rays at a time. Each lane steps
    through nodes to its next hit leaf (bound > t_near: the running best t,
    or t_limit); at the step the lanes at leaves test their flat faces
    themselves, in ascending order, the first of the least t below the
    leaf-start bound (any-hit: up to the first occluder); then the curved
    faces: where every lane at a leaf stands at the same leaf and its own
    loop takes no more face steps than the deal would take drains, each
    lane tests its own in order; else, face by face of the longest leaf, the
    lanes' curved pairs join the queue in lane order, and whenever 32 wait
    the last 32 are drained (then the rest). Either way each is tested
    against its ray's leaf-start bound, a t below it merged into the ray's
    least (t, face) key with its u and v (any-hit: a flag). The leaf's
    winner is the least key of its flat and curved faces. Returns ``((t,
    face, u, v) or occluded, (curved tests dealt, drains, dealt face steps
    with a curved pair, curved tests of one-leaf steps, their face
    steps))``."""
    fc = phongtess.record_faces(faces)
    flat = fc.flat.tolist()
    n = o.x.shape[0]
    lf, lc, ex = (a.tolist() for a in (bvh.leaf_first, bvh.leaf_count, bvh.exit))
    any_hit = t_limit is not None
    t_out = np.full(n, np.inf, np.float32)
    f_out = np.full(n, -1, np.int32)
    u_out, v_out = np.zeros(n, np.float32), np.zeros(n, np.float32)
    occ = np.zeros(n, bool)
    stats = [0, 0, 0, 0, 0]
    ray = lambda r: (Vec3(*(c[r:r + 1] for c in o)), Vec3(*(c[r:r + 1] for c in d)))  # noqa

    def test(r, f, bound):
        o1, d1 = ray(r)
        t, u, v, valid = phongtess._face_hit(o1, d1, fc, f, alpha, torch.tensor([float(bound)]))
        return (np.float32(float(t)) if bool(valid) else np.float32(np.inf)), \
            np.float32(float(u)), np.float32(float(v))

    def node_hit(r, i, bound):
        o1, d1 = ray(r)
        inv = Vec3(1.0 / d1.x, 1.0 / d1.y, 1.0 / d1.z)
        lo, hi = bvh.bb_min[:, i:i + 1], bvh.bb_max[:, i:i + 1]
        t_near, t_far, hit = slab_box(o1, inv, Vec3(*lo), Vec3(*hi))
        return bool(hit & (t_far > EPS5) & (lo[0] <= hi[0]) & (torch.tensor([float(bound)]) > t_near))

    for w0 in range(0, n, WARP):
        lanes = list(range(w0, min(w0 + WARP, n)))
        live = {r: alive is None or bool(alive[r]) for r in lanes}
        cur = {r: 0 if live[r] else bvh.count for r in lanes}
        bound = {r: np.float32(t_limit[r]) if any_hit and live[r] else np.float32(np.inf)
                 for r in lanes}
        while True:
            at = {}
            for r in lanes:
                while cur[r] < bvh.count:
                    i = cur[r]
                    hit = node_hit(r, i, bound[r])
                    if hit and lf[i] >= 0:
                        at[r] = (lf[i], min(lc[i], max_leaf))
                        break
                    cur[r] = i + 1 if hit else ex[i]
            if not at:
                break
            start = {r: bound[r] for r in at}
            flat_best, key, flag = {}, {}, {}
            for r, (first, cnt) in at.items():
                t_flat, f_flat = start[r], -1
                for k in range(cnt):
                    if any_hit and occ[r]:
                        break
                    if flat[first + k]:
                        t = test(r, first + k, start[r])[0]
                        if t < t_flat:
                            t_flat, f_flat = t, first + k
                            occ[r] = any_hit
                flat_best[r] = (t_flat, f_flat)

            def merge(pairs):
                for r, f in pairs:
                    t, u, v = test(r, f, start[r])
                    if t < start[r]:
                        flag[r] = True
                        kk = _key(t, f)
                        if r not in key or kk < key[r][0]:
                            key[r] = (kk, t, f, u, v)

            steps = [[(r, first + k) for r, (first, cnt) in at.items()
                      if k < cnt and not (any_hit and occ[r]) and not flat[first + k]]
                     for k in range(max(cnt for _, cnt in at.values()))]
            pairs = sum(len(step) for step in steps)
            most = max(sum(any(r == q for q, _ in step) for step in steps) for r in at)
            if len({first for first, _ in at.values()}) == 1 and -(-pairs // WARP) >= most:
                for step in steps:  # one leaf: each lane its own face of a step
                    merge(step)
                    stats[3] += len(step)
                    stats[4] += bool(step)
            else:
                queue = []
                for step in steps:
                    stats[0] += len(step)
                    stats[2] += bool(step)
                    queue += step
                    if len(queue) >= WARP:
                        queue, top = queue[:-WARP], queue[-WARP:]
                        stats[1] += 1
                        merge(top)
                if queue:
                    stats[1] += 1
                    merge(queue)
            for r in at:
                if any_hit:
                    occ[r] |= flag.get(r, False)
                    cur[r] = bvh.count if occ[r] else cur[r] + 1
                    continue
                t_flat, f_flat = flat_best[r]
                if r in key and (f_flat < 0 or key[r][0] < _key(t_flat, f_flat)):
                    _, bound[r], f_out[r], u_out[r], v_out[r] = key[r]
                elif f_flat >= 0:
                    bound[r], f_out[r], u_out[r], v_out[r] = t_flat, f_flat, 0.0, 0.0
                cur[r] += 1
        for r in lanes:
            t_out[r] = bound[r]
    if any_hit:
        return torch.from_numpy(occ), tuple(stats)
    return tuple(torch.from_numpy(a) for a in (t_out, f_out, u_out, v_out)), tuple(stats)


def _repeat_faces(text: str, picks, copies: int = 3) -> str:
    """``text`` with each face line of ``picks`` (indices among the face
    lines) repeated to ``copies`` lines in all, at the end."""
    faces = [ln for ln in text.splitlines() if ln.startswith("f ")]
    return text + "\n".join(faces[i] for i in picks for _ in range(copies - 1)) + "\n"


# Face lines of two_spheres(): the floor's two, then sphere a's (its
# north cap first), then sphere b's.
_TIED = (0, 2, 3, 4, 5, 6, 7, 30, 31)


def _tie_scene(leaf: int):
    """two_spheres with a floor face and eight faces of the left sphere
    (the north cap and two faces below it) each laid three times, built
    with ``leaf``-face leaves: (port scene on the CPU, JAX scene)."""
    text = (_repeat_faces(two_spheres(), _TIED), MTL, "")
    kw = dict(use_bvh=True, phong_tess_alpha=ALPHA)
    return (to_torch(scene_from_text(*text, bvh_cfg=BVHConfig(max_faces=leaf), **kw)[0], "cpu"),
            jax_scene_from_text(*text, bvh_cfg=JBVHConfig(max_faces=leaf), **kw)[0])


def _tie_rays(n: int, seed: int):
    """Rays from above: two in three onto the left sphere's cap around its
    first segments (where the repeated faces lie), one in three onto the
    floor."""
    rng = np.random.default_rng(seed)
    th, ph = rng.uniform(0.02, 0.6, n), rng.uniform(0.02, 0.55, n)
    aim = np.stack([-0.5 + 0.45 * np.sin(th) * np.cos(ph), 0.45 + 0.45 * np.cos(th),
                    0.45 * np.sin(th) * np.sin(ph)])
    floor = np.arange(n) % 3 == 2
    aim[:, floor] = np.stack([rng.uniform(-1.5, 1.5, floor.sum()), np.zeros(floor.sum()),
                              rng.uniform(-1.5, 1.5, floor.sum())])
    o = np.stack([rng.uniform(-1.0, 0.6, n), np.full(n, 2.2), rng.uniform(-0.5, 0.7, n)])
    d = aim - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


def _copies(ts):
    """{face: its copies (itself too)} of the faces laid more than once."""
    key = torch.stack([*ts.tris.v0, *ts.tris.e1, *ts.tris.e2], dim=1)
    groups = {}
    for f, row in enumerate(key.tolist()):
        groups.setdefault(tuple(row), []).append(f)
    return {f: g for g in groups.values() if len(g) > 1 for f in g}


def _leaf_of(bvh) -> dict:
    """{face: its leaf node}."""
    out = {}
    for i, (first, cnt) in enumerate(zip(bvh.leaf_first.tolist(), bvh.leaf_count.tolist())):
        if first >= 0:
            out.update({f: i for f in range(first, first + cnt)})
    return out


_TIES = {}


def _ties(leaf: int):
    if leaf not in _TIES:
        _TIES[leaf] = _tie_scene(leaf)
    return _TIES[leaf]


@pytest.mark.parametrize("leaf, n", [(2, 64), (64, 32)])
def test_k9_dealt_order_is_the_plain_walk_with_ties(leaf, n):
    """The kernel's loop order (one-leaf steps and dealt steps), emulated,
    against the plain walk, bitwise (t, face, u, v), with an ``alive``
    mask, on faces laid three times: with
    2-face leaves a ray meets copies at equal t across two leaves, with
    64-face leaves within one leaf, and the walk keeps the copy it met
    first (the least face of a leaf). The curved tests take no more drains
    than each lane's own loop would take face steps, and fewer on the
    64-face leaves."""
    ts, _ = _ties(leaf)
    copies, leaf_of = _copies(ts), _leaf_of(ts.bvh)
    assert len(copies) == 3 * len(_TIED)
    ml = ts.bvh_leaf_max
    o, d = (_t3(a) for a in _tie_rays(n, 5 + leaf))
    alive = torch.from_numpy(np.arange(n) % 7 != 3)
    args = (o, d, ts.bvh, ts.phong_records, ALPHA)
    emu, (tests, drains, steps, own_tests, own_steps) = emulate_dealt_walk(*args, ml, alive)
    plain = cuda_phong.intersect_walk(*args, alive=alive)
    for a, b in zip(emu, plain):
        assert torch.equal(a, b)
    assert (plain[1][~alive] == -1).all() and (plain[1][alive] >= 0).float().mean() > 0.6
    # The ties: winners with a copy, each copy at the winner's t.
    tied = [r for r, f in enumerate(plain[1].tolist()) if f in copies]
    fc = phongtess.record_faces(ts.phong_records)
    same_leaf = across = 0
    for r in tied:
        f = int(plain[1][r])
        o1, d1 = Vec3(*(c[r:r + 1] for c in o)), Vec3(*(c[r:r + 1] for c in d))
        for g in copies[f]:
            t, _, _, valid = phongtess._face_hit(o1, d1, fc, g, ALPHA, torch.tensor([INF]))
            assert bool(valid) and torch.equal(t, plain[0][r:r + 1])
            if g != f:
                same_leaf += leaf_of[g] == leaf_of[f]
                across += leaf_of[g] != leaf_of[f]
        assert f == min(g for g in copies[f] if leaf_of[g] == leaf_of[f])
    assert len(tied) >= 8 and (same_leaf if leaf == 64 else across) > 0
    # The dealt steps ran, and on the 2-face leaves one-leaf steps too. The
    # dealt steps' drains against the face steps of the lanes' own loops: no
    # more anywhere, fewer where 64-face leaves put the lanes at different
    # leaves with many curved faces.
    assert tests > 0 and own_steps <= own_tests and (own_steps > 0 or leaf == 64)
    assert drains <= steps and (drains < steps or leaf == 2)


@pytest.mark.parametrize("leaf, n", [(2, 48), (64, 32)])
def test_k9_any_hit_dealt_order_is_the_plain_walk(leaf, n):
    """The any-hit instance's loop order, emulated (flat faces first, no
    curved pair queued for a lane a flat face occludes, the ray ended at
    its first occluding leaf), against ``occluded_bvh_phongtess``, bitwise,
    with an ``alive`` mask and t_limit around each ray's nearest t."""
    ts, _ = _ties(leaf)
    o, d = (_t3(a) for a in _tie_rays(n, 9 + leaf))
    alive = torch.from_numpy(np.arange(n) % 5 != 1)
    args = (o, d, ts.bvh, ts.phong_records, ALPHA)
    t_near = cuda_phong.intersect_walk(*args)[0]
    scale = torch.from_numpy(np.random.default_rng(leaf).uniform(0.5, 1.5, n).astype(np.float32))
    t_limit = torch.where(torch.isfinite(t_near), t_near * scale, 1.0e3)
    emu, stats = emulate_dealt_walk(*args, ts.bvh_leaf_max, alive, t_limit)
    plain = cuda_phong.occluded_walk(o, d, t_limit, *args[2:], alive=alive)
    assert torch.equal(emu, plain)
    # Dealt steps ran; so did one-leaf steps on the 2-face leaves.
    assert stats[0] > 0 and (stats[3] > 0 or leaf == 64)
    assert not plain[~alive].any() and 0.2 < float(plain[alive].float().mean()) < 0.8


def _limits(t: torch.Tensor) -> dict:
    """t_limit at, just below and just above each ray's nearest t, +inf
    and 0."""
    return {"at": t, "below": torch.nextafter(t, torch.zeros_like(t)),
            "above": torch.nextafter(t, torch.full_like(t, INF)),
            "inf": torch.full_like(t, INF), "zero": torch.zeros_like(t)}


@pytest.mark.parametrize("name, leaf, n", [("box_sphere", 2, 200), ("two_spheres", 2, 200),
                                           ("two_spheres", 64, 120)])
def test_occluded_walk_is_the_nearest_walks_bit(name, leaf, n):
    """``occluded_bvh_phongtess`` (and ``occluded_walk`` on the CPU) gives
    ``intersect_bvh_phongtess(...)[0] < t_limit`` bitwise at every t_limit
    of ``_limits``, with an ``alive`` mask; its ``work`` counts no more
    face tests than the nearest walk's. Against the JAX package's walk, t
    < t_limit on the live lanes at t_limit drawn around the JAX t: the bits
    agree on at least 0.95 of them (the agreement of the K9 test)."""
    ts, jscene = _scene(name, leaf)
    o, d = _rays(name, n, 21 + leaf)
    alive = torch.from_numpy(np.arange(n) % 6 != 4)
    args = (ts.bvh, None, ALPHA)
    kw = dict(faces=ts.phong_records, alive=alive)
    t_near = phongtess.intersect_bvh_phongtess(_t3(o), _t3(d), *args, **kw)[0]
    assert float(torch.isfinite(t_near[alive]).float().mean()) > 0.5
    for what, t_limit in _limits(t_near).items():
        work_any, work_near = {}, {}
        got = phongtess.occluded_bvh_phongtess(_t3(o), _t3(d), t_limit, *args, work=work_any,
                                               **kw)
        ref = phongtess.intersect_bvh_phongtess(_t3(o), _t3(d), *args, work=work_near,
                                                **kw)[0] < t_limit
        assert torch.equal(got, ref & alive), what
        assert torch.equal(got, cuda_phong.occluded_walk(_t3(o), _t3(d), t_limit, ts.bvh,
                                                         ts.phong_records, ALPHA, alive=alive))
        hits = what in ("above", "inf")
        assert torch.equal(got, alive & torch.isfinite(t_near) if hits else alive & False)
        if what == "inf":  # up to each ray's first occluder
            tests = [w["flat"] + w["curved"] for w in (work_any, work_near)]
            assert 0 < tests[0] < tests[1] and work_any["visits"] < work_near["visits"]
    with np.errstate(all="ignore"):
        jt = J.intersect_bvh_phongtess(np, JVec3(*o), JVec3(*d), jscene.bvh, jscene.tris,
                                       np.float32(ALPHA), max_leaf=ts.bvh_leaf_max)[0]
    jt = np.asarray(jt, np.float32)
    scale = np.random.default_rng(leaf + 1).uniform(0.5, 1.5, n).astype(np.float32)
    lim = np.where(np.isfinite(jt), jt * scale, np.float32(10.0)).astype(np.float32)
    got = phongtess.occluded_bvh_phongtess(_t3(o), _t3(d), torch.from_numpy(lim), *args,
                                           **kw).numpy()
    live = alive.numpy()
    assert (got[live] == (jt < lim)[live]).mean() >= 0.95
    assert 0.2 < got[live].mean() < 0.9


def test_phong_frame_with_the_any_hit_shadow_leg_is_the_nearest_legs():
    """A 32² Phong frame (NEE, 8 bounces) under the card's band (every pass
    walks K9's plain version): its shadow legs take the any-hit walk, and
    the frame is bitwise the frame whose shadow leg takes the nearest
    search and t_sh < t_light, on the lanes that cast (the JAX package's
    form, on the port's mask)."""
    ts, _ = _scene("box_sphere", 2)
    settings = bench.bench_settings(32, phong_tessellation=ALPHA)
    cam = camera_to_torch(CAM, "cpu")
    ids = torch.arange(32 * 32, dtype=torch.int32)
    calls = []
    real_walk = cuda_phong.occluded_walk
    real_leg = integrator._shadow_occluded

    def frame():
        with torch.no_grad():
            return render_frame(ts, cam, settings, init_frame_state(1024, "cpu"), ids, 4)

    def nearest_leg(tris, hit_p, l_dir, t_light, casts, mode, tables, pt_alpha=0.0,
                    pt_faces=None):
        t_sh = phongtess.intersect_scene_phongtess(
            hit_p, l_dir, tris, pt_alpha, bvh=tables["bvh"], clusters=tables["clusters"],
            max_leaf=tables["max_leaf"], alive=casts, faces=pt_faces)[0]
        return t_sh < t_light

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(phongtess, "CLUSTER_MIN_RAYS", None)
        mp.setattr(cuda_phong, "occluded_walk",
                   lambda *a, **k: (calls.append(a[0].x.shape[0]), real_walk(*a, **k))[1])
        got = frame()
        assert calls == [1024] * settings.max_total_depth
        mp.setattr(integrator, "_shadow_occluded", nearest_leg)
        ref = frame()
        assert len(calls) == settings.max_total_depth
    assert integrator._shadow_occluded is real_leg
    for a, b in zip((*got.rgb, got.depth), (*ref.rgb, ref.depth)):
        assert torch.equal(a, b)
    assert float(got.rgb.x.mean()) > 0.0


@pytest.mark.parametrize("kind", k9_walk.KINDS)
def test_pass_kinds_choose_the_launch_order(kind):
    """Every kind of Phong pass launches the rays as given: the card's
    order record (``docs/K9_ORDER_H100.json``) sorts no kind, and the
    kind's wrapper (``intersect_walk`` for the camera and bounce passes,
    ``occluded_walk`` for the shadow legs) takes no order argument and on
    the CPU is its plain version."""
    with open(ORDER_RECORD) as f:
        rec = json.load(f)
    policy = k9_walk.order_policy(rec)
    assert kind not in policy["sort"] and policy["wins"][kind] is False
    ts, _ = _scene("box_sphere", 2)
    o, d = (_t3(a) for a in _rays("box_sphere", 64, 2))
    args = (ts.bvh, None, ALPHA)
    kw = dict(faces=ts.phong_records)
    t_near = phongtess.intersect_bvh_phongtess(o, d, *args, **kw)[0]
    if kind == "shadow":
        t_limit = torch.where(torch.isfinite(t_near), t_near * 1.1, 1.0e3)
        got = (cuda_phong.occluded_walk(o, d, t_limit, ts.bvh, ts.phong_records, ALPHA),)
        ref = (phongtess.occluded_bvh_phongtess(o, d, t_limit, *args, **kw),)
    else:
        got = cuda_phong.intersect_walk(o, d, ts.bvh, ts.phong_records, ALPHA)
        ref = phongtess.intersect_bvh_phongtess(o, d, *args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(TypeError):
        cuda_phong.intersect_walk(o, d, ts.bvh, ts.phong_records, ALPHA, kind=kind)


def test_tool_launch_orders_are_permutations_with_dead_lanes_last():
    """The cheaper launch orders ``tools/k9_walk.py`` measures beside the
    sort are permutations of the lanes with the dead ones last: "live"
    keeps the lane order within the live and within the dead lanes,
    "octant" within each octant."""
    o, d = (_t3(a) for a in _rays("box_sphere", 300, 8))
    alive = torch.from_numpy(np.random.default_rng(3).random(300) < 0.4)
    live = k9_walk.live_order(alive).tolist()
    assert live == [i for i in range(300) if alive[i]] + [i for i in range(300) if not alive[i]]
    octant = k9_walk.octant_order(d, alive)
    assert octant.dtype == torch.int32 and sorted(octant.tolist()) == list(range(300))
    key = (d.x < 0).int() + 2 * (d.y < 0).int() + 4 * (d.z < 0).int()
    key = torch.where(alive, key, 8)[octant.long()]
    assert (key[1:] >= key[:-1]).all() and int((key < 8).sum()) == int(alive.sum())
    assert k9_walk.live_order(None) is None
