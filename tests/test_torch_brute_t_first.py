"""Kernels K1's and K2's sweep (``csrc/brute_intersect.cu::
brute_intersect_kernel``), modelled in torch ops on the CPU: t first
against a running bound (nearest: the best t so far; shadow: t_light), u
and v only where ``1e-5 <= t < bound``, each staged chunk padded with
all-zero records to whole batches, and on the shadow leg a lane leaving at
its first occluder, a 32-lane warp once all its lanes have, and a block at
the first chunk boundary where all its rays are occluded. The model follows
the kernel's rule face by face and is held bitwise to
``cuda_intersect.intersect_fused_plain`` for both forms (the (9, F)
classic table, the (16, F) linear one), nearest and NEE, on adversarial
inputs: duplicate faces, rays parallel to faces, faces behind the ray and
t exactly 1e-5, degenerate faces, NaN and inf rays, missed lanes and
t_light = 0, and face counts on both sides of the kernel's staged chunk.
A padding record never passes. The kernel itself runs only on a card
(``test_torch_intersect.py``'s ``cuda``-marked test)."""

import re

import numpy as np
import pytest
import torch

from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.intersect import EPS5, INF
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import TrianglesSoA

torch.set_num_threads(1)
WARP = 32
_SRC = (ci.CSRC / "brute_intersect.cu").read_text()


def _const(pattern: str) -> tuple:
    """The kernel's compile-time constants matched by ``pattern``."""
    m = re.search(pattern, _SRC)
    assert m is not None, f"brute_intersect.cu has no match for {pattern!r}"
    return tuple(int(g) for g in m.groups())


(THREADS,), (CHUNK,) = _const(r"constexpr int kThreads = (\d+);"), _const(
    r"constexpr int kChunk = (\d+);")
BATCH_LIN, BATCH_MT = _const(r"kBatch = LIN \? (\d+) : (\d+);")
LIGHT = (0.0, 1.8, 0.2)


def _face_test(o: Vec3, d: Vec3, c, col: torch.Tensor, bound: torch.Tensor):
    """One face (a column of the table) against every ray, as the kernel
    tests it: ``(hit, t, below)``, hit = valid and t < bound. det, t's
    numerator, 1 / det and t first (mt.cuh::mt_t; mt_lin.cuh::lin_det,
    lin_tnum); u and v (mt_uv, lin_uv) only where ``below``, 1e-5 <= t <
    bound. torch evaluates every element; ``below`` says which of them the
    kernel computes u and v for."""
    if col.shape[0] == 16:
        m0, m1, m2, km, w0, w1, w2, q0, q1, q2, e1x, e1y, e1z, e2x, e2y, e2z = col
        det = d.x * m0 + d.y * m1 + d.z * m2
        tnum = km - (o.x * m0 + o.y * m1 + o.z * m2)
    else:
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = col
        px, py, pz = d.y * e2z - d.z * e2y, d.z * e2x - d.x * e2z, d.x * e2y - d.y * e2x
        det = e1x * px + e1y * py + e1z * pz
        tx, ty, tz = o.x - v0x, o.y - v0y, o.z - v0z
        qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
        tnum = e2x * qx + e2y * qy + e2z * qz
    inv = 1.0 / det
    t = tnum * inv
    below = (t >= EPS5) & (t < bound)
    if col.shape[0] == 16:
        u = ((e2x * c.x + e2y * c.y + e2z * c.z) - (d.x * w0 + d.y * w1 + d.z * w2)) * inv
        v = (-(e1x * c.x + e1y * c.y + e1z * c.z) - (d.x * q0 + d.y * q1 + d.z * q2)) * inv
    else:
        u = (tx * px + ty * py + tz * pz) * inv
        v = (d.x * qx + d.y * qy + d.z * qz) * inv
    return below & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0), t, below


def _chunks(table: torch.Tensor):
    """Each staged chunk: (first face id, its columns padded with zero
    records to whole batches, its real faces)."""
    batch = BATCH_LIN if table.shape[0] == 16 else BATCH_MT
    for base in range(0, table.shape[1], CHUNK):
        cols = table[:, base:base + CHUNK]
        pad = torch.zeros((table.shape[0], -cols.shape[1] % batch))
        yield base, torch.cat([cols, pad], dim=1), cols.shape[1]


def _t_first_model(o: Vec3, d: Vec3, table: torch.Tensor, light=None):
    """The kernel's sweep; returns its outputs and what it executed:
    nearest and shadow tests, u-v tests, and the shadow tests left out by
    the lane, warp and block exits. Asserts that no padding record
    passes."""
    n, nf = o.x.shape[0], table.shape[1]
    lin = table.shape[0] == 16
    stats = dict.fromkeys(("tests", "uv", "shadow_tests", "shadow_uv", "lane_exits",
                           "warp_exits", "block_exits"), 0)
    c = ci.cross_od(o, d) if lin else None
    best = torch.full((n,), INF)
    face = torch.full((n,), -1, dtype=torch.int32)
    for base, cols, real in _chunks(table):
        for k in range(cols.shape[1]):
            hit, t, below = _face_test(o, d, c, cols[:, k], best)
            assert k < real or not bool(hit.any()), "a padding record passed"
            stats["tests"] += n
            stats["uv"] += int(below.sum())
            best = torch.where(hit, t, best)
            face = torch.where(hit, torch.tensor(base + k, dtype=torch.int32), face)
    if light is None:
        return (best, face), stats
    hit_p, s_dir, t_light = ci._shadow_ray(o, d, best, light)
    sc = ci.cross_od(hit_p, s_dir) if lin else None
    # Lanes padded to whole blocks: [block, thread] is ray block * THREADS +
    # thread; a ray past the tail is done.
    n_blocks = -(-n // THREADS)
    occ = torch.ones(n_blocks * THREADS, dtype=torch.bool)
    occ[:n] = False
    block_open = torch.ones(n_blocks, dtype=torch.bool)
    restage = nf > CHUNK  # a one-chunk table is swept with no barrier
    for base, cols, real in _chunks(table):
        if restage:  # the block's barrier at each chunk
            done = occ.reshape(n_blocks, THREADS).all(dim=1)
            stats["block_exits"] += int((block_open & done).sum())
            block_open &= ~done
        for k in range(cols.shape[1]):
            lanes = occ.reshape(n_blocks, -1, WARP)
            warp_open = (~lanes).any(dim=2, keepdim=True).expand_as(lanes)
            in_block = block_open[:, None, None].expand_as(lanes)
            live = (in_block & warp_open).reshape(-1)[:n]
            stats["warp_exits"] += int((in_block & ~warp_open).reshape(-1)[:n].sum())
            stats["lane_exits"] += int((live & occ[:n]).sum())
            active = live & ~occ[:n]
            hit, t, below = _face_test(hit_p, s_dir, sc, cols[:, k], t_light)
            assert k < real or not bool(hit.any()), "a padding record passed"
            stats["shadow_tests"] += int(active.sum())
            stats["shadow_uv"] += int((active & below).sum())
            occ[:n] |= active & hit
    return (best, face, occ[:n]), stats


def _tris(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> TrianglesSoA:
    """Triangles from (3, F) float32 arrays (the normals are not read)."""
    vec = lambda a: Vec3(*(torch.tensor(np.ascontiguousarray(r)) for r in a))  # noqa: E731
    return TrianglesSoA(vec(v0), vec(e1), vec(e2), vec(v0), vec(v0), vec(v0),
                        torch.zeros(v0.shape[1], dtype=torch.int32))


def _soup(nf: int, rng) -> tuple:
    """``nf`` random small triangles in the cube [-1, 1]^3."""
    v0 = rng.uniform(-1.0, 1.0, (3, nf))
    e1, e2 = rng.uniform(-0.3, 0.3, (2, 3, nf))
    return tuple(a.astype(np.float32) for a in (v0, e1, e2))


def _rays(n: int, rng) -> tuple:
    """Origins in the cube, unit directions (a ragged last block)."""
    o = rng.uniform(-0.9, 0.9, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _cat(*parts) -> tuple:
    return tuple(np.concatenate(p, axis=1).astype(np.float32) for p in zip(*parts))


def _case(name: str) -> tuple:
    """(faces (v0, e1, e2), rays (o, d), light) of one adversarial case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    o, d = _rays(300, rng)
    faces = _soup(64, rng)
    light = LIGHT
    if name == "duplicates":
        # every face again later, and some twice in a row: an equal t at a
        # larger face id must lose
        v0, e1, e2 = faces
        faces = _cat(faces, (v0[:, :8], e1[:, :8], e2[:, :8]), faces)
    elif name == "parallel":
        # faces in planes z = const and rays with d.z = 0, +0, -0 or
        # denormal: det is +-0 or denormal
        v0, e1, e2 = faces
        e1[2], e2[2] = 0.0, 0.0
        d[2, ::3] = 0.0
        d[2, 1::3] = -0.0
        d[2, 2::6] = 1e-40
    elif name == "behind_and_eps":
        # a quad on z = 0 that rays reach at t = 1e-5 exactly (origin at
        # z = -1e-5, d = +z: tnum = -4e-5, det = -4), just below and just
        # above, and rays facing away from it (t < 0)
        quad = (np.array([[-1.0, 1.0], [-1.0, 1.0], [0.0, 0.0]]),
                np.array([[2.0, -2.0], [0.0, 0.0], [0.0, 0.0]]),
                np.array([[0.0, 0.0], [2.0, -2.0], [0.0, 0.0]]))
        faces = _cat(quad, faces)
        k = np.arange(120)
        o[:, :120] = rng.uniform(-0.5, 0.5, (3, 120))
        o[2, :120] = np.float32(-1e-5) * np.where(k % 3 == 0, 1.0, np.where(k % 3 == 1, 0.99,
                                                                           1.01))
        d[:, :120] = 0.0
        d[2, :120] = np.where(k % 4 == 3, -1.0, 1.0)
    elif name == "degenerate":
        # e1 = 0, e2 = 0, e1 = e2: det and tnum are 0
        v0, e1, e2 = faces
        e1[:, ::4] = 0.0
        e2[:, 1::4] = 0.0
        e2[:, 2::4] = e1[:, 2::4]
    elif name == "nan_inf":
        o[0, ::7] = np.nan
        d[1, 1::7] = np.inf
        d[2, 2::7] = -np.inf
        o[2, 3::7] = np.inf
        d[:, 4::7] = 0.0
        d[0, 5::7] = np.nan
    elif name == "missed_and_t_light_0":
        # rays leaving the soup upwards (missed: ts = 1) and rays whose
        # missed end point o + d is the light itself (t_light = 0)
        light = (0.5, 4.0, 0.25)
        o[:, :100] = rng.uniform(-0.5, 0.5, (3, 100))
        o[1, :100] = 2.0
        d[:, :100] = np.array([[0.0], [1.0], [0.0]])
        o[:, 100:150] = np.array([[0.5], [3.0], [0.25]])
        d[:, 100:150] = np.array([[0.0], [1.0], [0.0]])
    elif name == "all_occluded":
        # a ceiling (face 0, one large triangle) between every ray and the
        # light, then more than a chunk of faces: every block leaves the
        # shadow leg at its second chunk; the rays point down, so that no
        # hit point lies on the ceiling
        light = (0.0, 10.0, 0.0)
        d[1] = -np.abs(d[1])
        ceiling = (np.array([[-1e3], [5.0], [-1e3]]), np.array([[4e3], [0.0], [0.0]]),
                   np.array([[0.0], [0.0], [4e3]]))
        faces = _cat(ceiling, _soup(CHUNK + 100, rng))
    elif name.startswith("faces="):
        faces = _soup(int(name.split("=")[1]), rng)
        o, d = _rays(THREADS + 77, rng)
    else:
        raise KeyError(name)
    return faces, (o, d), light


CASES = ["duplicates", "parallel", "behind_and_eps", "degenerate", "nan_inf",
         "missed_and_t_light_0", "all_occluded"] + [
    f"faces={k}" for k in (1, 255, 256, 257, 511, 512, 513, 4000)]


@pytest.mark.parametrize("variant", ["mt", "lin"])
@pytest.mark.parametrize("name", CASES)
def test_t_first_model_matches_plain(name, variant):
    """The t-first sweep with its padding and exits equals the plain
    version bitwise: (t, face) with NEE off, (t, face, occluded) with NEE;
    and it skips u and v on most tests where the case has faces to skip."""
    (v0, e1, e2), (o, d), light = _case(name)
    tris = _tris(v0, e1, e2)
    table = ci.lin_table(tris) if variant == "lin" else ci.face_table(tris)
    o_t, d_t = (Vec3(*map(torch.tensor, np.ascontiguousarray(a))) for a in (o, d))
    light_t = torch.tensor(light, dtype=torch.float32)
    with np.errstate(all="ignore"):
        near, _ = _t_first_model(o_t, d_t, table)
        nee, st = _t_first_model(o_t, d_t, table, light_t)
    ref_near = ci.intersect_fused_plain(o_t, d_t, table)
    ref = ci.intersect_fused_plain(o_t, d_t, table, light_t)
    for a, b in zip((*near, *nee), (*ref_near, *ref)):
        assert torch.equal(a.view(torch.int8) if a.dtype == torch.bool else
                           a.view(torch.int32), b.view(torch.int8) if b.dtype == torch.bool
                           else b.view(torch.int32))
    n, nf = o_t.x.shape[0], table.shape[1]
    assert st["tests"] >= n * nf and st["uv"] < st["tests"]
    assert st["shadow_tests"] <= st["tests"] and st["shadow_uv"] <= st["shadow_tests"]
    if name == "all_occluded":
        assert bool(ref[2].all())
        assert st["block_exits"] == -(-n // THREADS)
        assert st["shadow_tests"] < n * 3
    if name == "behind_and_eps":
        t_eps = ref[0][:120][(np.arange(120) % 3 == 0) & (np.arange(120) % 4 != 3)]
        assert bool((t_eps == np.float32(1e-5)).all())  # t = 1e-5 exactly is a hit
    if nf >= 64 and name not in ("parallel", "degenerate", "nan_inf"):
        assert 0 < st["uv"] < st["tests"] // 2


def test_records_are_the_tables_face_major():
    """K1's records: (F, 12), a face's row {v0, 0}, {e1, 0}, {e2, 0} (K2's
    are the (16, F) lin table transposed)."""
    tris = _tris(*_soup(5, np.random.default_rng(0)))
    faces = ci.face_table(tris)
    rec = ci.face_records(faces)
    assert rec.shape == (5, 12) and rec.is_contiguous()
    assert torch.equal(rec.reshape(5, 3, 4)[:, :, :3].reshape(5, 9), faces.T)
    assert not bool(rec.reshape(5, 3, 4)[:, :, 3].any())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mt", "lin"])
def test_kernel_matches_plain_on_adversarial_cases_on_card(variant):
    """The kernel itself on every adversarial case above: t, face and
    occluded bitwise equal to the plain version on the card (NaN and inf
    rays, det = +-0 and denormal, degenerate and duplicate faces, t = 1e-5
    exactly, t_light = 0, every shadow ray occluded, face counts across the
    staged chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels K1 and K2 have no CPU mode")
    for name in CASES:
        (v0, e1, e2), (o, d), light = _case(name)
        tris = _tris(v0, e1, e2)
        tris = TrianglesSoA(*(Vec3(*(c.cuda() for c in v)) if isinstance(v, Vec3) else v.cuda()
                              for v in tris))
        table = ci.lin_table(tris) if variant == "lin" else ci.face_table(tris)
        o_t, d_t = (Vec3(*(torch.tensor(np.ascontiguousarray(c), device="cuda") for c in a))
                    for a in (o, d))
        lp = Vec3(*(torch.tensor(v, dtype=torch.float32, device="cuda") for v in light))
        got = (*ci.intersect_fused(o_t, d_t, tris, light_pos=lp, variant=variant),
               *ci.intersect_fused(o_t, d_t, tris, variant=variant))
        ref = ci.intersect_fused_plain(o_t, d_t, table, torch.stack(list(lp)))
        torch.cuda.synchronize()
        for a, b in zip(got, (*ref, *ref[:2])):
            assert torch.equal(a, b), name
