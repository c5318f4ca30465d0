"""Phong-tessellation patch intersection on torch tensors.

The counterpart of ``pbr_tpu/ops/phongtess.py`` (the reference's curved-patch
intersector, ``pt_phongtess.cl``, after "Direct Ray Tracing of Phong
Tessellation", Ogaki & Tokuyoshi): a triangle whose vertex normals differ is
a quadratic Phong patch controlled by ``alpha`` (config
``render.phong_tessellation``). The ray becomes two Hesse-form planes, the
patch intersection a cubic in one plane parameter and then quadratics in a
barycentric coordinate, each root polished by Newton.

Everything is elementwise over ray batches with masks in place of the
reference's early-outs, in the JAX version's operation order, on any
device. The JAX package runs its two searches as device loops in XLA
(``jax.lax.while_loop``); on the card the port runs them as kernels K9 and
K10 (``ops/cuda_phong.py``), whose plain versions are the searches here.

- ``solve_cubic`` (and ``solve_quadratic``, its branch without the cubic
  term, which the patch test's second solve is), ``phongtess_patch_intersect``,
  ``phongtess_normal``, ``patch_constants``, ``face_is_flat``;
- ``phong_records``: the searches' face table, 20 floats a face, which
  ``scene/device.py::to_torch`` builds once a scene with curved faces;
- the searches: ``intersect_brute_phongtess`` (all faces), the stackless
  BVH walk ``intersect_bvh_phongtess`` (K9's plain version: a host-driven
  loop, one step a node) and its any-hit form ``occluded_bvh_phongtess``
  (K9 any-hit's), and the cluster search
  ``intersect_clusters_phongtess`` (K10's plain version: rounds over the
  near-to-far lists of ``ops/cull.py::candidates_fine``, each ray culling a
  round's cluster by its box and closing on its own, ``PHONG_CHUNK_RAYS``
  rays at a time);
- ``intersect_scene_phongtess``, their dispatch with a differentiable
  re-evaluation of the winner's t, and ``occluded_scene_phongtess``, the
  shadow leg's;
- the host layer's build-time bounds, NumPy: ``_tess_point`` and
  ``phongtess_face_aabbs`` (copies of the JAX package's, byte-equal).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbr_tpu_torch.ops.intersect import EPS5, INF, gather_vec3, moller_trumbore, slab_box
from pbr_tpu_torch.ops.traverse import detach_tris, leaf_bound
from pbr_tpu_torch.ops.vec import Vec3, f32, project_on_plane, safe_normalized, where3

_THIRD = f32(1.0 / 3.0)
_THIRD_HALF = f32(1.0 / 6.0)
_TWO_PI, _FOUR_PI = f32(2.0 * np.pi), f32(4.0 * np.pi)
_BIG, _BIGN = f32(3.0e38), f32(-3.0e38)

# Rays a chunk of the cluster search's plain version: a multiple of the
# 128-ray tile. A round tests only its active rays, ``_PAIRS`` (ray, face)
# pairs at a time, so a chunk holds only (tile, cluster) tables; its
# rounds are a loop on the host, one pass of launches a chunk, so one chunk
# a 1024² pass.
PHONG_CHUNK_RAYS = 1 << 20
# (ray, face) pairs a batch of the plain cluster search's tests: its
# temporaries are float32 tensors of this many elements (4 MiB).
_PAIRS = 1 << 20
# Rays from which the dispatch takes the cluster search (kernel K10) on a
# scene with clusters; fewer rays walk the BVH (K9), and None sends every
# pass to the walk. The card's band: tools/phong_bands.py's policy of
# docs/PHONG_BANDS_H100.json (tests/test_torch_phong_bands.py holds the two
# equal). On the H100 K9 beat K10 at 4,096 to 1,048,576 rays on both Phong
# scenes, camera and box rays, in every round, and the frames and fit steps
# through K9 beat those through K10. The JAX package takes the cluster
# search from 4,096 rays (pbr_tpu/ops/phongtess.py:496), a TPU choice.
CLUSTER_MIN_RAYS: Optional[int] = None


@contextlib.contextmanager
def threshold(value: Optional[int]):
    """``CLUSTER_MIN_RAYS`` set to ``value`` for the block: the JAX
    package's 4,096 sends the passes of that many rays to the cluster
    search whatever the band."""
    global CLUSTER_MIN_RAYS
    old, CLUSTER_MIN_RAYS = CLUSTER_MIN_RAYS, value
    try:
        yield
    finally:
        CLUSTER_MIN_RAYS = old


def _guard_div(num, den):
    ok = den != 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root with the sign of ``x`` (torch has no ``cbrt``): the
    float64 power of |x|, rounded to float32 once."""
    return torch.copysign(torch.abs(x).double().pow(1.0 / 3.0).to(x.dtype), x)


def solve_quadratic(a1, a2, a3):
    """Roots of a1 x² + a2 x + a3 = 0 with Newton polish: solveCubic's
    branches without the cubic term (pt_utils.cl:108-199), bitwise
    ``solve_cubic`` with a0 = 0. Returns ``(x0, x1, count)``, count in
    {0, 1, 2}; x1 is -1 unless there are two roots."""
    pq = 0.5 * _guard_div(a2, a1)
    qdis = pq * pq - _guard_div(a3, a1)
    qs = torch.sqrt(torch.clamp_min(qdis, 0.0))

    def newton2(x):
        num = a3 + x * (a2 + x * a1)
        den = a2 + x * 2.0 * a1
        return x - _guard_div(num, den)

    q_x0 = newton2(-pq - qs)
    q_x1 = newton2(-pq + qs)
    l_x0 = _guard_div(-a3, a2)
    is_quad = torch.abs(a1) > 0.0
    is_lin = ~is_quad & (torch.abs(a2) > 0.0)
    two_q = is_quad & (qdis >= 0.0)
    x0 = torch.where(two_q, q_x0, l_x0)
    x1 = torch.where(two_q, q_x1, -1.0)
    count = (two_q.to(torch.int32) * 2 + is_lin.to(torch.int32))
    return x0, x1, count


def solve_cubic(a0, a1, a2, a3):
    """Roots of a0 x³ + a1 x² + a2 x + a3 = 0 with Newton polish
    (solveCubic, pt_utils.cl:108-199; ``pbr_tpu/ops/phongtess.py:39``).

    Returns ``(x0, x1, x2, count)``; only the first ``count`` slots are
    meaningful (count in {0, 1, 2, 3}), the others are -1 except x0."""
    w = _guard_div(a1, a0) * _THIRD
    p_lin = _guard_div(a2, a0) * _THIRD - w * w
    p = p_lin * p_lin * p_lin
    q = 0.5 * _guard_div(a2 * w - a3, a0) - w * w * w
    dis = q * q + p

    # three real roots (dis < 0); the reference computes q / sqrt(-p)
    neg_p = torch.clamp_min(-p, 0.0)
    phi = torch.acos(torch.clamp(_guard_div(q, torch.sqrt(neg_p)), -1.0, 1.0))
    pp = 2.0 * torch.pow(neg_p, _THIRD_HALF)
    u0 = pp * torch.cos(phi * _THIRD) - w
    u1 = pp * torch.cos((phi + _TWO_PI) * _THIRD) - w
    u2 = pp * torch.cos((phi + _FOUR_PI) * _THIRD) - w
    c_x0 = torch.minimum(u0, torch.minimum(u1, u2))
    c_x2 = torch.maximum(u0, torch.maximum(u1, u2))
    c_x1 = torch.maximum(torch.minimum(u0, u1),
                         torch.maximum(torch.minimum(u0, u2), torch.minimum(u1, u2)))

    def newton3(x):
        num = a3 + x * (a2 + x * (a1 + x * a0))
        den = a2 + x * (2.0 * a1 + x * 3.0 * a0)
        return x - _guard_div(num, den)

    c_x0, c_x1, c_x2 = newton3(c_x0), newton3(c_x1), newton3(c_x2)

    # single real root (dis >= 0)
    sq = torch.sqrt(torch.clamp_min(dis, 0.0))
    s_x0 = newton3(cbrt(q + sq) + cbrt(q - sq) - w)

    q_x0, q_x1, q_count = solve_quadratic(a1, a2, a3)
    is_cubic = torch.abs(a0) > 0.0
    three = is_cubic & (dis < 0.0)
    one_c = is_cubic & ~three
    x0 = torch.where(three, c_x0, torch.where(one_c, s_x0, q_x0))
    x1 = torch.where(three, c_x1, torch.where(is_cubic, -1.0, q_x1))
    x2 = torch.where(three, c_x2, -1.0)
    count = torch.where(three, 3, torch.where(one_c, 1, q_count)).to(torch.int32)
    return x0, x1, x2, count


def _ray_planes(o: Vec3, d: Vec3):
    """Two planes intersecting in the ray (getPlanesFromRay,
    pt_utils.cl:208-218)."""
    n1 = safe_normalized(o.cross(d))
    n2 = safe_normalized(n1.cross(d))
    return n1, n2, n1.dot(o), n2.dot(o)


def _axis_component(v: Vec3, domain):
    """v[domain] per lane (getBestRayDomain's consumer, pt_phongtess.cl:196)."""
    return torch.where(domain == 0, v.x, torch.where(domain == 1, v.y, v.z))


def _ray_domain(d: Vec3):
    """The axis of |d|'s largest component (ties: y before z, z before x)."""
    ax, ay, az = torch.abs(d.x), torch.abs(d.y), torch.abs(d.z)
    domain = torch.where(ay > az, 1, 2)
    return torch.where(ax > ay, torch.where(ax > az, 0, 2), domain)


def _tess(P1: Vec3, P2: Vec3, P3: Vec3, N1: Vec3, N2: Vec3, N3: Vec3, alpha: float, uu, vv):
    """The tessellated point at patch coordinates (uu, vv)
    (phongTessellation, pt_phongtess.cl:14-26)."""
    ww = 1.0 - uu - vv
    p_bary = P1 * uu + P2 * vv + P3 * ww
    p_tess = (project_on_plane(p_bary, P1, N1) * uu + project_on_plane(p_bary, P2, N2) * vv
              + project_on_plane(p_bary, P3, N3) * ww)
    return p_bary * f32(1.0 - alpha) + p_tess * alpha


def phongtess_patch_intersect(o: Vec3, d: Vec3, P1: Vec3, P2: Vec3, P3: Vec3, N1: Vec3,
                              N2: Vec3, N3: Vec3, alpha: float, t_best, t_near=0.0,
                              t_far=None):
    """Ray vs one Phong patch (phongTessTriAndRayIntersect,
    pt_phongtess.cl:56-212), elementwise over broadcast shapes.

    ``alpha``: a Python float (rounded to float32); ``t_best``: a tensor.
    Returns ``(t, u, v, valid)``: the nearest acceptable root with t in
    [|t_near|, min(t_best, t_far)], t = +inf where there is none."""
    alpha = f32(alpha)
    E01 = P2 - P1
    E12 = P3 - P2
    E20 = P1 - P3
    C1 = (N2 * N2.dot(E01) - N1 * N1.dot(E01)) * alpha
    C2 = (N3 * N3.dot(E12) - N2 * N2.dot(E12)) * alpha
    C3 = (N1 * N1.dot(E20) - N3 * N3.dot(E20)) * alpha

    n1, n2, o1, o2 = _ray_planes(o, d)
    a = (-n1).dot(C3)
    b = (-n1).dot(C2)
    c = n1.dot(P3) - o1
    dd = n1.dot(C1 - C2 - C3) * 0.5
    e = n1.dot(C3 + E20) * 0.5
    f = n1.dot(C2 - E12) * 0.5
    l = (-n2).dot(C3)  # noqa: E741
    m = (-n2).dot(C2)
    n_ = n2.dot(P3) - o2
    o_ = n2.dot(C1 - C2 - C3) * 0.5
    p = n2.dot(C3 + E20) * 0.5
    q = n2.dot(C2 - E12) * 0.5

    a3c = (l * m * n_ + 2.0 * o_ * p * q) - (l * q * q + m * p * p + n_ * o_ * o_)
    a2c = (a * m * n_ + l * b * n_ + l * m * c + 2.0 * (dd * p * q + o_ * e * q + o_ * p * f)) - (
        a * q * q + b * p * p + c * o_ * o_ + 2.0 * (l * f * q + m * e * p + n_ * dd * o_)
    )
    a1c = (a * b * n_ + a * m * c + l * b * c + 2.0 * (o_ * e * f + dd * e * q + dd * p * f)) - (
        l * f * f + m * e * e + n_ * dd * dd + 2.0 * (a * f * q + b * e * p + c * dd * o_)
    )
    a0c = (a * b * c + 2.0 * dd * e * f) - (a * f * f + b * e * e + c * dd * dd)

    # The reference's "a0" is the x³ coefficient and "a3" the constant
    # (pt_phongtess.cl:99-106); solveCubic takes the highest first.
    x0, x1, x2, count = solve_cubic(a0c, a1c, a2c, a3c)

    # The x minimising mD² - mA·mB (sequential strict-greater update,
    # pt_phongtess.cl:117-125).
    x = torch.zeros_like(a)
    determinant = torch.full_like(a, INF)
    for i, xi in enumerate((x0, x1, x2)):
        mA = a * xi + l
        mB = b * xi + m
        mD = dd * xi + o_
        tmp = mD * mD - mA * mB
        use = (i < count) & (determinant > tmp)
        x = torch.where(use, xi, x)
        determinant = torch.where(use, tmp, determinant)
    ok = (count > 0) & (determinant > 0.0)

    domain = _ray_domain(d)
    mA = a * x + l
    mB = b * x + m
    mC = c * x + n_
    mD = dd * x + o_
    mE = e * x + p
    mF = f * x + q
    a_less_b = torch.abs(mA) < torch.abs(mB)
    mBorA = torch.where(a_less_b, mB, mA)
    inv = _guard_div(torch.ones_like(mBorA), mBorA)
    mA, mB, mC, mD, mE, mF = (v * inv for v in (mA, mB, mC, mD, mE, mF))

    mAorB = torch.where(a_less_b, mA, mB)
    mEorF = torch.where(a_less_b, 2.0 * mE, 2.0 * mF)
    mForE = torch.where(a_less_b, mF, mE)
    ab = torch.where(a_less_b, a, b)
    ba = torch.where(a_less_b, b, a)
    ef = torch.where(a_less_b, e, f)
    fe = torch.where(a_less_b, f, e)

    sqrtAorB = torch.sqrt(torch.clamp_min(mD * mD - mAorB, 0.0))
    sqrtC = torch.sqrt(torch.clamp_min(mForE * mForE - mC, 0.0))
    lab1 = mD + sqrtAorB
    lab2 = mD - sqrtAorB
    lc1 = mForE + sqrtC
    lc2 = mForE - sqrtC
    # The factored product's u-coefficient is the cross pairing
    # lab1*lc2 + lab2*lc1; if the same-index pairing matches mEorF better,
    # the lc labels are crossed: swap them (pt_phongtess.cl:166-168).
    swap_lc = torch.abs(mEorF - lab1 * lc1 - lab2 * lc2) < torch.abs(
        mEorF - lab1 * lc2 - lab2 * lc1)
    lc1, lc2 = torch.where(swap_lc, lc2, lc1), torch.where(swap_lc, lc1, lc2)

    limit = t_best if t_far is None else torch.minimum(t_best, t_far)
    t_out = torch.full_like(a, INF)
    u_out = torch.zeros_like(a)
    v_out = torch.zeros_like(a)
    for g, h in ((-lab1, -lc1), (-lab2, -lc2)):
        c0 = ab + g * (2.0 * dd + ba * g)
        c1 = 2.0 * (h * (dd + ba * g) + ef + fe * g)
        c2 = h * (ba * h + 2.0 * fe) + c
        r0, r1, rcount = solve_quadratic(c0, c1, c2)
        for i, u in enumerate((r0, r1)):
            v = g * u + h
            wbar = 1.0 - u - v
            root_ok = ok & (i < rcount) & (u >= 0.0) & (v >= 0.0) & (wbar >= 0.0)
            uu = torch.where(a_less_b, u, v)
            vv = torch.where(a_less_b, v, u)
            pt = _tess(P1, P2, P3, N1, N2, N3, alpha, uu, vv) - o
            t_param = _guard_div(_axis_component(pt, domain), _axis_component(d, domain))
            accept = (root_ok & (t_param >= abs(t_near))
                      & (t_param <= torch.minimum(t_out, limit)))
            t_out = torch.where(accept, t_param, t_out)
            u_out = torch.where(accept, uu, u_out)
            v_out = torch.where(accept, vv, v_out)
    return t_out, u_out, v_out, torch.isfinite(t_out)


def phongtess_normal(d: Vec3, N1: Vec3, N2: Vec3, N3: Vec3, C1: Vec3, C2: Vec3, C3: Vec3,
                     E12: Vec3, E20: Vec3, u, v) -> Vec3:
    """Patch shading normal (getPhongTessNormal, pt_utils.cl:282-294): the
    surface-derivative normal unless it back-faces the reflection of the
    smooth normal."""
    w = 1.0 - u - v
    du = C3 * (w - u) + (C1 - C2) * v + E20
    dv = C2 * (w - v) + (C1 - C3) * u - E12
    ns = safe_normalized(du.cross(dv))
    npn = safe_normalized(N1 * u + N2 * v + N3 * w)
    r = d - npn * (2.0 * npn.dot(d))
    return where3(ns.dot(r) < 0.0, ns, npn)


def patch_constants(P1: Vec3, P2: Vec3, P3: Vec3, N1: Vec3, N2: Vec3, N3: Vec3, alpha: float):
    """(C1, C2, C3, E12, E20) for the normal evaluation."""
    alpha = f32(alpha)
    E01 = P2 - P1
    E12 = P3 - P2
    E20 = P1 - P3
    C1 = (N2 * N2.dot(E01) - N1 * N1.dot(E01)) * alpha
    C2 = (N3 * N3.dot(E12) - N2 * N2.dot(E12)) * alpha
    C3 = (N1 * N1.dot(E20) - N3 * N3.dot(E20)) * alpha
    return C1, C2, C3, E12, E20


def _tess_point(p1, p2, p3, n1, n2, n3, alpha, u, v):
    """Vectorized MathHelp::phongTessellate (MathHelp.cpp:213-226) on
    (F, 3) NumPy arrays; ``u``/``v`` are scalars or (F, 1) arrays."""
    dot = lambda a, b: np.sum(a * b, axis=-1, keepdims=True)  # noqa: E731
    proj = lambda q, p, n: q - dot(q - p, n) * n  # noqa: E731
    w = 1.0 - u - v
    p_bary = p1 * u + p2 * v + p3 * w
    p_tess = (
        proj(p_bary, p1, n1) * u + proj(p_bary, p2, n2) * v + proj(p_bary, p3, n3) * w
    )
    return (1.0 - alpha) * p_bary + alpha * p_tess


def phongtess_face_aabbs(p1, p2, p3, n1, n2, n3, alpha):
    """Per-face AABBs inflated to cover the curved Phong patch: the
    build-time bound that lets curved patches trace through the BVH and the
    clusters (the JAX package's improvement on the reference's sampled
    bound, MathHelp.cpp:250-378). The patch is a quadratic Bézier triangle
    whose six control points are {p1, p2, p3, q12/2, q23/2, q13/2}, with
    q_ij = (1-α)(p_i+p_j) + α(π_i(p_j) + π_j(p_i)) and π_i the projection
    onto vertex i's tangent plane; the control points' AABB contains the
    patch. Faces whose vertex normals agree (within 1e-6) keep the flat
    AABB.

    Inputs: (F, 3) float arrays. Returns ``(bb_min, bb_max)`` (F, 3) f32.
    """
    p1 = np.asarray(p1, dtype=np.float32)
    p2 = np.asarray(p2, dtype=np.float32)
    p3 = np.asarray(p3, dtype=np.float32)
    n1 = np.asarray(n1, dtype=np.float32)
    n2 = np.asarray(n2, dtype=np.float32)
    n3 = np.asarray(n3, dtype=np.float32)
    alpha = np.float32(alpha)
    dot = lambda a, b: np.sum(a * b, axis=-1, keepdims=True)  # noqa: E731
    proj = lambda q, p, n: q - dot(q - p, n) * n  # noqa: E731

    bb_min = np.minimum(np.minimum(p1, p2), p3)
    bb_max = np.maximum(np.maximum(p1, p2), p3)

    test = (n1 - n2) + (n2 - n3)
    curved = np.any(np.abs(test) > 1e-6, axis=-1, keepdims=True)
    if alpha <= 0.0 or not curved.any():
        return bb_min, bb_max

    with np.errstate(all="ignore"):
        grow_min, grow_max = bb_min.copy(), bb_max.copy()
        for (pa, na), (pb, nb) in (
            ((p1, n1), (p2, n2)),
            ((p2, n2), (p3, n3)),
            ((p1, n1), (p3, n3)),
        ):
            q = (1.0 - alpha) * (pa + pb) + alpha * (proj(pb, pa, na) + proj(pa, pb, nb))
            b = np.float32(0.5) * q  # mid-edge Bézier control point
            grow_min = np.minimum(grow_min, b)
            grow_max = np.maximum(grow_max, b)

    bb_min = np.where(curved, grow_min, bb_min)
    bb_max = np.where(curved, grow_max, bb_max)
    return bb_min.astype(np.float32), bb_max.astype(np.float32)


def face_is_flat(tris) -> torch.Tensor:
    """(F,) bool: all three vertex normals equal (checkFaceIntersection,
    pt_intersect.cl:151-165). Flat faces take plain Möller-Trumbore."""
    eq = lambda a, b: (a.x == b.x) & (a.y == b.y) & (a.z == b.z)  # noqa: E731
    return eq(tris.n0, tris.n1) & eq(tris.n1, tris.n2)


# Floats of a face record of ``phong_records``: five 16-byte words.
PHONG_RECORD = 20


class RecordFaces(NamedTuple):
    """Faces as the searches read them: Vec3s of (N,) and the (N,) bool
    flat flag (column views of a ``phong_records`` table, or a triangle
    SoA's own tensors)."""

    v0: Vec3
    e1: Vec3
    e2: Vec3
    n0: Vec3
    n1: Vec3
    n2: Vec3
    flat: torch.Tensor


def phong_records(tris, n_pad: Optional[int] = None) -> torch.Tensor:
    """The Phong searches' face table, (``n_pad``, 20) float32 (``n_pad``:
    the face count when None): a face's v0, e1, e2, n0, n1, n2 (x, y, z
    each), its flat flag (1.0 where ``face_is_flat``) and a 0, read by
    kernels K9 and K10 as five 16-byte words {v0, e1.x} {e1.yz, e2.xy}
    {e2.z, n0} {n1, n2.x} {n2.yz, flat, 0}, and by their plain versions
    through ``record_faces``. Padding faces are flat with zero edges:
    Möller-Trumbore's det is 0 there, never valid."""
    cols = [c for v in (tris.v0, tris.e1, tris.e2, tris.n0, tris.n1, tris.n2) for c in v]
    cols.append(face_is_flat(tris).to(torch.float32))
    cols.append(torch.zeros_like(cols[0]))
    table = torch.stack(cols, dim=1)
    nf = table.shape[0]
    n_pad = nf if n_pad is None else n_pad
    if n_pad < nf:
        raise ValueError(f"a Phong face table of {n_pad} rows cannot hold {nf} faces")
    if n_pad > nf:
        fill = table.new_zeros((n_pad - nf, PHONG_RECORD))
        fill[:, 18] = 1.0
        table = torch.cat([table, fill])
    return table.contiguous()


def record_faces(table: torch.Tensor) -> RecordFaces:
    """The faces of a ``phong_records`` table, as column views."""
    c = table.unbind(1)
    v = lambda i: Vec3(c[i], c[i + 1], c[i + 2])  # noqa: E731
    return RecordFaces(v(0), v(3), v(6), v(9), v(12), v(15), c[18] > 0.5)


def _face_hit(o: Vec3, d: Vec3, faces: RecordFaces, fidx, alpha: float, t_best):
    """One face a lane (``fidx``: an int or a per-lane index): its
    Möller-Trumbore t when it is flat, its patch t (at least EPSILON5) when
    it is curved. Returns ``(t, u, v, valid)``, u and v 0 on flat faces."""
    P1 = gather_vec3(faces.v0, fidx)
    e1 = gather_vec3(faces.e1, fidx)
    e2 = gather_vec3(faces.e2, fidx)
    t_f, valid_f = moller_trumbore(o, d, P1, e1, e2)
    t_c, uu, vv, valid_c = phongtess_patch_intersect(
        o, d, P1, P1 + e1, P1 + e2, gather_vec3(faces.n0, fidx), gather_vec3(faces.n1, fidx),
        gather_vec3(faces.n2, fidx), alpha, t_best)
    is_flat = faces.flat[fidx]
    t = torch.where(is_flat, t_f, t_c)
    valid = torch.where(is_flat, valid_f, valid_c & (t_c >= EPS5))
    return t, torch.where(is_flat, 0.0, uu), torch.where(is_flat, 0.0, vv), valid


def intersect_brute_phongtess(o: Vec3, d: Vec3, tris, alpha: float):
    """Nearest hit over all faces, one face at a time: Phong patches for
    curved faces, Möller-Trumbore for flat ones (first face wins ties).
    Returns ``(t, face, u, v)``, u and v the patch coordinates of a curved
    winner (0 for a flat one)."""
    faces = RecordFaces(tris.v0, tris.e1, tris.e2, tris.n0, tris.n1, tris.n2,
                        face_is_flat(tris))
    t_best = torch.full_like(o.x, INF)
    f_best = torch.full(o.x.shape, -1, dtype=torch.int32, device=o.x.device)
    u_best = torch.zeros_like(o.x)
    v_best = torch.zeros_like(o.x)
    for f in range(int(tris.mtl.shape[0])):
        t, uu, vv, valid = _face_hit(o, d, faces, f, alpha, t_best)
        better = valid & (t < t_best)
        t_best = torch.where(better, t, t_best)
        f_best = torch.where(better, f, f_best)
        u_best = torch.where(better, uu, u_best)
        v_best = torch.where(better, vv, v_best)
    return t_best, f_best, u_best, v_best


def intersect_bvh_phongtess(o: Vec3, d: Vec3, bvh, tris, alpha: float, max_leaf=None,
                            alive=None, faces: Optional[torch.Tensor] = None,
                            work: Optional[dict] = None):
    """Nearest hit through the stackless BVH with the flat/curved face
    dispatch (the reference's shared leaf test, pt_intersect.cl:142-176,
    through traverse, pt_bvh.cl:82-123); contract and ties as
    ``intersect_brute_phongtess``. Kernel K9's plain version
    (``ops/cuda_phong.py``). The tree must be built over
    ``phongtess_face_aabbs`` bounds (``scene/build.py`` with
    ``phong_tess_alpha``). ``bvh``: a ``BVHTables``; ``faces``: the
    ``phong_records`` table of ``tris`` (built here when None; ``tris`` may
    then be None). A host-driven loop, one node step a pass over every lane
    until all have left the tree (the JAX version's ``while np.any(...)``),
    with one host check a step. A step's leaf faces are tested in one
    batch, and only on steps where some lane reached a leaf: a face whose t
    lies beyond the bound an earlier face of the leaf set cannot win, so
    the order of the updates decides as the one-face-at-a-time loop does.
    The node test is K8's: the slab test, t_far > EPSILON5, the empty-box
    guard of ``ops/cuda_bvh.py`` (which no node the builders make fails)
    and t_best > t_near. ``max_leaf``: the faces a leaf may hold
    (``leaf_bound``: None takes the tree's own). ``alive`` (B,) bool: a
    dead lane walks nothing and reports t = +inf, face -1. ``work``: a
    dict that gets the walk's node steps (``visits``) and its tests of
    flat and of curved faces (``flat``, ``curved``), added to what it
    holds. Returns ``(t, face, u, v)``."""
    return _walk(o, d, bvh, tris, alpha, max_leaf, alive, faces, work, None)


def occluded_bvh_phongtess(o: Vec3, d: Vec3, t_limit, bvh, tris, alpha: float, max_leaf=None,
                           alive=None, faces: Optional[torch.Tensor] = None,
                           work: Optional[dict] = None) -> torch.Tensor:
    """Any hit closer than ``t_limit`` through the Phong BVH: a ray is
    occluded iff some valid face (``intersect_bvh_phongtess``'s tests, the
    patch test bounded by ``t_limit``) has t < ``t_limit``, and it ends at
    the first leaf that holds one. Kernel K9's any-hit instance's plain
    version (``ops/cuda_phong.py::occluded_walk``): the Phong shadow leg,
    the reference's any-hit ``traverseShadows`` (pt_bvh.cl:133-177), whose
    bit the JAX package takes from a nearest search as t_sh < t_light
    (``pbr_tpu/models/integrator.py:339-353``). The patch test returns the
    least root in [0, bound], the same for every bound at or above the
    nearest t, so the bit is the nearest walk's t < ``t_limit``. The node
    test takes t_limit > t_near in place of the running best. Arguments as
    ``intersect_bvh_phongtess``; ``t_limit`` (B,) float32; ``work`` gets
    the node steps and the face tests up to and including each ray's
    occluder. Returns the (B,) bool ``occluded``, False on a dead lane."""
    return _walk(o, d, bvh, tris, alpha, max_leaf, alive, faces, work, t_limit)


def _walk(o: Vec3, d: Vec3, bvh, tris, alpha: float, max_leaf, alive, faces, work, t_limit):
    """The two Phong walks: nearest (``t_limit`` None) and any-hit."""
    max_leaf = leaf_bound(bvh, max_leaf)
    n = bvh.count
    fc = record_faces(phong_records(tris) if faces is None else faces)
    nf = fc.flat.shape[0]
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    o1, d1 = Vec3(*(c[None] for c in o)), Vec3(*(c[None] for c in d))
    dev = o.x.device
    ks = torch.arange(max_leaf, dtype=torch.int32, device=dev)[:, None]
    idx = torch.zeros(o.x.shape, dtype=torch.int32, device=dev)
    if alive is not None:
        idx = torch.where(alive, idx, n)
    any_hit = t_limit is not None
    # The node test's and the face tests' bound: the running best t, or
    # t_limit.
    t_best = t_limit if any_hit else torch.full_like(o.x, INF)
    occluded = torch.zeros(o.x.shape, dtype=torch.bool, device=dev)
    f_best = torch.full(o.x.shape, -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros_like(o.x)
    v_best = torch.zeros_like(o.x)
    more = o.x.numel() > 0 and n > 0 and bool((idx < n).any())
    while more:
        walking = idx < n
        safe = idx.clamp_max(n - 1).long()
        bb_min = Vec3(*bvh.bb_min[:, safe])
        bb_max = Vec3(*bvh.bb_max[:, safe])
        leaf_first = bvh.leaf_first[safe]
        t_near, t_far, hit_box = slab_box(o, inv_d, bb_min, bb_max)
        hit_box = hit_box & (t_far > EPS5) & (bb_min.x <= bb_max.x) & (t_best > t_near)
        do_leaf = walking & hit_box & (leaf_first >= 0)
        nxt = torch.where(hit_box, safe.to(torch.int32) + 1, bvh.exit[safe])
        idx = torch.where(idx >= n, n, nxt).to(torch.int32)
        if work is not None:
            work["visits"] = work.get("visits", 0) + int(walking.sum())
        any_leaf, more = torch.stack([do_leaf.any(), (idx < n).any()]).tolist()
        if not any_leaf:
            continue
        fidx = (leaf_first[None] + ks).clamp(0, nf - 1).long()  # (max_leaf, B)
        t, uu, vv, valid = _face_hit(o1, d1, fc, fidx, alpha, t_best[None])
        tested = do_leaf[None] & (ks < bvh.leaf_count[safe][None])
        ok = tested & valid
        if any_hit:
            hits = ok & (t < t_best[None])
            # The tests up to and including each ray's first occluder.
            before = torch.cumsum(hits.to(torch.int32), dim=0) - hits.to(torch.int32)
            tested = tested & (before == 0)
            occ_now = hits.any(dim=0)
            occluded = occluded | occ_now
            idx = torch.where(occ_now, n, idx)  # an occluded ray ends
        if work is not None:
            flat_t = tested & fc.flat[fidx]
            work["flat"] = work.get("flat", 0) + int(flat_t.sum())
            work["curved"] = work.get("curved", 0) + int((tested & ~flat_t).sum())
        if any_hit:
            continue
        for k in range(max_leaf):
            better = ok[k] & (t[k] < t_best)
            t_best = torch.where(better, t[k], t_best)
            f_best = torch.where(better, fidx[k].to(torch.int32), f_best)
            u_best = torch.where(better, uu[k], u_best)
            v_best = torch.where(better, vv[k], v_best)
    if any_hit:
        return occluded
    return t_best, f_best, u_best, v_best


def cluster_box_hits(o: Vec3, inv_d: Vec3, clusters, cid):
    """Each ray against the box of its cluster ``cid`` (an index a ray):
    ``(hit, t_near)``, the slab test of K10 (``csrc/bvh.cuh::box_hit``:
    NaN-conservative, t_far > EPSILON5, the empty-box guard)."""
    lo, hi = gather_vec3(clusters.bb_min, cid), gather_vec3(clusters.bb_max, cid)
    t_near, t_far, hit = slab_box(o, inv_d, lo, hi)
    return hit & (t_far > EPS5) & (lo.x <= hi.x), t_near


def intersect_clusters_phongtess(o: Vec3, d: Vec3, clusters, tris, alpha: float, alive=None,
                                 tile: int = 128, chunk_rays: Optional[int] = None,
                                 stats: Optional[dict] = None,
                                 faces: Optional[torch.Tensor] = None):
    """Detached nearest-hit search over the clusters' candidate lists with
    mixed flat and curved faces (``pbr_tpu/ops/phongtess.py:590``): the
    path at full width, and kernel K10's plain version
    (``ops/cuda_phong.py``). Returns ``(face, u, v)``.

    ``clusters``: a ``scene.ClusterTables`` built over the inflated face
    bounds; ``faces``: the ``phong_records`` table of ``tris`` padded to
    ``clusters.count * clusters.size`` rows (built here when None; ``tris``
    may then be None). The rays go ``chunk_rays`` (default
    ``PHONG_CHUNK_RAYS``) at a time, rounded to whole ``tile``-ray tiles;
    each chunk gets its near-to-far lists (``ops/cull.py::candidates_fine``),
    then rounds over them, each ray culling and closing on its own:

    - a live ray's last entry is the last of its tile's list whose cluster
      box it hits (``cluster_box_hits``);
    - at round r a ray is open while its best t lies beyond the entry bound
      ``tent[r]`` and r is not past its last entry; a tile stops when none
      of its rays is open or its list has run out (one host check a round);
    - an open ray whose path hits the round's cluster box with an entry
      before its best t tests all the cluster's faces (the patch test with
      the ray's best t at the start of the round as its bound, t at least
      EPSILON5, for curved faces, Möller-Trumbore for flat ones), takes the
      first face of the least t and keeps the (t, face)-lexicographic
      minimum.

    The JAX version runs every tile until its rays' best t all lie before
    the next entry bound and tests every ray of a running tile; a cluster
    this search skips for a ray starts at or beyond the ray's best t, or
    lies off its path, so that changes a result only where a face lies
    exactly at an entry bound with a lower id. A ray's result does not
    depend on its tile, so not on the chunk or the order of the rays.

    ``alive``: dead lanes keep their rays (the tiles stay tight) but are
    seeded closed and report face -1. ``stats``: a dict that gets the
    rounds of the longest tile (``rounds``) and the tile-rounds run
    (``tile_rounds``), added to what it holds, and for this call each
    tile's rounds (``per_tile``, (T,)), the active rays of each tile at
    each round (``active``, (T, C)), and for each lane of the tiles (T *
    ``tile``, padding lanes dead) the rounds it stayed open (``open``), the
    box tests of its scan for its last entry (``scan``, 0 on a dead lane)
    and its best t (``t``), all int32 but ``t``; ``cuda_phong.cluster_work``
    reads what K10 and the JAX loop's rule do from them.
    """
    # Imported here: ops/cull.py imports accel/, whose import reaches this
    # module through models/integrator.py.
    from pbr_tpu_torch.ops.cull import candidates_fine

    alpha = f32(alpha)
    s, c = clusters.size, clusters.count
    shape = o.x.shape
    dev = o.x.device
    flat_n = o.x.numel()
    chunk_rays = PHONG_CHUNK_RAYS if chunk_rays is None else chunk_rays
    chunk = min(max(tile, (chunk_rays // tile) * tile), -(-flat_n // tile) * tile)
    n_tiles = chunk // tile
    table = phong_records(tris, c * s) if faces is None else faces
    if table.shape != (c * s, PHONG_RECORD):
        raise ValueError(f"the face table must be ({c * s}, {PHONG_RECORD}), the clusters' "
                         f"faces padded; got {tuple(table.shape)}")
    offs = torch.arange(s, dtype=torch.int64, device=dev)
    lane_tile = torch.arange(chunk, device=dev) // tile
    ar_tile = torch.arange(tile, device=dev)
    batch = max(1, _PAIRS // s)
    alive_f = (torch.ones(flat_n, dtype=torch.bool, device=dev) if alive is None
               else alive.reshape(-1))

    def chunk_search(lo: int):
        hi = min(lo + chunk, flat_n)
        pad = chunk - (hi - lo)

        def take(a, fill=None):
            a = a.reshape(-1)[lo:hi]
            if pad:  # the last ray repeats (dead): the tile bounds stay tight
                tail = a[-1:].expand(pad) if fill is None else a.new_full((pad,), fill)
                a = torch.cat([a, tail])
            return a

        ov, dv = Vec3(*(take(a) for a in o)), Vec3(*(take(a) for a in d))
        live = take(alive_f, False)
        cand, cnt, tent = candidates_fine(ov, dv, clusters, tile)
        cand_l, cnt_l = cand.long(), cnt[lane_tile]
        inv = Vec3(1.0 / dv.x, 1.0 / dv.y, 1.0 / dv.z)
        # Each live ray's last entry whose box it hits (-1: none).
        last = torch.full((chunk,), -1, dtype=torch.int64, device=dev)
        for r in range(int(cnt.max())):
            hit, _ = cluster_box_hits(ov, inv, clusters, cand_l[lane_tile, r])
            last = torch.where(hit & live & (cnt_l > r), r, last)
        t_b = torch.where(live, INF, _BIGN)
        f_b = torch.full((chunk,), -1, dtype=torch.int32, device=dev)
        u_b = torch.zeros((chunk,), dtype=torch.float32, device=dev)
        v_b = torch.zeros_like(u_b)
        rounds = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
        opened = torch.zeros((chunk,), dtype=torch.int32, device=dev)
        active = torch.zeros((n_tiles, c), dtype=torch.int32, device=dev)
        scan = torch.where(live, torch.where(last >= 0, cnt_l - last, cnt_l), 0).int()
        act = torch.arange(n_tiles, device=dev)  # the tiles still open
        for r in range(c):
            # The mask indexes sync the host: a few checks a round.
            act = act[cnt[act] > r]
            if act.numel() == 0:
                break
            lanes = (act[:, None] * tile + ar_tile).reshape(-1)
            # Open: best t beyond the entry bound and an entry left. A
            # closed ray stays closed (the bounds rise, the best t only
            # falls), and so does a tile with no open ray.
            is_open = (live[lanes].reshape(-1, tile)
                       & (t_b[lanes].reshape(-1, tile) > tent[act, r][:, None])
                       & (last[lanes].reshape(-1, tile) >= r))
            keep = is_open.any(dim=1)
            act = act[keep]
            if act.numel() == 0:
                break
            rounds[act] = r + 1
            lanes, is_open = lanes.reshape(-1, tile)[keep].reshape(-1), is_open[keep].reshape(-1)
            opened[lanes[is_open]] = r + 1
            hit, t_near = cluster_box_hits(Vec3(*(a[lanes] for a in ov)),
                                           Vec3(*(a[lanes] for a in inv)), clusters,
                                           cand_l[act, r].repeat_interleave(tile))
            on = is_open & hit & (t_b[lanes] > t_near)
            active[act, r] = on.reshape(-1, tile).sum(dim=1, dtype=torch.int32)
            ids = lanes[on]
            for b0 in range(0, ids.numel(), batch):
                _cluster_round(ids[b0:b0 + batch], r, ov, dv, cand_l, lane_tile, table, offs,
                               s, alpha, t_b, f_b, u_b, v_b)
        return f_b, u_b, v_b, rounds, active, opened, scan, t_b

    with torch.no_grad():
        outs = [chunk_search(lo) for lo in range(0, flat_n, chunk)]
    if stats is not None:
        n_t = -(-flat_n // tile)
        per_tile = torch.cat([out[3] for out in outs])[:n_t]
        stats["rounds"] = max(stats.get("rounds", 0), int(per_tile.max()) if flat_n else 0)
        stats["tile_rounds"] = stats.get("tile_rounds", 0) + int(per_tile.sum())
        stats["per_tile"] = per_tile
        stats["active"] = torch.cat([out[4] for out in outs])[:n_t]
        for j, k in enumerate(("open", "scan", "t"), 5):
            stats[k] = torch.cat([out[j] for out in outs])[:n_t * tile]
    return tuple(torch.cat([out[j] for out in outs])[:flat_n].reshape(shape) for j in range(3))


def _cluster_round(ids, r: int, o: Vec3, d: Vec3, cand, lane_tile, table, offs, s: int,
                   alpha, t_b, f_b, u_b, v_b) -> None:
    """One round of the cluster search for the active rays ``ids`` of a
    chunk: all faces of their tile's cluster ``r`` against each, bounded by
    its best t at the round's start; the first face of the least t merged
    by (t, face) order into ``t_b``, ``f_b``, ``u_b``, ``v_b`` in place."""
    fids = cand[lane_tile[ids], r][:, None] * s + offs  # (A, S)
    g = table[fids].permute(2, 0, 1)  # (20, A, S)
    oa, da = Vec3(*(a[ids, None] for a in o)), Vec3(*(a[ids, None] for a in d))
    tb, fb = t_b[ids], f_b[ids]
    P1, E1, E2 = Vec3(*g[0:3]), Vec3(*g[3:6]), Vec3(*g[6:9])
    t_mt, ok_mt = moller_trumbore(oa, da, P1, E1, E2)
    t_pt, u_pt, v_pt, ok_pt = phongtess_patch_intersect(
        oa, da, P1, P1 + E1, P1 + E2, Vec3(*g[9:12]), Vec3(*g[12:15]), Vec3(*g[15:18]), alpha,
        tb[:, None])
    is_flat = g[18] > 0.5
    # A curved face's t at least EPSILON5, as in the sweep and the walk (the
    # JAX version's search takes t from 0: a ray leaving a curved patch hits
    # it again).
    tt = torch.where(is_flat, torch.where(ok_mt, t_mt, INF),
                     torch.where(ok_pt & (t_pt >= EPS5), t_pt, INF))
    # The first face with the least t (argmin's tie rule, as jnp's).
    k = torch.argmin(tt, dim=1, keepdim=True)
    at_k = lambda a: torch.gather(a, 1, k)[:, 0]  # noqa: E731
    tmin, fid, flat_k = at_k(tt), at_k(fids).to(torch.int32), at_k(is_flat)
    better = (tmin < INF) & ((tmin < tb) | ((tmin == tb) & (fid < fb)))
    t_b[ids] = torch.where(better, tmin, tb)
    f_b[ids] = torch.where(better, fid, fb)
    u_b[ids] = torch.where(better, torch.where(flat_k, 0.0, at_k(u_pt)), u_b[ids])
    v_b[ids] = torch.where(better, torch.where(flat_k, 0.0, at_k(v_pt)), v_b[ids])


def _takes_clusters(clusters, rays: int) -> bool:
    """Whether the dispatch sends a pass of ``rays`` rays to the cluster
    search (else, with a BVH, to the walk)."""
    return clusters is not None and CLUSTER_MIN_RAYS is not None and rays >= CLUSTER_MIN_RAYS


def intersect_scene_phongtess(o: Vec3, d: Vec3, tris, alpha: float, bvh=None, clusters=None,
                              max_leaf=None, alive=None, faces: Optional[torch.Tensor] = None):
    """The Phong nearest-hit dispatch (``pbr_tpu/ops/phongtess.py:467``):
    no BVH, the all-faces sweep; clusters and at least
    ``CLUSTER_MIN_RAYS`` rays (when it is not None), the cluster search
    (kernel K10 on the card); otherwise the BVH walk (kernel K9 on the
    card). ``faces``: the searches' ``phong_records`` table
    (``SceneParams.phong_records``; built here when None). Returns ``(t,
    face, u, v)``.

    The search runs detached; the winner's t is then re-evaluated on live
    ``o``/``d`` and detached geometry and patch coordinates, which is where
    gradients flow: Möller-Trumbore for a flat winner, the tessellated
    point along the ray's dominant axis for a curved one (the same
    expression on the same inputs as the search, so the same forward
    value). ``alive`` (B,) bool: dead lanes report face -1 on the cluster
    search and the walk and cost them nothing; the sweep ignores it."""
    # Imported here: ops/cuda_phong.py imports this module.
    from pbr_tpu_torch.ops import cuda_phong

    o_s, d_s, tris_s = o.detach(), d.detach(), detach_tris(tris)
    with torch.no_grad():
        if bvh is None:
            _, face, uu, vv = intersect_brute_phongtess(o_s, d_s, tris_s, alpha)
        else:
            if faces is None:
                faces = phong_records(tris_s, None if clusters is None
                                      else clusters.count * clusters.size)
            live = None if alive is None else alive.contiguous()
            if _takes_clusters(clusters, o.x.numel()):
                face, uu, vv = cuda_phong.intersect_clusters(o_s, d_s, clusters, faces, alpha,
                                                             alive=live)
            else:
                _, face, uu, vv = cuda_phong.intersect_walk(o_s, d_s, bvh, faces, alpha,
                                                            max_leaf=max_leaf, alive=live)

    safe = face.clamp_min(0).long()
    P1 = gather_vec3(tris_s.v0, safe)
    e1 = gather_vec3(tris_s.e1, safe)
    e2 = gather_vec3(tris_s.e2, safe)
    t_f, _ = moller_trumbore(o, d, P1, e1, e2)
    pt = _tess(P1, P1 + e1, P1 + e2, gather_vec3(tris_s.n0, safe), gather_vec3(tris_s.n1, safe),
               gather_vec3(tris_s.n2, safe), alpha, uu, vv) - o
    domain = _ray_domain(d_s)
    t_c = _guard_div(_axis_component(pt, domain), _axis_component(d, domain))
    t = torch.where(face_is_flat(tris_s)[safe], t_f, t_c)
    return t.masked_fill(face < 0, INF), face, uu, vv


def occluded_scene_phongtess(o: Vec3, d: Vec3, t_limit, tris, alpha: float, bvh=None,
                             clusters=None, max_leaf=None, alive=None,
                             faces: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Phong shadow leg: (B,) bool, some face closer than ``t_limit``.
    Where the nearest dispatch (``intersect_scene_phongtess``) walks the
    BVH, the any-hit walk (kernel K9's any-hit instance on the card,
    ``occluded_bvh_phongtess`` its plain version); the sweep (no BVH) and
    the cluster search, then t < ``t_limit``. The JAX package searches
    nearest and re-evaluates t on every pass (``pbr_tpu/models/
    integrator.py:339-353``); the bit carries no gradient. ``alive``: the
    lanes that cast, False elsewhere on the walk."""
    from pbr_tpu_torch.ops import cuda_phong

    if bvh is None or _takes_clusters(clusters, o.x.numel()):
        t = intersect_scene_phongtess(o, d, tris, alpha, bvh=bvh, clusters=clusters,
                                      max_leaf=max_leaf, alive=alive, faces=faces)[0]
        return t < t_limit
    with torch.no_grad():
        if faces is None:
            faces = phong_records(detach_tris(tris))
        return cuda_phong.occluded_walk(
            Vec3(*(c.detach() for c in o)), Vec3(*(c.detach() for c in d)),
            t_limit.detach().contiguous(), bvh, faces, alpha, max_leaf=max_leaf,
            alive=None if alive is None else alive.contiguous())
