"""Primitive intersection math on torch tensors.

The counterpart of ``pbr_tpu/ops/intersect.py``, with its exact operation
order: the plain brute sweep (``ops/cuda_intersect.py``) and the CUDA kernel
follow the same order, which is what makes the three agree bitwise.
"""

from __future__ import annotations

import torch

from pbr_tpu_torch.utils.config import EPSILON5
from pbr_tpu_torch.ops.vec import Vec3, f32

INF = float("inf")
EPS5 = f32(EPSILON5)


def moller_trumbore(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Ray-triangle intersection (reference pt_intersect.cl:92-129).

    Returns ``(t, valid)``: valid requires t >= EPSILON5 and barycentrics
    inside the triangle. ``t`` is not clamped against a current best; the
    caller runs the nearest-hit competition (first face in memory order
    wins ties)."""
    tvec = o - v0
    pvec = d.cross(e2)
    qvec = tvec.cross(e1)
    det = e1.dot(pvec)
    inv_det = 1.0 / det
    t = e2.dot(qvec) * inv_det
    u = tvec.dot(pvec) * inv_det
    v = d.dot(qvec) * inv_det
    valid = (t >= EPS5) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


def _slab_lo(a, b):
    m = torch.minimum(a, b)
    return torch.where(m == m, m, -INF)


def _slab_hi(a, b):
    m = torch.maximum(a, b)
    return torch.where(m == m, m, INF)


def slab_box(o: Vec3, inv_d: Vec3, bb_min: Vec3, bb_max: Vec3):
    """Ray-AABB slab test (reference intersectBox, pt_intersect.cl:11-25).

    Returns ``(t_near, t_far, hit)`` with hit = (t_near <= t_far). The
    caller applies the reference's extra gates ``t_far > EPSILON5`` and
    ``t_best > t_near`` (pt_bvh.cl:107-110).

    NaN-conservative, as ``pbr_tpu/ops/intersect.py::slab_box``: a ray in a
    slab plane with a zero direction component gives 0 * inf = NaN, and a
    NaN slab bound means "no constraint from this slab" (-inf for the near
    bound, +inf for the far one). ``torch.minimum`` propagates a NaN operand
    as NumPy and XLA do; CUDA's ``fminf`` drops it, so the kernels test for
    NaN explicitly (``csrc/bvh.cuh``)."""
    t1 = (bb_min - o) * inv_d
    t2 = (bb_max - o) * inv_d
    t_near = torch.maximum(torch.maximum(_slab_lo(t1.x, t2.x), _slab_lo(t1.y, t2.y)),
                           _slab_lo(t1.z, t2.z))
    t_far = torch.minimum(torch.minimum(_slab_hi(t1.x, t2.x), _slab_hi(t1.y, t2.y)),
                          _slab_hi(t1.z, t2.z))
    return t_near, t_far, t_near <= t_far


def sphere(o: Vec3, d: Vec3, center: Vec3, r_sq):
    """Geometric ray-sphere test (reference intersectSphere,
    pt_intersect.cl:37-77). ``r_sq`` plays the reference's ``r`` role, which
    it compares against a squared distance: it acts as radius².

    Returns ``(t_near, hit)``."""
    L = center - o
    tca = L.dot(d)
    d2 = L.dot(L) - tca * tca
    thc = torch.sqrt(torch.clamp_min(r_sq - d2, 0.0))
    t0 = tca - thc
    t1 = tca + thc
    t_near = torch.where(t0 < 0.0, t1, t0)
    hit = (tca >= 0.0) & (d2 <= r_sq) & (t_near >= 0.0)
    return t_near, hit


def gather_vec3(v: Vec3, idx) -> Vec3:
    """Gather a Vec3-of-tensors at integer indices."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def geometric_normal(e1: Vec3, e2: Vec3) -> Vec3:
    """Flat-shading normal = normalize(cross(e1, e2))
    (reference pt_intersect.cl:122)."""
    return e1.cross(e2).normalized()
