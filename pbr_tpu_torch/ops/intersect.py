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
