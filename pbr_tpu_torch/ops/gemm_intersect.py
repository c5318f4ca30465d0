"""Ray-triangle intersection as a matrix multiply: the ``gemm`` mode.

The counterpart of ``pbr_tpu/ops/gemm_intersect.py``. Möller-Trumbore is
bilinear in the ray: with n = e1 x e2,

    det   = -(d . n)
    t_num =  (o . n) - (v0 . n)
    u_num =  d^T skew(e2) o - d . (e2 x v0)
    v_num = -d^T skew(e1) o - d . (v0 x e1)

so for the features f(ray) = [1, o, d, vec(d (x) o)] in R^16 every
per-face quantity is one dot product, and the test of a batch against all
faces is one (B, 16) @ (16, 4F) product, then elementwise gates and a
first-wins minimum. Equal to the brute sweep up to float reassociation.

The product is ``torch.matmul`` (cuBLAS on the card), as the JAX package
computes it with ``jax.lax.dot_general`` outside any Pallas kernel. Two
things differ from the JAX function:

- the rays are taken ``chunk_rays(F)`` at a time, so that the (B, 4F)
  product stays under ``GEMM_BUDGET_BYTES`` (1M rays against multiroom's
  1,428 faces would be a 22.8 GiB product);
- the product runs in full float32: ``intersect_gemm`` sets
  ``torch.backends.cuda.matmul.allow_tf32`` to False for the call and
  restores the caller's setting after it. TF32's 10-bit mantissa would
  move t by ~1e-3 relative and flip the self-hit gate ``t >= 1e-5``.
  The switch is process-wide, so another thread's cuBLAS product during
  the call runs without TF32 too. A caller who asked for TF32 through
  torch's newer ``fp32_precision`` switch makes the call raise torch's
  RuntimeError (torch refuses to read the legacy flag after that
  switch), so it never runs in TF32.
"""

from __future__ import annotations

import contextlib

import torch

from pbr_tpu_torch.ops.intersect import EPS5, INF
from pbr_tpu_torch.ops.vec import Vec3

# Bytes the (B, 4F) float32 product of one chunk may take; the gates' (B, F)
# temporaries take about as much again.
GEMM_BUDGET_BYTES = 1 << 30
# Chunks are whole multiples of this many rays.
CHUNK_ALIGN = 1024


def triangle_coefficients(tris) -> torch.Tensor:
    """The (16, 4F) coefficient matrix W.

    Feature order: [1, ox, oy, oz, dx, dy, dz, dx*ox, dx*oy, dx*oz, dy*ox,
    dy*oy, dy*oz, dz*ox, dz*oy, dz*oz]. Columns: four blocks of F, the
    coefficients of det, t_num, u_num and v_num."""
    v0, e1, e2 = tris.v0, tris.e1, tris.e2
    nx = e1.y * e2.z - e1.z * e2.y
    ny = e1.z * e2.x - e1.x * e2.z
    nz = e1.x * e2.y - e1.y * e2.x
    zeros = torch.zeros_like(v0.x)

    def col(c0, o, d, dxo):
        """One output's coefficients as a (16, F) block."""
        rows = [c0, *o, *d] + [dxo[i][j] for i in range(3) for j in range(3)]
        return torch.stack(rows, dim=0)

    z3 = (zeros, zeros, zeros)
    zdxo = [[zeros] * 3 for _ in range(3)]
    w_det = col(zeros, z3, (-nx, -ny, -nz), zdxo)
    w_t = col(-(v0.x * nx + v0.y * ny + v0.z * nz), (nx, ny, nz), z3, zdxo)
    e2xv0 = (e2.y * v0.z - e2.z * v0.y, e2.z * v0.x - e2.x * v0.z, e2.x * v0.y - e2.y * v0.x)
    sk_e2 = [[zeros, -e2.z, e2.y], [e2.z, zeros, -e2.x], [-e2.y, e2.x, zeros]]
    w_u = col(zeros, z3, (-e2xv0[0], -e2xv0[1], -e2xv0[2]), sk_e2)
    v0xe1 = (v0.y * e1.z - v0.z * e1.y, v0.z * e1.x - v0.x * e1.z, v0.x * e1.y - v0.y * e1.x)
    sk_ne1 = [[zeros, e1.z, -e1.y], [-e1.z, zeros, e1.x], [e1.y, -e1.x, zeros]]
    w_v = col(zeros, z3, (-v0xe1[0], -v0xe1[1], -v0xe1[2]), sk_ne1)
    return torch.cat([w_det, w_t, w_u, w_v], dim=1)


def ray_features(o: Vec3, d: Vec3) -> torch.Tensor:
    """The (B, 16) features of the rays (flattened batch)."""
    feats = [torch.ones_like(o.x), o.x, o.y, o.z, d.x, d.y, d.z,
             d.x * o.x, d.x * o.y, d.x * o.z, d.y * o.x, d.y * o.y, d.y * o.z,
             d.z * o.x, d.z * o.y, d.z * o.z]
    return torch.stack([f.reshape(-1) for f in feats], dim=-1)


def chunk_rays(n_faces: int) -> int:
    """Rays a chunk: the most whole ``CHUNK_ALIGN`` multiples whose (B, 4F)
    float32 product fits in ``GEMM_BUDGET_BYTES`` (at least one multiple)."""
    per_ray = 16 * max(n_faces, 1)
    return max(CHUNK_ALIGN, GEMM_BUDGET_BYTES // per_ray // CHUNK_ALIGN * CHUNK_ALIGN)


@contextlib.contextmanager
def full_float32():
    """cuBLAS float32 products without TF32 for the block; the caller's
    setting is restored after it. Raises torch's RuntimeError where the
    caller set ``torch.backends.cuda.matmul.fp32_precision = "tf32"``."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def _nearest(feats: torch.Tensor, w: torch.Tensor, nf: int):
    """(t, face) of one chunk of features against W."""
    out = feats @ w
    det, t_num = out[:, :nf], out[:, nf:2 * nf]
    u_num, v_num = out[:, 2 * nf:3 * nf], out[:, 3 * nf:]
    inv_det = 1.0 / det
    t = t_num * inv_det
    u = u_num * inv_det
    v = v_num * inv_det
    valid = (t >= EPS5) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    t = torch.where(valid, t, INF)
    t_best, face = torch.min(t, dim=1)  # the first minimum: first face wins ties
    return t_best, torch.where(torch.isfinite(t_best), face.to(torch.int32), -1)


def intersect_gemm(o: Vec3, d: Vec3, tris):
    """Nearest hit over all triangles through the product; the contract of
    ``traverse.intersect_brute``: ``(t, face)``, t = +inf and face = -1 on a
    miss, the first face in memory order wins ties.

    The rays go ``chunk_rays(F)`` a product, in full float32 (see
    ``full_float32``)."""
    nf = int(tris.v0.x.shape[0])
    shape = o.x.shape
    w = triangle_coefficients(tris)
    feats = ray_features(o, d)
    step = chunk_rays(nf)
    with full_float32():
        parts = [_nearest(feats[lo:lo + step], w, nf)
                 for lo in range(0, max(feats.shape[0], 1), step)]
    t = torch.cat([p[0] for p in parts]).reshape(shape)
    face = torch.cat([p[1] for p in parts]).reshape(shape)
    return t, face
