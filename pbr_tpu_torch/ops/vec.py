"""Structure-of-arrays 3-vector math on torch tensors.

The PyTorch counterpart of ``pbr_tpu/ops/vec.py``. The same class also
serves the port's NumPy host layer (``scene/``, ``io/``, ``accel/``): its
components may be NumPy arrays there, where only construction,
``from_array``, ``stack(np)`` and the arithmetic are used. A batch of N 3-vectors
stays *three* ``(N,)`` tensors, the layout the JAX package uses at its public
functions, so the two packages compare like with like. Every operation keeps
the reference's operation order (``a.x*b.x + a.y*b.y + a.z*b.z``, ``1/sqrt``
rather than ``rsqrt``), which is what keeps the port within ULPs of NumPy.

Scalar constants are plain Python floats that are exact float32 values:
torch treats a Python scalar as weakly typed, so ``f32_tensor * c`` stays
float32 with ``c`` rounded to float32 first, as NumPy's ``np.float32(c)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float (a weak torch scalar)."""
    return float(np.float32(x))


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- products -----------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def yzx(self) -> "Vec3":
        return Vec3(self.y, self.z, self.x)

    # -- norms --------------------------------------------------------------
    def length2(self):
        return self.dot(self)

    def normalized(self) -> "Vec3":
        # 1/sqrt, not rsqrt: IEEE sqrt and divide are correctly rounded on
        # NumPy, XLA and CUDA alike (pbr_tpu/ops/vec.py:_rsqrt_like).
        return self * (1.0 / torch.sqrt(self.length2()))

    def max_component(self):
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    # -- construction -------------------------------------------------------
    @staticmethod
    def full(shape, vals, device, dtype=torch.float32) -> "Vec3":
        vx, vy, vz = vals
        return Vec3(
            torch.full(shape, vx, dtype=dtype, device=device),
            torch.full(shape, vy, dtype=dtype, device=device),
            torch.full(shape, vz, dtype=dtype, device=device),
        )

    @staticmethod
    def from_array(a) -> "Vec3":
        """From an (..., 3) array or tensor (host-side convenience)."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def stack(self, xp=torch):
        """To an (..., 3) tensor, or with ``xp=np`` an (..., 3) NumPy array
        (host-side convenience; not for hot paths)."""
        if xp is torch:
            return torch.stack([self.x, self.y, self.z], dim=-1)
        return xp.stack([self.x, self.y, self.z], axis=-1)

    def detach(self) -> "Vec3":
        return Vec3(self.x.detach(), self.y.detach(), self.z.detach())


# ---------------------------------------------------------------------------
# Backward-safe math: forward-exact on the valid domain, zero (not NaN)
# gradients at the boundary — the guarded input keeps autograd from ever
# forming an infinite local derivative (pbr_tpu/ops/vec.py:142-148).
# ---------------------------------------------------------------------------

_PI = f32(np.pi)


def safe_sqrt(x):
    """sqrt(x) for x > 0, exactly; 0 at x <= 0 with zero gradient."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_pow(x, e):
    """x**e for x > 0, exactly; 0 at x <= 0 with zero gradient."""
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), e), 0.0)


def safe_arccos(x):
    """arccos with clamped domain and finite gradients at the endpoints."""
    inside = torch.abs(x) < 1.0
    core = torch.acos(torch.where(inside, x, 0.0))
    ends = torch.where(x >= 1.0, 0.0, _PI)
    return torch.where(inside, core, ends)


def safe_div(num, den, eps=1e-12):
    """num / den where |den| > eps, else 0 — with zero gradient there."""
    ok = torch.abs(den) > eps
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def safe_normalized(v: Vec3, eps=1e-20) -> Vec3:
    """Unit vector; zero vector (zero grad) for degenerate input."""
    l2 = v.length2()
    ok = l2 > eps
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, l2, 1.0)), 0.0)
    return v * inv


def where3(mask, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise ``torch.where`` over Vec3."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection (reference ``reflect`` macro, pt_utils.cl:426)."""
    return d - n * (2.0 * n.dot(d))


def project_on_plane(q: Vec3, p: Vec3, n: Vec3) -> Vec3:
    """Project point q on the plane through p with unit normal n
    (reference pt_utils.cl:397-399)."""
    return q - n * (q - p).dot(n)


def bisect(v: Vec3, w: Vec3) -> Vec3:
    """Normalized half-vector; zero (not NaN) for opposite inputs."""
    return safe_normalized(v + w)


def orthonormal(n: Vec3) -> tuple:
    """Tangent frame (u, v) for unit normal n, the reference's way
    (pt_utils.cl:309-310)."""
    u = safe_normalized(n.yzx().cross(n))
    v = safe_normalized(n.cross(u))
    return u, v


def jitter(nl: Vec3, phi, sina, cosa) -> Vec3:
    """Direction on the hemisphere around ``nl`` at angle (phi, alpha)
    (reference pt_utils.cl:306-318)."""
    u, v = orthonormal(nl)
    azim = (u * torch.cos(phi) + v * torch.sin(phi)).normalized()
    return (azim * sina + nl * cosa).normalized()


# ---------------------------------------------------------------------------
# Adjoints written out by hand (vector-Jacobian products): the plain
# versions of the backward kernels' device functions (csrc/shade_bwd.cu),
# op for op. Each takes a forward function's inputs and the gradient of its
# output and returns its inputs' gradients, with autograd's conventions at
# the guards: zero where a safe_* function guards, half to each side of a
# tie of ``maximum`` / ``minimum``, all of it where ``clamp_min`` sits at
# its bound.
# ---------------------------------------------------------------------------


def sum3(v: Vec3):
    """x + y + z, in that order."""
    return v.x + v.y + v.z


def max_weight(a, b):
    """d maximum(a, b) / d a as autograd takes it: 1 where a > b, 1/2 at a
    tie, 0 below (``max_weight(b, a)`` is minimum(a, b)'s)."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def normalized_vjp(v: Vec3, g: Vec3) -> Vec3:
    """``Vec3.normalized``'s adjoint: (g - n (g . n)) / |v|, n = v / |v|."""
    inv = 1.0 / torch.sqrt(v.length2())
    n = v * inv
    return (g - n * g.dot(n)) * inv


def safe_normalized_vjp(v: Vec3, g: Vec3, eps=1e-20) -> Vec3:
    """``safe_normalized``'s adjoint: zero where it guards."""
    l2 = v.length2()
    ok = l2 > eps
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, l2, 1.0)), 0.0)
    n = v * inv
    return (g - n * g.dot(n)) * inv


def jitter_vjp(nl: Vec3, phi, sina, cosa, g: Vec3) -> Vec3:
    """``jitter``'s adjoint with respect to ``nl`` (the angles are drawn:
    no gradient)."""
    y = nl.yzx()
    a = y.cross(nl)
    u = safe_normalized(a)
    b = nl.cross(u)
    v = safe_normalized(b)
    cp, sp = torch.cos(phi), torch.sin(phi)
    az0 = u * cp + v * sp
    az = az0.normalized()
    r0 = az * sina + nl * cosa
    g_r0 = normalized_vjp(r0, g)
    g_az0 = normalized_vjp(az0, g_r0 * sina)
    g_nl = g_r0 * cosa
    g_b = safe_normalized_vjp(b, g_az0 * sp)
    g_u = g_az0 * cp + g_b.cross(nl)  # b = nl x u
    g_nl = g_nl + u.cross(g_b)
    g_a = safe_normalized_vjp(a, g_u)
    g_y = nl.cross(g_a)  # a = y x nl
    g_nl = g_nl + g_a.cross(y)
    return Vec3(g_nl.x + g_y.z, g_nl.y + g_y.x, g_nl.z + g_y.y)  # y = (nl.y, nl.z, nl.x)
