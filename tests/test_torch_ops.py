"""Elementwise ops of the torch port against the JAX package's, run under
NumPy and under jax.numpy on the same NumPy-seeded inputs.

Tolerance: rtol 1e-5, atol 1e-6 — transcendentals (acos, pow, sin, cos,
atan, tan) differ by a few ULPs between torch, NumPy and XLA, and so does
torch's float32 ``sqrt`` on the CPU, which is not correctly rounded (about
0.7% of inputs are 1 ULP off NumPy's). Pure IEEE arithmetic (Möller-
Trumbore, Fresnel) is bitwise. The guards (``safe_*``, the validity masks)
must agree exactly.

For a Vec3 output the relative part of the tolerance is taken against the
vector's length, not against each component: a unit direction off by
1e-6 rad is as good in its small components as in its large ones (the
samplers take ``acos`` within a few ULPs of 1, where float32 resolves
angles only to about that).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops import brdf as B
from pbr_tpu.ops import intersect as I
from pbr_tpu.ops import vec as V
from pbr_tpu_torch.ops import brdf as TB
from pbr_tpu_torch.ops import intersect as TI
from pbr_tpu_torch.ops import vec as TV

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine (measured: a
# 3 s test took 180 s with four workers).
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _unit(rng, n):
    v = rng.normal(size=(3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _inputs(seed=0, n=N):
    """Directions, normals and scalars, with the guarded degenerate cases
    planted: zero vectors, d == n (h·n == 1), opposite d/n, rough 0,
    p 0, and out-of-domain scalars."""
    rng = np.random.default_rng(seed)
    d, nrm, l = _unit(rng, n), _unit(rng, n), _unit(rng, n)
    d[:, :8] = 0.0
    nrm[:, 8:16] = -d[:, 8:16]
    l[:, 8:16] = nrm[:, 8:16]
    d[:, 16:24] = nrm[:, 16:24]
    s = dict(
        u=rng.uniform(0.0, 1.0, n).astype(np.float32),
        ra=rng.uniform(0.0, 1.0, n).astype(np.float32),
        rb=rng.uniform(0.0, 1.0, n).astype(np.float32),
        rc=rng.uniform(0.0, 1.0, n).astype(np.float32),
        rough=rng.choice([0.0, 0.15, 0.5, 1.0], n).astype(np.float32),
        p=rng.choice([0.0, 0.5, 1.0], n).astype(np.float32),
        nu=rng.choice([0.0, 10.0, 120.0], n).astype(np.float32),
        nv=rng.choice([0.0, 50.0, 120.0], n).astype(np.float32),
        mtl_d=rng.choice([0.5, 1.0], n).astype(np.float32),
        ni=rng.choice([1.0, 1.5, 2.4], n).astype(np.float32),
        x=rng.uniform(-2.0, 2.0, n).astype(np.float32),
    )
    s["x"][:8] = 0.0
    return d, nrm, l, s


def _np3(a):
    return V.Vec3(a[0], a[1], a[2])


def _j3(a):
    return V.Vec3(jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[2]))


def _t3(a):
    return TV.Vec3(torch.as_tensor(a[0]), torch.as_tensor(a[1]), torch.as_tensor(a[2]))


def _flat(out, ref=None):
    """Outputs -> list of (array, scale) pairs, ``scale`` being what the
    relative tolerance is taken against: the value itself, or for a Vec3
    the length of the (reference) vector."""
    if isinstance(out, (V.Vec3, TV.Vec3)):
        comps = [c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c) for c in out]
        base = comps if ref is None else [np.asarray(c) for c in ref]
        norm = np.sqrt(sum(c.astype(np.float64) ** 2 for c in base))
        return [(c, norm) for c in comps]
    if isinstance(out, (tuple, list)):
        refs = ref if ref is not None else [None] * len(out)
        return [p for o, r in zip(out, refs) for p in _flat(o, r)]
    a = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return [(a, np.abs(np.asarray(ref if ref is not None else out)))]


def _check(got, *refs, exact=False):
    """``got`` equal to each of ``refs``: bitwise with ``exact`` (and for
    masks), else to the tolerance."""
    for ref in refs:
        pairs, expect = _flat(got, ref), _flat(ref)
        assert len(pairs) == len(expect)
        for (a, scale), (b, _) in zip(pairs, expect):
            if exact or a.dtype == np.bool_:
                np.testing.assert_array_equal(a, b)
                continue
            err = np.abs(a.astype(np.float64) - b)
            ok = (err <= ATOL + RTOL * scale) | (a == b)  # a == b: equal infs
            assert ok.all(), (
                f"{(~ok).sum()} of {ok.size} lanes out of tolerance, worst "
                f"|err| {err[~ok].max():.3g} at scale {scale[~ok][err[~ok].argmax()]:.3g}"
            )


def _run(fn_ref, fn_t, vecs, scalars):
    """fn_ref(xp, *Vec3s, *scalars) under np and jnp; fn_t(*Vec3s, *scalars)."""
    with np.errstate(all="ignore"):
        r_np = fn_ref(np, *[_np3(v) for v in vecs], *scalars)
    r_j = fn_ref(jnp, *[_j3(v) for v in vecs], *[jnp.asarray(s) for s in scalars])
    r_t = fn_t(*[_t3(v) for v in vecs], *[torch.as_tensor(s) for s in scalars])
    return r_t, r_np, r_j


@pytest.mark.parametrize("name", ["safe_sqrt", "safe_arccos", "safe_div"])
def test_safe_guards(name):
    _, _, _, s = _inputs(1)
    x = s["x"]
    if name == "safe_div":
        args = (s["u"], x)
    elif name == "safe_arccos":
        args = (x,)
    else:
        args = (x,)
    with np.errstate(all="ignore"):
        ref = getattr(V, name)(*args)
    ref_j = getattr(V, name)(*[jnp.asarray(a) for a in args])
    got = getattr(TV, name)(*[torch.as_tensor(a) for a in args])
    _check(got, ref, ref_j)
    # The guard decides the same lanes exactly.
    np.testing.assert_array_equal(got.numpy() == 0.0, ref == 0.0)


def test_safe_pow_and_normalized():
    d, _, _, s = _inputs(2)
    base, e = s["x"], s["nu"] * s["u"]
    with np.errstate(all="ignore"):
        ref = V.safe_pow(base, e)
        ref_n = V.safe_normalized(_np3(d))
    got = TV.safe_pow(torch.as_tensor(base), torch.as_tensor(e))
    _check(got, ref, V.safe_pow(jnp.asarray(base), jnp.asarray(e)))
    np.testing.assert_array_equal(got.numpy() == 0.0, ref == 0.0)
    got_n = TV.safe_normalized(_t3(d))
    _check(got_n, ref_n)
    np.testing.assert_array_equal(got_n.x.numpy() == 0.0, ref_n.x == 0.0)


def test_jitter_and_where3():
    d, nrm, _, s = _inputs(3)
    phi = (s["u"] * np.float32(2 * np.pi)).astype(np.float32)
    sina, cosa = np.sqrt(s["ra"]), np.sqrt(1.0 - s["ra"])
    got = TV.jitter(_t3(nrm), *(torch.as_tensor(a) for a in (phi, sina, cosa)))
    ref = V.jitter(_np3(nrm), phi, sina, cosa)
    ref_j = V.jitter(_j3(nrm), *(jnp.asarray(a) for a in (phi, sina, cosa)))
    _check(got, ref, ref_j)
    m = s["u"] < 0.5
    _check(TV.where3(torch.as_tensor(m), _t3(d), _t3(nrm)),
           V.where3(m, _np3(d), _np3(nrm)), exact=True)


def test_moller_trumbore():
    rng = np.random.default_rng(4)
    o = rng.uniform(-1, 1, (3, N)).astype(np.float32)
    d = _unit(rng, N)
    v0 = rng.uniform(-1, 1, (3, N)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (3, N)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (3, N)).astype(np.float32)
    e2[:, :16] = e1[:, :16]  # degenerate triangles: det = 0
    vecs = (o, d, v0, e1, e2)
    r_t, r_np, r_j = _run(I.moller_trumbore, TI.moller_trumbore, vecs, ())
    # Pure IEEE arithmetic in one operation order: bitwise.
    _check(r_t, r_np, exact=True)
    np.testing.assert_array_equal(r_t[1].numpy(), np.asarray(r_j[1]))
    assert r_t[1].any() and not r_t[1].all()


def test_sphere_and_geometric_normal():
    rng = np.random.default_rng(5)
    o = rng.uniform(-1, 1, (3, N)).astype(np.float32)
    d = _unit(rng, N)
    c = np.zeros((3, N), np.float32)
    r_sq = rng.uniform(0.0, 0.5, N).astype(np.float32)
    with np.errstate(all="ignore"):
        ref = I.sphere(np, _np3(o), _np3(d), _np3(c), r_sq)
    ref_j = I.sphere(jnp, _j3(o), _j3(d), _j3(c), jnp.asarray(r_sq))
    got = TI.sphere(_t3(o), _t3(d), _t3(c), torch.as_tensor(r_sq))
    _check(got, ref, ref_j)
    assert got[1].any() and not got[1].all()
    e1, e2 = o, d
    _check(TI.geometric_normal(_t3(e1), _t3(e2)), I.geometric_normal(_np3(e1), _np3(e2)))


def test_fresnel():
    _, _, _, s = _inputs(6)
    _check(TB.fresnel(torch.as_tensor(s["u"]), torch.as_tensor(s["p"])),
           B.fresnel(s["u"], s["p"]), exact=True)
    kd = np.stack([s["u"], s["ra"], s["rb"]])
    _check(TB.fresnel(torch.as_tensor(s["rc"]), _t3(kd)), B.fresnel(s["rc"], _np3(kd)),
           exact=True)


@pytest.mark.parametrize("which", ["schlick", "sa"])
def test_brdf_eval(which):
    d, nrm, l, s = _inputs(7)
    if which == "schlick":
        out = _run(B.schlick_eval, TB.schlick_eval, (nrm, d, l), (s["rough"], s["p"]))
    else:
        out = _run(B.sa_eval, TB.sa_eval, (nrm, d, l), (s["nu"], s["nv"]))
    _check(*out)


@pytest.mark.parametrize("which", ["schlick", "sa"])
def test_brdf_sample(which):
    d, nrm, _, s = _inputs(8)
    if which == "schlick":
        fn_ref = lambda xp, d_, n_, *a: B.schlick_sample(xp, d_, n_, *a)  # noqa: E731
        out = _run(fn_ref, TB.schlick_sample, (d, nrm),
                   (s["rough"], s["p"], s["ra"], s["rb"], s["rc"]))
    else:
        fn_ref = lambda xp, d_, n_, *a: B.sa_sample(xp, d_, n_, *a)  # noqa: E731
        out = _run(fn_ref, TB.sa_sample, (d, nrm),
                   (s["mtl_d"], s["nu"], s["nv"], s["ra"], s["rb"], s["rc"]))
    _check(*out)


def test_refract_dir():
    d, nrm, _, s = _inputs(9)
    fn_ref = lambda xp, d_, n_, ni, r: B.refract_dir(xp, d_, n_, ni, r)  # noqa: E731
    _check(*_run(fn_ref, TB.refract_dir, (d, nrm), (s["ni"], s["u"])))
