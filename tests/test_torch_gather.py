"""The material gather of the port's shade
(``pbr_tpu_torch/ops/cuda_shade.py::gather_materials``, the plain version
of K12's gather by index): the JAX
default's select chain up to 16 materials, plain indexing above.

Values must equal plain indexing and the JAX package's
``_gather_materials`` bitwise: every path picks a table entry verbatim.
Gradients of a weighted sum of all 14 fields must equal plain indexing's
within rtol 1e-5: both sum the same positive terms per material, in
another order. The multiroom gradients against ``jax.grad`` stay in
tests/test_torch_grad.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops.vec import Vec3 as JVec3
from pbr_tpu.scene.types import MaterialsSoA as JMaterials
from pbr_tpu_torch.ops import cuda_shade
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import MaterialsSoA

torch.set_num_threads(1)

RAYS = 4096
SCALARS = ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd")
M_CASES = [2, 16, 17]  # the chain at both ends of its range, and indexing


def _tables(m: int):
    """Seeded material tables (numpy): 8 scalar fields (M,) and kd, ks
    (3, M); indices covering every material; positive per-ray weights."""
    rng = np.random.default_rng(m)
    tab = {k: rng.uniform(0.1, 2.0, m).astype(np.float32) for k in SCALARS}
    tab["kd"], tab["ks"] = (rng.uniform(0.0, 1.0, (3, m)).astype(np.float32) for _ in range(2))
    midx = np.concatenate([np.arange(m), rng.integers(0, m, RAYS - m)]).astype(np.int32)
    rng.shuffle(midx)
    w = rng.uniform(0.5, 1.5, (14, RAYS)).astype(np.float32)
    return tab, midx, w


def _torch_mats(tab):
    params = {k: torch.tensor(v, requires_grad=True) for k, v in tab.items()}
    mats = MaterialsSoA(**{k: params[k] for k in SCALARS},
                        kd=Vec3(*params["kd"]), ks=Vec3(*params["ks"]),
                        light=torch.zeros(len(tab["d"]), dtype=torch.int32))
    return mats, params


def _flat(vals):
    return [*vals[:8], *vals[8], *vals[9]]


def _plain(mats, midx):
    """Plain indexing of every field."""
    return (*(getattr(mats, k)[midx] for k in SCALARS),
            Vec3(*(c[midx] for c in mats.kd)), Vec3(*(c[midx] for c in mats.ks)))


def _grads(gather, tab, midx, w):
    mats, params = _torch_mats(tab)
    vals = _flat(gather(mats, torch.tensor(midx)))
    loss = sum((torch.tensor(wk) * v).sum() for wk, v in zip(w, vals))
    loss.backward()
    return [v.detach() for v in vals], {k: p.grad for k, p in params.items()}


@pytest.mark.parametrize("m", M_CASES)
def test_values_equal_plain_indexing(m):
    tab, midx, _ = _tables(m)
    mats, _ = _torch_mats(tab)
    idx = torch.tensor(midx)
    for got, ref in zip(_flat(cuda_shade.gather_materials(mats, idx)), _flat(_plain(mats, idx))):
        assert got.shape == (RAYS,) and torch.equal(got, ref)


@pytest.mark.parametrize("m", M_CASES)
def test_values_equal_the_jax_package(m):
    """JAX's select chain (M <= 16) and its one-hot matmul (17-128) give
    the table entries exactly too."""
    tab, midx, _ = _tables(m)
    mats, _ = _torch_mats(tab)
    jm = JMaterials(**{k: jnp.asarray(tab[k]) for k in SCALARS},
                    kd=JVec3(*map(jnp.asarray, tab["kd"])), ks=JVec3(*map(jnp.asarray, tab["ks"])),
                    light=jnp.zeros(m, jnp.int32))
    ref = _flat(jax_integrator._gather_materials(jnp, jm, jnp.asarray(midx)))
    got = _flat(cuda_shade.gather_materials(mats, torch.tensor(midx)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(r))


@pytest.mark.parametrize("m", M_CASES)
def test_grads_match_plain_indexing(m):
    tab, midx, w = _tables(m)
    _, got = _grads(cuda_shade.gather_materials, tab, midx, w)
    _, ref = _grads(_plain, tab, midx, w)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.all(ref[k] > 0), k  # every material is gathered, the weights positive
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-5, atol=0, err_msg=k)


def _backward_nodes(t: torch.Tensor) -> set:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [nxt for nxt, _ in fn.next_functions]
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("m, indexed", [(2, False), (17, True)])
def test_chain_backward_has_no_index_node(m, indexed):
    """The point of the chain: up to 16 materials the backward holds
    selects and sums, no index backward (which sorts the indices)."""
    tab, midx, _ = _tables(m)
    mats, _ = _torch_mats(tab)
    vals = _flat(cuda_shade.gather_materials(mats, torch.tensor(midx)))
    names = set().union(*(_backward_nodes(v) for v in vals))
    assert any(n.startswith("Index") for n in names) == indexed, names
    assert any(n.startswith("Where") for n in names) == (not indexed), names
