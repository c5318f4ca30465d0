"""The port's sharding against the JAX package's (``pbr_tpu/parallel``) on
the conftest's 8-device CPU mesh, and against the one-process gradient.

The ranks run in spawned gloo processes; their functions live in
``tests/test_torch_sharding_ranks.py``, which imports no JAX (``spawn``
re-imports a rank function's module, and this module's JAX would come
along without conftest's CPU pin).

The gradient gate is the true gradient of the stated loss (the MSE of the
mean of the n_sp sample shards' frames), computed in one process under
autograd; JAX's ``sharded_train_step`` is held to it too. Tolerances:
rtol 1e-4 plus 1e-5 of the largest magnitude (tests/test_sharding.py:119,
and the frameworks sum float32 in other orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pbr_tpu.parallel.mesh import _shard_seed as jax_shard_seed
from pbr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pbr_tpu.parallel.mesh import sharded_train_step as jax_sharded_train_step
from pbr_tpu_torch.parallel.mesh import _shard_seed
from pbr_tpu_torch.parallel.multihost import spawn_ranks
from test_torch_sharding_ranks import (
    SPAWN_TIMEOUT,
    assert_grads_close,
    train_rank,
    train_settings,
    true_grads,
)
from util import cornell_scene, to_jax

torch.set_num_threads(1)

SIZE, SEED = 8, 9


def _target():
    return np.full((SIZE * SIZE, 3), 0.5, dtype=np.float32)


def test_shard_seed_matches_jax_bitwise():
    for seed in (0, 1, 9, 12345, 2**31 + 7, 2**32 - 1):
        for k in range(4):
            ref = jax_shard_seed(np.uint32(seed), np.uint32(k))
            assert _shard_seed(seed, k) == int(ref), (seed, k)


def _jax_grads(n_dp: int, n_sp: int):
    """JAX's sharded_train_step on the first n_dp * n_sp of the 8 CPU
    devices, keyed as the port's ``render_params``."""
    scene, cam, settings = cornell_scene(use_bvh=False, width=SIZE, height=SIZE, max_depth=2,
                                         max_added_depth=0)
    assert dataclasses.asdict(settings) == dataclasses.asdict(train_settings(SIZE)[2])
    loss, (gm, gl, gc), _ = jax_sharded_train_step(
        jax_make_mesh(n_dp=n_dp, n_sp=n_sp), to_jax(scene), to_jax(cam), settings, _target(),
        frame_seed=SEED)
    st = lambda v: np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])  # noqa: E731
    grads = {f"mat_{k}": np.asarray(getattr(gm, k))
             for k in ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd")}
    grads.update(mat_kd=st(gm.kd), mat_ks=st(gm.ks), light_pos=st(gl.pos), light_rgb=st(gl.rgb),
                 light_radius=np.asarray(gl.radius))
    for name in ("eye", "w", "u", "v"):
        grads.update({f"cam.{name}.{c}": np.asarray(getattr(getattr(gc, name), c))
                      for c in "xyz"})
    for name in ("focal_length", "aperture", "focus"):
        grads[f"cam.{name}"] = np.asarray(getattr(gc, name))
    return float(loss), grads


@pytest.mark.parametrize("n_dp, n_sp", [(2, 1), (2, 2)])
def test_grads_match_one_process_and_jax(tmp_path, n_dp, n_sp):
    """The port's sharded gradients (spawned gloo ranks) against the
    one-process gradient of the same loss and against JAX's
    sharded_train_step on the same layout; JAX's against the one-process
    gradient too (so no factor of n_sp hides in either)."""
    target = _target()
    res = spawn_ranks(train_rank, n_dp * n_sp, f"file://{tmp_path / 'rendezvous'}",
                      args=(n_dp, n_sp, SIZE, SEED, target, 0.0), device="cpu",
                      timeout=SPAWN_TIMEOUT)
    ref_loss, ref = true_grads(n_sp, SIZE, SEED, target)
    jax_loss, jax_g = _jax_grads(n_dp, n_sp)
    for r in res:
        assert r["loss"] == res[0]["loss"]
        assert abs(r["loss"] - ref_loss) <= 1e-5 * abs(ref_loss)
        assert_grads_close(r["grads"], ref)
    assert abs(jax_loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert_grads_close(res[0]["grads"], jax_g)
    assert_grads_close(jax_g, ref)
    assert np.abs(ref["mat_kd"]).max() > 1e-4 and np.abs(ref["cam.eye.z"]) > 1e-4
