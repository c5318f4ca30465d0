"""The port's sharding (``pbr_tpu_torch/parallel``) on gloo, in spawned CPU
processes, against the same frames and losses traced in one process.

This module imports only torch and the port: ``spawn`` re-imports the
module of a rank's function in every rank, so the rank functions live here
(``tests/test_torch_sharding.py``, which compares with JAX, uses them too).
Every spawn is joined under a time limit (``spawn_ranks``), and the ranks
meet through a file under the test's ``tmp_path``, so that parallel test
workers never compete for a port.
"""

import numpy as np
import pytest
import torch

from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.parallel.mesh import (
    Mesh,
    _shard_seed,
    leaf_camera,
    make_mesh,
    render_params,
    sharded_render,
    sharded_train_step,
)
from pbr_tpu_torch.parallel.multihost import (
    global_mesh,
    host_local_pixel_ids,
    multihost_train_step,
    shard_index_map,
    spawn_ranks,
)
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import cornell_box
from pbr_tpu_torch.utils.config import RenderSettings

torch.set_num_threads(1)

SPAWN_TIMEOUT = 180.0  # seconds for a whole spawn: start, rendezvous, work


def cornell(size: int = 16, **kw):
    """tests/util.py::cornell_scene (use_bvh=False) on the port's host
    layer: the scene of the JAX package's sharding tests."""
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    base = dict(width=size, height=size, samples=1, max_depth=3, max_added_depth=2,
                shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0))
    base.update(kw)
    return scene, cam, RenderSettings(**base)


def train_settings(size: int = 16):
    """The JAX package's gradient test settings (tests/test_sharding.py:80)."""
    return cornell(size, max_depth=2, max_added_depth=0)


def _spawn(fn, world: int, tmp_path, args):
    return spawn_ranks(fn, world, f"file://{tmp_path / 'rendezvous'}", args=args, device="cpu",
                       timeout=SPAWN_TIMEOUT)


# ---- rank functions (run in the spawned processes) -------------------------

def render_rank(rank, n_dp, n_sp, ranks, size, seed):
    torch.set_num_threads(1)
    scene, cam, settings = cornell(size)
    mesh = make_mesh(n_dp, n_sp, ranks)
    color, focus = sharded_render(mesh, to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"),
                                  settings, seed)
    sl = shard_index_map(mesh, size * size)[rank]
    return sl, color.stack().numpy(), focus.numpy()


def train_rank(rank, n_dp, n_sp, size, seed, target, lr):
    torch.set_num_threads(1)
    scene, cam, settings = train_settings(size)
    mesh = make_mesh(n_dp, n_sp)
    ts = to_torch(scene, "cpu")
    loss, grads, params = sharded_train_step(mesh, ts, camera_to_torch(cam, "cpu"), settings,
                                             target, seed, lr=lr)
    out = {"loss": float(loss), "grads": {k: g.numpy() for k, g in grads.items()}}
    if lr > 0.0:
        # The stepped parameters' loss, one more step without an update.
        loss1, _, _ = sharded_train_step(mesh, ts, _camera_of(params), settings, target, seed)
        out["loss_after"] = float(loss1)
    return out


def multihost_rank(rank, size, seed, target):
    torch.set_num_threads(1)
    scene, cam, settings = train_settings(size)
    mesh = global_mesh()
    ids = host_local_pixel_ids(mesh, size, size, "cpu")
    loss, grads = multihost_train_step(mesh, to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"),
                                       settings, target, seed)
    return ids.numpy(), float(loss), {k: g.numpy() for k, g in grads.items()}


def _camera_of(params):
    """The CameraState of ``render_params``' camera entries."""
    from pbr_tpu_torch.ops.vec import Vec3
    from pbr_tpu_torch.scene.types import CameraState

    fields = []
    for name in CameraState._fields:
        if f"cam.{name}" in params:
            fields.append(params[f"cam.{name}"])
        else:
            fields.append(Vec3(*(params[f"cam.{name}.{c}"] for c in "xyz")))
    return CameraState(*fields)


# ---- the one-process references --------------------------------------------

def mean_of_frames(n_sp: int, size: int, seed: int):
    """What the sp axis computes, in one process: the mean of the n_sp
    sample shards' frames, (npx, 3) and (npx,)."""
    scene, cam, settings = cornell(size)
    ts, tc = to_torch(scene, "cpu"), camera_to_torch(cam, "cpu")
    ids = torch.arange(size * size, dtype=torch.int32)
    color = focus = 0.0
    for k in range(n_sp):
        res = trace_rays(ts, tc, settings, ids, _shard_seed(seed, k))
        color = color + res.color.stack()
        focus = focus + res.focus_t
    return (color / float(n_sp)).numpy(), (focus / float(n_sp)).numpy()


def true_grads(n_sp: int, size: int, seed: int, target):
    """The gradient of the stated loss in one process under autograd: the
    MSE of the mean of the n_sp sample shards' frames against ``target``,
    over 3 npx."""
    scene, cam, settings = train_settings(size)
    ts = to_torch(scene, "cpu").requires_grad_()
    tc = leaf_camera(camera_to_torch(cam, "cpu"))
    params = render_params(ts, tc)
    npx = size * size
    ids = torch.arange(npx, dtype=torch.int32)
    color = 0.0
    for k in range(n_sp):
        color = color + trace_rays(ts, tc, settings, ids, _shard_seed(seed, k)).color.stack()
    err = (color / float(n_sp) - torch.tensor(target)) ** 2
    loss = err.sum() / float(3 * npx)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(loss.detach()), {k: (torch.zeros_like(p) if g is None else g).numpy()
                         for (k, p), g in zip(params.items(), grads)}


def assert_grads_close(got: dict, ref: dict, rtol=1e-4):
    assert set(got) == set(ref)
    for k in ref:
        scale = float(np.abs(ref[k]).max()) if ref[k].size else 0.0
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=1e-5 * scale + 1e-7,
                                   err_msg=k)


def _assemble(results, size):
    img = np.full((size * size, 3), np.nan, dtype=np.float32)
    foc = np.full(size * size, np.nan, dtype=np.float32)
    for sl, color, focus in results:
        img[sl], foc[sl] = color, focus
    return img, foc


# ---- tests ------------------------------------------------------------------

def test_index_maps_tile_the_frame():
    """For any layout, the dp blocks tile [0, npx) exactly, each sp rank of
    a block getting the same one (tests/test_multihost.py:36)."""
    npx = 16 * 16
    for grid in (((0,), (1,), (2,), (3,)), ((2, 0), (3, 1)), ((3,), (1,), (0,), (2,)),
                 ((1, 3, 0, 2),)):
        mesh = Mesh(grid, 0, 0, 0, None, None)
        seen = np.zeros(npx, dtype=np.int32)
        for sl in shard_index_map(mesh, npx).values():
            assert sl.step is None
            seen[sl] += 1
        assert (seen == len(grid[0])).all()
    with pytest.raises(ValueError, match="divide"):
        shard_index_map(Mesh(((0,), (1,), (2,)), 0, 0, 0, None, None), npx)


def test_dp2_equals_the_unsharded_frame_bitwise(tmp_path):
    size = 16
    img, foc = _assemble(_spawn(render_rank, 2, tmp_path, (2, 1, None, size, 5)), size)
    ref, ref_foc = mean_of_frames(1, size, 5)
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(foc, ref_foc)


def test_permuted_layout_renders_the_identical_image(tmp_path):
    """The ranks in another order own other blocks, never another image
    (tests/test_multihost.py:64)."""
    size = 16
    res = _spawn(render_rank, 2, tmp_path, (2, 1, [1, 0], size, 5))
    assert res[1][0] == slice(0, size * size // 2)  # rank 1 holds block 0
    img, _ = _assemble(res, size)
    np.testing.assert_array_equal(img, mean_of_frames(1, size, 5)[0])


@pytest.mark.parametrize("n_dp, n_sp", [(1, 2), (2, 2)])
def test_sp_is_the_mean_of_its_frames(tmp_path, n_dp, n_sp):
    size = 16
    img, foc = _assemble(_spawn(render_rank, n_dp * n_sp, tmp_path,
                                (n_dp, n_sp, None, size, 7)), size)
    ref, ref_foc = mean_of_frames(n_sp, size, 7)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(foc, ref_foc, rtol=1e-6)
    assert np.abs(img - mean_of_frames(1, size, 7)[0]).max() > 1e-3  # the seeds differ


def test_multihost_train_step_ranks_agree(tmp_path):
    """Two processes, one multihost_train_step: each rank feeds its own
    block of global pixel ids, and the loss and gradients come back the
    same on both, equal to one process's."""
    size = 8
    target = np.full((size * size, 3), 0.5, dtype=np.float32)
    (ids0, loss0, g0), (ids1, loss1, g1) = _spawn(multihost_rank, 2, tmp_path,
                                                  (size, 9, target))
    np.testing.assert_array_equal(np.concatenate([ids0, ids1]), np.arange(size * size))
    assert loss0 == loss1
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])
    ref_loss, ref = true_grads(1, size, 9, target)
    assert abs(loss0 - ref_loss) <= 1e-5 * abs(ref_loss)
    assert_grads_close(g0, ref)


def test_sgd_step_reduces_the_loss(tmp_path):
    """tests/test_sharding.py::test_sgd_step_reduces_loss on a 2 x 2 mesh."""
    size = 8
    target = np.zeros((size * size, 3), dtype=np.float32)
    res = _spawn(train_rank, 4, tmp_path, (2, 2, size, 1, target, 0.05))
    assert all(r["loss"] == res[0]["loss"] for r in res)
    assert res[0]["loss_after"] < res[0]["loss"]
