"""Ray-tile (dp) x sample (sp) sharding of a frame over ``torch.distributed``.

The counterpart of ``pbr_tpu/parallel/mesh.py``, with one process a device
in place of a ``jax.sharding.Mesh``:

- **dp**: the frame's flat pixel batch is cut into ``n_dp`` contiguous
  blocks, one a dp index; each process traces its block. Pixel ids stay
  global (the counter RNG keys off them), so the image does not depend on
  the layout.
- **sp**: the ``n_sp`` processes of a dp index trace the same block with
  distinct seeds (``_shard_seed``) and average their colors with an
  all-reduce over their sp group: the mean of ``n_sp`` frames, what
  progressive accumulation of ``n_sp`` frames gives.

The scene, materials, lights and camera are replicated: every process
passes identical values. A training step all-reduces the parameter
gradients over every process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce as all_reduce_autograd

from pbr_tpu_torch.models.integrator import trace_rays
from pbr_tpu_torch.ops import rng as rng_mod
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import CameraState
from pbr_tpu_torch.utils.config import RenderSettings


class Mesh(NamedTuple):
    """A ('dp', 'sp') layout of the default group's ranks, as seen by one
    of them: ``grid[i][k]`` is the rank at dp index i and sp index k;
    ``sp_group`` holds the ranks of this rank's dp index, ``dp_group`` those
    of its sp index."""

    grid: tuple
    rank: int
    dp_index: int
    sp_index: int
    sp_group: object
    dp_group: object

    @property
    def shape(self) -> dict:
        return {"dp": len(self.grid), "sp": len(self.grid[0])}


def make_mesh(n_dp: Optional[int] = None, n_sp: int = 1, ranks=None) -> Mesh:
    """A ('dp', 'sp') layout over every rank of the default group
    (``pbr_tpu/parallel/mesh.py:37``); n_dp defaults to the world size over
    ``n_sp``. ``ranks``: a permutation of the ranks, laid out row by row
    (the JAX version's ``devices=``). Every rank must call it with the same
    arguments: it creates every sp and dp group, which is collective."""
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp * n_sp != world:
        raise ValueError(f"a {n_dp} x {n_sp} mesh needs {n_dp * n_sp} ranks; the world has {world}")
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"ranks must be a permutation of 0..{world - 1}, got {ranks}")
    grid = tuple(tuple(ranks[i * n_sp:(i + 1) * n_sp]) for i in range(n_dp))
    sp_groups = [dist.new_group(list(row)) for row in grid]
    dp_groups = [dist.new_group([row[k] for row in grid]) for k in range(n_sp)]
    me = dist.get_rank()
    i, k = divmod(ranks.index(me), n_sp)
    return Mesh(grid, me, i, k, sp_groups[i], dp_groups[k])


def _shard_seed(frame_seed: int, sp_index: int) -> int:
    """A distinct, deterministic seed a sample shard: the shard index
    folded into the frame seed with the renderer's own hash (bitwise the
    JAX version's)."""
    return rng_mod.fold(rng_mod.lowbias32(int(frame_seed)), int(sp_index))


def _trace_shard(scene, cam, settings: RenderSettings, ids, frame_seed, mesh: Mesh,
                 max_leaf):
    """This rank's block traced with its sample shard's seed, then color and
    focus averaged over the sp group. The all-reduce is differentiable: its
    backward sums the sp ranks' cotangents."""
    res = trace_rays(scene, cam, settings, ids, _shard_seed(frame_seed, mesh.sp_index),
                     max_leaf=max_leaf)
    # Focus: averaged like the color (an inf from any shard dominates,
    # which depth of field maps to "far").
    both = all_reduce_autograd(torch.stack([*res.color, res.focus_t]), group=mesh.sp_group)
    both = both / float(mesh.shape["sp"])
    return Vec3(both[0], both[1], both[2]), both[3]


def sharded_render(mesh: Mesh, scene, cam: CameraState, settings: RenderSettings, frame_seed,
                   pixel_ids=None, max_leaf=None):
    """One frame over the mesh (``pbr_tpu/parallel/mesh.py:74``). Returns
    ``(color: Vec3, focus_t)``: this rank's dp block of the flat image,
    pixels ``shard_index_map(mesh, npx)[rank]``, the mean of the sp group's
    frames.

    ``scene``: a ``SceneParams`` on this rank's device; ``cam``: its
    ``camera_to_torch``; ``pixel_ids``: this rank's block of global pixel
    ids (default ``host_local_pixel_ids``); the pixel count must divide by
    n_dp."""
    from pbr_tpu_torch.parallel.multihost import host_local_pixel_ids

    if pixel_ids is None:
        pixel_ids = host_local_pixel_ids(mesh, settings.width, settings.height, scene.device)
    with torch.no_grad():
        return _trace_shard(scene, cam, settings, pixel_ids, frame_seed, mesh, max_leaf)


def render_params(scene, cam: CameraState) -> dict:
    """The differentiable parameters by name: the scene's materials and
    lights (``SceneParams.named_parameters``) and the camera's float fields
    (``cam.eye.x`` ...)."""
    params = dict(scene.named_parameters())
    for name, field in zip(CameraState._fields, cam):
        if isinstance(field, Vec3):
            params.update({f"cam.{name}.{c}": v for c, v in zip("xyz", field)})
        else:
            params[f"cam.{name}"] = field
    return params


def leaf_camera(cam: CameraState) -> CameraState:
    """``cam`` with every tensor a fresh leaf that requires grad."""
    leaf = lambda t: t.detach().clone().requires_grad_()  # noqa: E731
    return CameraState(*(Vec3(*(leaf(c) for c in f)) if isinstance(f, Vec3) else leaf(f)
                         for f in cam))


def sharded_train_step(mesh: Mesh, scene, cam: CameraState, settings: RenderSettings,
                       target_rgb, frame_seed, lr: float = 0.0, max_leaf=None):
    """One differentiable frame, MSE loss and gradient step over the mesh
    (``pbr_tpu/parallel/mesh.py:124``).

    The loss is that of the mean of the sp group's frames against
    ``target_rgb`` ((npx, 3) float32, flat pixel order), summed over the
    image and divided by 3 npx. Each rank differentiates its block's part
    (the sp all-reduce inside it is differentiable), the gradients are
    summed over every rank and divided by n_sp: a block's loss is held by
    the n_sp ranks of its sp group, so the plain sum counts it n_sp times.
    The result is the gradient of the loss itself, as one process computes
    it under autograd.

    Switches on ``requires_grad`` of ``scene``'s parameters. Returns
    ``(loss, grads, params)``: the loss (0-d), and dicts keyed as
    ``render_params``; ``lr`` > 0 takes a plain SGD step, in place on the
    scene's parameters, and ``params`` holds the stepped values."""
    from pbr_tpu_torch.parallel.multihost import host_local_pixel_ids, shard_global_array

    dev = scene.device
    npx = settings.width * settings.height
    ids = host_local_pixel_ids(mesh, settings.width, settings.height, dev)
    target = shard_global_array(mesh, np.asarray(target_rgb, dtype=np.float32), dev)
    scene.requires_grad_()
    cam = leaf_camera(cam)
    params = render_params(scene, cam)
    color, _ = _trace_shard(scene, cam, settings, ids, frame_seed, mesh, max_leaf)
    err = ((color.x - target[:, 0]) ** 2 + (color.y - target[:, 1]) ** 2
           + (color.z - target[:, 2]) ** 2)
    loss_local = err.sum() / float(3 * npx)
    grads = torch.autograd.grad(loss_local, list(params.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params.values())]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat = flat / float(mesh.shape["sp"])
    grads = dict(zip(params, flat.split([g.numel() for g in grads])))
    grads = {k: g.reshape(params[k].shape) for k, g in grads.items()}
    loss = loss_local.detach().clone()
    dist.all_reduce(loss, group=mesh.dp_group)
    if lr > 0.0:
        with torch.no_grad():
            for k, p in params.items():
                if k.startswith("cam."):
                    params[k] = (p - lr * grads[k]).detach()
                else:
                    p -= lr * grads[k]
    return loss, grads, params
