"""Process-level set-up of the sharded renderer.

The counterpart of ``pbr_tpu/parallel/multihost.py``. Every process is a
host with one device here, so what the JAX version does to assemble
global arrays from host-local shards reduces to each rank taking its own
block:

- ``initialize``: ``torch.distributed.init_process_group``, NCCL for a
  CUDA device and gloo for the CPU unless the caller names a backend;
- ``global_mesh``: a ('dp', 'sp') mesh over every rank;
- ``shard_index_map``, ``host_local_pixel_ids``, ``shard_global_array``:
  each rank's block of the flat pixel batch, with global pixel ids (the
  counter RNG keys off them, so rank count and layout cannot change the
  image);
- ``multihost_train_step``: ``mesh.sharded_train_step``'s loss and
  gradients;
- ``spawn_ranks``: runs a function on N spawned ranks and collects the
  results, with a time limit.

Not ported, as XLA-only steps: ``check_vma`` and ``jax.device_put`` onto a
sharding.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: str, world_size: int, rank: int, device="cuda",
               backend: Optional[str] = None) -> None:
    """Join the process group (``pbr_tpu/parallel/multihost.py:26``).

    ``init_method``: the rendezvous (``tcp://localhost:<port>`` or
    ``file://<path>``); ``device``: this rank's device, made current when
    it is a numbered card; ``backend``: 'nccl' for a CUDA device and 'gloo'
    for the CPU when None (gloo also takes CUDA tensors: several ranks can
    share one card, which NCCL refuses)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def global_mesh(n_sp: int = 1):
    """('dp', 'sp') mesh over every rank of every process."""
    from pbr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_dp=dist.get_world_size() // n_sp, n_sp=n_sp)


def shard_index_map(mesh, npx: int) -> dict:
    """{rank: slice} of the (npx,) flat pixel batch: the block of each
    rank's dp index, for any layout of the ranks (sp ranks share their
    block)."""
    n_dp = mesh.shape["dp"]
    if npx % n_dp:
        raise ValueError(f"{npx} pixels do not divide into {n_dp} dp blocks")
    blk = npx // n_dp
    return {r: slice(i * blk, (i + 1) * blk) for i, row in enumerate(mesh.grid) for r in row}


def host_local_pixel_ids(mesh, width: int, height: int, device="cuda") -> torch.Tensor:
    """This rank's block of the global pixel ids: the value at global index
    i is i."""
    sl = shard_index_map(mesh, width * height)[mesh.rank]
    return torch.arange(sl.start, sl.stop, dtype=torch.int32, device=device)


def shard_global_array(mesh, arr, device="cuda") -> torch.Tensor:
    """This rank's dp block (along the first axis) of a host value that
    every process holds, as a tensor on ``device``."""
    arr = np.asarray(arr)
    return torch.tensor(arr[shard_index_map(mesh, arr.shape[0])[mesh.rank]], device=device)


def multihost_train_step(mesh, scene, cam, settings, target_rgb, frame_seed, max_leaf=None):
    """One differentiable frame, MSE loss and gradient all-reduce over the
    mesh (``pbr_tpu/parallel/multihost.py:110``): ``sharded_train_step``
    without the update. Returns ``(loss, grads)``, the same on every rank."""
    from pbr_tpu_torch.parallel.mesh import sharded_train_step

    loss, grads, _ = sharded_train_step(mesh, scene, cam, settings, target_rgb, frame_seed,
                                        lr=0.0, max_leaf=max_leaf)
    return loss, grads


def _rank_main(fn, rank: int, world_size: int, init_method: str, device, backend, args,
               results) -> None:
    """A spawned rank: join the group, run ``fn``, report its result or
    its traceback, leave the group."""
    try:
        initialize(init_method, world_size, rank, device=device, backend=backend)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world_size: int, init_method: str, args=(), device="cuda",
                backend: Optional[str] = None, timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` processes started with
    ``spawn``, each in the process group (``initialize``), and return the
    results in rank order. ``fn`` and ``args`` must pickle: ``fn`` lives at
    the top level of an importable module. Raises if a rank fails, or if
    the ranks have not all reported within ``timeout`` seconds (the ranks
    are then terminated)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, device, backend, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, errors = {}, {}
    try:
        # Drain the queue before joining: a rank's put can block until read.
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):  # a rank that died without a report
                    if r not in out and r not in errors and p.exitcode not in (None, 0):
                        errors[r] = f"exited with code {p.exitcode}"
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size - len(out) - len(errors)} of {world_size} "
                                       f"ranks did not report within {timeout} s") from None
                continue
            if ok:
                out[rank] = value
            else:
                errors[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("a spawned rank failed:\n" + "\n".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [out[r] for r in range(world_size)]
