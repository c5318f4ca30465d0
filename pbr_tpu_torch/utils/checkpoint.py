"""Checkpoint / resume for progressive renders and fits.

The counterpart of ``pbr_tpu/utils/checkpoint.py``'s npz format: a
directory holding ``state.npz`` with one array a leaf, ``leaf_0``,
``leaf_1``, ... in the JAX package's pytree order (NamedTuples and tuples
field by field, dicts by sorted key, None holding no leaf), and
``meta.json`` with ``"backend": "npz"`` plus the caller's metadata. So a
``FrameState`` saved by either package restores into the other's (its
leaves: ``rgb.x``, ``rgb.y``, ``rgb.z``, ``depth``, ``sample_count``).

The port writes and reads npz only: a checkpoint the JAX package wrote
with orbax (``"backend": "orbax"``) is refused.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the JAX package's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure built from ``leaves`` (consumed from
    the front). A leaf that is a tensor in ``like`` comes back as a tensor
    of its dtype on its device."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        vals = [_unflatten(sub, leaves) for sub in like]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    arr = leaves.pop(0)
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf has shape {arr.shape}, expected "
                             f"{tuple(like.shape)}")
        return torch.as_tensor(arr).to(dtype=like.dtype, device=like.device)
    return arr


def save(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Save ``tree`` (tensors, NumPy arrays or scalars at the leaves) as an
    npz checkpoint in the directory ``path``, with ``meta`` beside it."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arrays[f"leaf_{i}"] = np.asarray(leaf)
    np.savez(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"backend": "npz", **(meta or {})}, f)


def restore(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore the checkpoint in ``path`` into the structure of ``like``
    (which also gives the leaves' order, and the dtype and device of its
    tensor leaves). Returns ``(tree, meta)``."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("backend") != "npz":
        raise ValueError(
            f"{path}: checkpoint backend {meta.get('backend')!r}; pbr_tpu_torch reads npz "
            f"checkpoints only"
        )
    n = len(_leaves(like))
    with np.load(os.path.join(path, "state.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return _unflatten(like, leaves), meta
