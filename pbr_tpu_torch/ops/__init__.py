"""Tensor ops: vec math, RNG, intersection, BRDFs, kernel wrappers."""

import functools
import re

# Each kernel instance of ``counts()`` by its CUDA function: a pattern of
# the demangled name (csrc/*.cu; the template arguments tell instances of
# one function apart; a function that is no template is its own name).
KERNELS = {
    "K1": r"brute_intersect_kernel<true, false>",
    "K1'": r"brute_intersect_kernel<false, false>",
    "K2": r"brute_intersect_kernel<true, true>",
    "K2'": r"brute_intersect_kernel<false, true>",
    "K3": r"gated_kernel<false>",
    "K3 any-hit": r"gated_kernel<true>",
    "K4": r"slotted_kernel<\d+, false>",
    "K4 any-hit": r"slotted_kernel<\d+, true>",
    "K4m": r"masked_kernel<\d+, false>",
    "K4m any-hit": r"masked_kernel<\d+, true>",
    "K5": r"slotted_rows_kernel<false>",
    "K5 any-hit": r"slotted_rows_kernel<true>",
    "K5m": r"masked_rows_kernel<false>",
    "K5m any-hit": r"masked_rows_kernel<true>",
    "K6 nearest": r"packet_kernel<0>",
    "K6 NEE": r"packet_kernel<1>",
    "K6 any-hit": r"packet_kernel<2>",
    "K6 seeded": r"chain_kernel<false>",
    "K6 seeded any-hit": r"chain_kernel<true>",
    "K7 nearest": r"slab_kernel<0>",
    "K7 NEE": r"slab_kernel<1>",
    "K8": r"walk_kernel<false>",
    "K8 any-hit": r"walk_kernel<true>",
    "K9": r"phong_walk_kernel<false>",
    "K9 any-hit": r"phong_walk_kernel<true>",
    "K10": r"phong_clusters_kernel",
    "K11": r"gen_rays_kernel",
    "K12": r"shade_kernel<\d+, (true|false), (true|false), (true|false), 0>",
    "K12 pre": r"shade_kernel<\d+, (true|false), (true|false), (true|false), 1>",
    "K12 post": r"shade_kernel<\d+, (true|false), (true|false), (true|false), 2>",
    "K11 bwd": r"gen_rays_bwd_kernel",
    "K12 bwd": r"shade_bwd_kernel<\d+, (true|false), (true|false), (true|false)>",
    "K13": r"row_gather_kernel<0, \d+>",
    "K13 bwd": r"row_gather_kernel<1, \d+>",
    "K14": r"row_gather_kernel<2, \d+>",
    "K14 bwd": r"row_gather_kernel<3, \d+>",
}


def _launch_tables() -> tuple:
    """(launch table, {name in ``counts()``: key in the table}) of every
    kernel wrapper module."""
    from pbr_tpu_torch.ops import (cuda_bvh, cuda_compact, cuda_cull, cuda_gated, cuda_intersect,
                                   cuda_phong, cuda_shade, cuda_sweep)

    gated = {"K3": "nearest", "K3 any-hit": "any-hit"}
    return tuple((mod.launches, gated if mod is cuda_gated else {k: k for k in mod.launches})
                 for mod in (cuda_intersect, cuda_gated, cuda_cull, cuda_sweep, cuda_bvh,
                             cuda_phong, cuda_shade, cuda_compact))


def count_launch(table: dict, key: str) -> None:
    """A wrapper's launch of ``key``: one more in its ``table``, unless the
    current stream is being captured, where the kernel only becomes a node
    of a CUDA graph, counted at each replay (``utils/graph.py``)."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        table[key] += 1


@functools.lru_cache(maxsize=None)
def kernel_instance(name: str):
    """The instance of ``counts()`` that the CUDA function ``name`` (its
    demangled name, as the driver or torch.profiler gives it) runs, or
    None for a function that is not one of the port's kernels."""
    found = [k for k, pat in KERNELS.items()
             if re.search(rf"(^|[\s:]){pat}\(", name)]
    if len(found) > 1:
        raise ValueError(f"{name!r} matches the kernels {found}")
    return found[0] if found else None


def kernel_counts(by_name: dict) -> dict:
    """{kernel function name: launches} (a graph's kernel nodes, a
    profiler's kernels) as {instance of ``counts()``: launches}, the
    port's kernels alone."""
    out: dict = {}
    for name, n in by_name.items():
        inst = kernel_instance(name)
        if inst is not None:
            out[inst] = out.get(inst, 0) + n
    return out


def counts() -> dict:
    """Every kernel instance's launches since ``zero_counts``: the
    wrappers' (``cuda_*.launches``, where they launch eagerly) and those of
    the CUDA graphs' replays (``utils/graph.py::replayed_kernels``, each
    replay its graph's kernel nodes as the driver holds them)."""
    from pbr_tpu_torch.utils.graph import replayed_kernels

    out = {name: table[key] for table, names in _launch_tables() for name, key in names.items()}
    for inst, n in kernel_counts(replayed_kernels()).items():
        out[inst] += n
    return out


def zero_counts() -> None:
    """Sets every launch count to 0, the replays' too."""
    from pbr_tpu_torch.utils.graph import zero_replayed

    for table, _ in _launch_tables():
        for k in table:
            table[k] = 0
    zero_replayed()
