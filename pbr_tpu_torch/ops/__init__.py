"""Tensor ops: vec math, RNG, intersection, BRDFs, kernel wrappers."""


def _launch_tables() -> tuple:
    from pbr_tpu_torch.ops import cuda_bvh, cuda_cull, cuda_gated, cuda_intersect, cuda_sweep

    return cuda_intersect, cuda_gated, cuda_cull, cuda_sweep, cuda_bvh


def counts() -> dict:
    """Every kernel instance's launch count, over the wrappers' launch
    tables (``cuda_*.launches``)."""
    ci, cg, cc, cs, cb = _launch_tables()
    return {**ci.launches, "K3": cg.launches["nearest"], "K3 any-hit": cg.launches["any-hit"],
            **cc.launches, **cs.launches, **cb.launches}


def zero_counts() -> None:
    """Sets every launch count to 0."""
    for mod in _launch_tables():
        for k in mod.launches:
            mod.launches[k] = 0
