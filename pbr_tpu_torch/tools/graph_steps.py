"""The bench's step eager against graphed, in one process, on the card.

    python3 -m pbr_tpu_torch.tools.graph_steps [--size 1024] [--frames 8]
        [--rounds 3] [--scenes cornell,multiroom,soup:100000]
        [--out out/graph_steps.json]

For each scene of ``--scenes`` (``bench.load_scene``'s names), forward and
forward+backward, at ``--size``² with bench.py's settings
(``bench.bench_scene``): the step of ``--frames`` frames the eager way
(``bench.step``, op by op, as the port ran it before its steps were
captured) and the graphed way (``bench.FrameStep``: one frame's CUDA graph
replayed once a frame, as ``python -m pbr_tpu_torch.bench`` times it),
``--rounds`` interleaved rounds of each, every step timed with CUDA events
and, for the device's busy share, its kernels' time from torch.profiler in
the last round. The two forms' sums are held bitwise first. Prints the
card's nvidia-smi name and power limit, a line a configuration, and one
JSON object last (also written to ``--out``): per configuration rays a
frame, ms/frame of each round in each form, device ms a frame, the
capture's seconds, nodes and pool bytes, the port's kernel nodes of the
graph (its launches a replay, by instance; held equal to the eager
step's launches over ``--frames`` frames), the port's kernels that the
device ran over ``--frames`` bare replays (torch.profiler; held to
``--frames`` times the graph's), peak memory. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

import torch

from pbr_tpu_torch import bench
from pbr_tpu_torch.ops import counts, kernel_counts, zero_counts


def _events_ms(fn) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def profiled(fn) -> tuple:
    """What the device ran over one call of ``fn``, by torch.profiler:
    (its device ms, {kernel function name: launches})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in ev) / 1e6, dict(Counter(e.name() for e in ev))


def profiled_replays(step, n: int, tries: int = 3) -> dict:
    """{kernel instance: launches} of the port's kernels that the device
    ran over ``n`` bare replays of the captured ``step`` (a
    ``CapturedStep``), by torch.profiler: ``n`` times the graph's kernel
    nodes of the port when all ran. The profiler (CUPTI) loses a record
    now and then: on the H100 a port kernel's once in some tens of windows
    of a few frames' replays, while the frames came out bitwise (so the
    kernel ran), and one of torch's kernels in every window of some
    graphs. So a window short of some port kernel and over none is taken
    again, up to ``tries`` windows: a node that does not run is short in
    every one."""
    want = {k: n * v for k, v in kernel_counts(step.kernels).items()}
    for _ in range(tries):
        ran = kernel_counts(profiled(lambda: [step() for _ in range(n)])[1])
        over = set(ran) - set(want) or any(v > want[k] for k, v in ran.items())
        if ran == want or over:
            break
    return ran


def measure(name: str, fwd_only: bool, size: int, frames: int, rounds: int, dev) -> dict:
    """One configuration, eager against graphed (module docstring)."""
    b = bench.bench_scene(name, size, dev)
    n_path, n_shadow, _ = bench.count_rays(b)
    if not fwd_only:
        b = bench.differentiable(b)
    fs = bench.FrameStep(b, fwd_only)

    def eager(seed0):
        return bench.step(b.scene, b.cam, b.settings, b.pixel_ids, seed0, frames=frames,
                          fwd_only=fwd_only) if fwd_only else \
            bench.step_grads(b.scene, b.cam, b.settings, b.pixel_ids, seed0, frames=frames)

    fs(1, frames)  # the eager warm-up frame and the capture
    got, ref = fs(1, frames), eager(1)
    if fwd_only:
        same = torch.equal(got, ref)
    else:
        same = torch.equal(got[0], ref[0]) and all(torch.equal(got[1][k], g)
                                                   for k, g in ref[1].items())
    if not same:
        raise AssertionError(f"{name}: the graphed step differs from the eager step")
    torch.cuda.reset_peak_memory_stats()
    ms = {"eager": [], "graph": []}
    for r in range(rounds):
        ms["eager"].append(_events_ms(lambda: eager(2 + r)) / frames)
        ms["graph"].append(_events_ms(lambda: fs(2 + r, frames)) / frames)
    zero_counts()
    dev_eager = profiled(lambda: eager(9))[0]
    eager_launches = {k: v for k, v in counts().items() if v}
    dev_graph = profiled(lambda: fs(9, frames))[0]
    per_replay = kernel_counts(fs.graph.kernels)
    if eager_launches != {k: frames * v for k, v in per_replay.items()}:
        raise AssertionError(f"{name}: the eager step launched {eager_launches}, the graph "
                             f"holds {per_replay} of the port's kernel nodes a frame")
    ran = profiled_replays(fs.graph, frames)
    if ran != {k: frames * v for k, v in per_replay.items()}:
        raise AssertionError(f"{name}: over {frames} replays the device ran {ran} of the "
                             f"port's kernels, the graph holds {per_replay} a replay")
    st = fs.graph.stats()
    return {"rays": n_path + n_shadow, "ms_eager": ms["eager"], "ms_graph": ms["graph"],
            "device_ms_eager": dev_eager / frames, "device_ms_graph": dev_graph / frames,
            "capture_s": st["capture_s"], "nodes": st["nodes"], "pool_bytes": st["pool_bytes"],
            "launches_a_replay": per_replay, "device_launches": ran,
            "grads": None if fwd_only else len(ref[1]),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m pbr_tpu_torch.tools.graph_steps",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=8, help="frames a timed step")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--scenes", default="cornell,multiroom,soup:100000")
    ap.add_argument("--out", default="out/graph_steps.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("graph_steps: needs a CUDA card")
    from pbr_tpu_torch.utils.log import Logger

    Logger.stream = sys.stderr
    dev = torch.device("cuda", 0)
    card = bench.card_line()
    print(card, flush=True)
    res = {"card": card, "size": a.size, "frames": a.frames, "rounds": a.rounds, "rows": {}}
    t0 = time.perf_counter()
    for name in a.scenes.split(","):
        for fwd_only in (True, False):
            key = f"{name} {'fwd' if fwd_only else 'fwd+bwd'}"
            row = measure(name, fwd_only, a.size, a.frames, a.rounds, dev)
            res["rows"][key] = row
            fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)  # noqa: E731
            print(f"{key}: {row['rays']} rays a frame; ms/frame eager [{fmt(row['ms_eager'])}], "
                  f"graphed [{fmt(row['ms_graph'])}]; device ms a frame eager "
                  f"{row['device_ms_eager']:.3f}, graphed {row['device_ms_graph']:.3f}; capture "
                  f"{row['capture_s']:.3f} s, {row['nodes']} nodes, pool "
                  f"{row['pool_bytes'] / 2**20:.1f} MiB; peak {row['peak_mib']:.1f} MiB",
                  flush=True)
            torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
