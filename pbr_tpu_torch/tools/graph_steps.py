"""The bench's step eager against graphed, in one process, on the card.

    python3 -m pbr_tpu_torch.tools.graph_steps [--size 1024] [--frames 8]
        [--rounds 3] [--scenes cornell,multiroom,soup:100000,phong]
        [--out out/graph_steps.json]
    python3 -m pbr_tpu_torch.tools.graph_steps --compare A.json B.json [--tol 1e-3]

For each scene of ``--scenes`` (``bench.load_scene``'s names, and
``phong``: the Cornell box with a smooth sphere, ``cornell_sphere``, at
alpha ``PHONG_ALPHA``), forward and forward+backward, at ``--size``² with
bench.py's settings (``bench_case``): the step of ``--frames`` frames the
eager way (``bench.step``, op by op, as the port ran it before its steps
were captured) and the graphed way (``bench.FrameStep``: one frame's CUDA
graph replayed once a frame, as ``python -m pbr_tpu_torch.bench`` times
it), ``--rounds`` interleaved rounds of each, every step timed with CUDA
events and, for the device's busy share, its kernels' time from
torch.profiler in the last round. The two forms' sums are held bitwise
first. Prints the card's nvidia-smi name and power limit, a line a
configuration with the eager step's ``TOP`` kernels by device time, and
one JSON object last (also written to ``--out``): per configuration rays a
frame, ms/frame of each round in each form, device ms a frame, the eager
step's kernels a frame and its ``TOP`` kernels (device ms and launches a
frame), the capture's seconds, nodes and pool bytes, the port's kernel
nodes of the graph (its launches a replay, by instance; held equal to the
eager step's launches over ``--frames`` frames), the port's kernels that
the device ran over ``--frames`` bare replays (torch.profiler; held to
``--frames`` times the graph's), peak memory; ``digests``: the SHA-256
of the eager step's sums (the loss, and each gradient of the backward
step) and, forward, of one frame's colours (seed 7); and ``values``: the
backward step's gradients. ``--compare`` holds two records' digests equal
tensor by tensor (bitwise equal tensors); with ``--tol`` a gradient may
instead lie within ``tol`` of its largest magnitude in the second record
(two trees whose backward sums the same terms in other orders), while
forward frames and losses stay bitwise.

The file imports of the port only what every tree has had since its
frames were captured, so run as a script with another checkout's root on
``PYTHONPATH`` (``PYTHONPATH=out/<tree> python3
pbr_tpu_torch/tools/graph_steps.py ...``, an older tree unpacked by ``git
archive``) it measures that tree's package, and two trees compare in one
call. Needs a card (``--compare`` does not).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from pbr_tpu_torch import bench
from pbr_tpu_torch.ops import counts, kernel_counts, zero_counts

PHONG_ALPHA = 0.8
TOP = 12  # the eager step's kernels by device time that a row lists


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
    (its device ms, {kernel function name: launches}, {kernel function
    name: device ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    ms = Counter()
    for e in ev:
        ms[e.name()] += e.duration_ns() / 1e6
    return sum(ms.values()), dict(Counter(e.name() for e in ev)), dict(ms)


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's dtype, shape and bytes: equal digests, bitwise
    equal tensors (-0.0 is not +0.0; a NaN equals itself)."""
    t = t.detach().contiguous().cpu()
    return hashlib.sha256(str((t.dtype, tuple(t.shape))).encode()
                          + t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def compare(a: str, b: str, tol=None) -> dict:
    """{configuration/tensor: True where the two records' digests are
    equal, or, with ``tol``, for a gradient of the backward step, where
    each entry of the first lies within ``tol`` of the second's largest
    magnitude}: every value True when the two trees' frames and losses are
    bitwise equal and their gradients equal (or within ``tol``)."""
    x, y = (json.loads(Path(p).read_text()) for p in (a, b))
    out = {}
    for row in sorted(set(x["digests"]) | set(y["digests"])):
        dx, dy = x["digests"].get(row, {}), y["digests"].get(row, {})
        vx, vy = x.get("values", {}).get(row, {}), y.get("values", {}).get(row, {})
        for k in sorted(set(dx) | set(dy)):
            same = dx.get(k) == dy.get(k)
            if not same and tol is not None and k in vx and k in vy:
                u, v = np.asarray(vx[k], np.float64), np.asarray(vy[k], np.float64)
                same = u.shape == v.shape and bool(
                    np.all(np.abs(u - v) <= tol * (np.abs(v).max() if v.size else 0.0)))
            out[f"{row}/{k}"] = same
    return out


def bench_case(name: str, size: int, dev) -> "bench.Bench":
    """``bench.bench_scene(name, size, dev)``, or for ``phong`` the Cornell
    box with a smooth sphere at alpha ``PHONG_ALPHA`` under bench.py's
    settings with Cornell's camera and lane order and the probed
    compaction schedule."""
    if name != "phong":
        return bench.bench_scene(name, size, dev)
    from pbr_tpu_torch.models.pathtracer import probe_compact_schedule
    from pbr_tpu_torch.scene.build import derive_static_flags, scene_from_text
    from pbr_tpu_torch.scene.device import camera_to_torch, to_torch
    from pbr_tpu_torch.scene.procedural import cornell_sphere

    scene, _ = scene_from_text(*cornell_sphere(), use_bvh=True, phong_tess_alpha=PHONG_ALPHA)
    ts = to_torch(scene, dev)
    cam = camera_to_torch(bench.load_scene("cornell")[1], dev)
    settings = derive_static_flags(scene, bench.bench_settings(
        size, phong_tessellation=PHONG_ALPHA))
    settings = settings.replace(compact_schedule=probe_compact_schedule(ts, cam, settings))
    ids = torch.arange(size * size, dtype=torch.int32, device=dev)
    return bench.Bench(ts, cam, settings, ids, "phong")


def profiled_replays(step, n: int, tries: int = 8) -> dict:
    """{kernel instance: launches} of the port's kernels that the device
    ran over ``n`` bare replays of the captured ``step`` (a
    ``CapturedStep``), by torch.profiler: ``n`` times the graph's kernel
    nodes of the port when all ran. The profiler (CUPTI) loses records:
    on the H100 a port kernel's once in some tens of windows of a few
    frames' replays, one of torch's kernels in every window of some
    graphs, and in a window of two replays of an 18,402-node graph a
    quarter to a half of several port kernels' records, while the frames came out
    bitwise (so the kernels ran). So windows of ``n`` replays are taken
    until each instance has shown its full count in one of them, up to
    ``tries`` windows, and each instance's most over the windows is
    returned: a profiler records no launch that did not happen, and a node
    that does not run is short in every window. A window over the graph's
    count is returned as it is."""
    want = {k: n * v for k, v in kernel_counts(step.kernels).items()}
    best: dict = {}
    for _ in range(tries):
        ran = kernel_counts(profiled(lambda: [step() for _ in range(n)])[1])
        if set(ran) - set(want) or any(v > want[k] for k, v in ran.items()):
            return ran
        for k, v in ran.items():
            best[k] = max(best.get(k, 0), v)
        if best == want:
            break
    return best


def measure(name: str, fwd_only: bool, size: int, frames: int, rounds: int, dev,
            top: int = 0) -> dict:
    """One configuration, eager against graphed (module docstring)."""
    b = bench_case(name, size, dev)
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
    if fwd_only:
        from pbr_tpu_torch.models.integrator import trace_rays

        with torch.no_grad():
            c = trace_rays(b.scene, b.cam, b.settings, b.pixel_ids, 7).color
        sums = {"loss": digest(ref), "frame": digest(torch.stack(list(c)))}
    else:
        sums = {"loss": digest(ref[0]), **{k: digest(g) for k, g in ref[1].items()}}
    values = {} if fwd_only else {k: g.detach().cpu().reshape(-1).tolist()
                                  for k, g in ref[1].items()}
    torch.cuda.reset_peak_memory_stats()
    ms = {"eager": [], "graph": []}
    for r in range(rounds):
        ms["eager"].append(_events_ms(lambda: eager(2 + r)) / frames)
        ms["graph"].append(_events_ms(lambda: fs(2 + r, frames)) / frames)
    zero_counts()
    dev_eager, eager_kernels, eager_ms = profiled(lambda: eager(9))
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
    heavy = sorted(eager_ms, key=lambda k: -eager_ms[k])[:top]
    return {"rays": n_path + n_shadow, "ms_eager": ms["eager"], "ms_graph": ms["graph"],
            "device_ms_eager": dev_eager / frames, "device_ms_graph": dev_graph / frames,
            "kernels_eager": sum(eager_kernels.values()) / frames,
            "top_eager": [{"kernel": k[:160], "ms": eager_ms[k] / frames,
                           "launches": eager_kernels[k] / frames} for k in heavy],
            "digests": sums, "values": values,
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
    ap.add_argument("--scenes", default="cornell,multiroom,soup:100000,phong")
    ap.add_argument("--out", default="out/graph_steps.json")
    ap.add_argument("--compare", nargs=2, metavar=("A.json", "B.json"))
    ap.add_argument("--tol", type=float, default=None,
                    help="with --compare: the gradients' tolerance, a share of the largest "
                         "magnitude")
    a = ap.parse_args(argv)
    if a.compare:
        print(json.dumps(compare(*a.compare, tol=a.tol)))
        return
    if not torch.cuda.is_available():
        raise SystemExit("graph_steps: needs a CUDA card")
    from pbr_tpu_torch.utils.log import Logger

    Logger.stream = sys.stderr
    dev = torch.device("cuda", 0)
    card = bench.card_line()
    print(card, flush=True)
    res = {"card": card, "size": a.size, "frames": a.frames, "rounds": a.rounds, "rows": {},
           "digests": {}, "values": {}}
    t0 = time.perf_counter()
    for name in a.scenes.split(","):
        for fwd_only in (True, False):
            key = f"{name} {'fwd' if fwd_only else 'fwd+bwd'}"
            row = measure(name, fwd_only, a.size, a.frames, a.rounds, dev, TOP)
            res["digests"][key] = row.pop("digests")
            res["values"][key] = row.pop("values")
            res["rows"][key] = row
            fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)  # noqa: E731
            print(f"{key}: {row['rays']} rays a frame; ms/frame eager [{fmt(row['ms_eager'])}], "
                  f"graphed [{fmt(row['ms_graph'])}]; device ms a frame eager "
                  f"{row['device_ms_eager']:.3f}, graphed {row['device_ms_graph']:.3f}; capture "
                  f"{row['capture_s']:.3f} s, {row['nodes']} nodes, pool "
                  f"{row['pool_bytes'] / 2**20:.1f} MiB; peak {row['peak_mib']:.1f} MiB; "
                  f"eager kernels a frame {row['kernels_eager']:g}", flush=True)
            for k in row["top_eager"]:
                print(f"   {k['ms']:9.4f} ms {k['launches']:8g}x {k['kernel'][:110]}",
                      flush=True)
            torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
