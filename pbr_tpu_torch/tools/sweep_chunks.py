"""The row sweep's list chunk against frame time and peak memory, on a card.

    python3 -m pbr_tpu_torch.tools.sweep_chunks [--chunks 131072,262144,524288]

Run it from the root of a checkout: it renders ``chip_smoke.py``'s
soup:100000 path through intersector='sweep' (kernel K5) at 1024², with its
bench settings and its probed compaction schedule and lane order. For each
chunk size of ``--chunks`` in the order given, then again in the reverse
order, it sets ``cuda_sweep.SWEEP_CHUNK_RAYS`` and renders 2 warm-up frames
and 8 timed frames (CUDA events around them), with the peak device memory
(``torch.cuda.max_memory_allocated``) reset before the timed frames; then
it times the wrapper (``intersect_sweep`` with NEE, 5 calls) on the path's
1,048,576 camera rays, with its own peak. The wrapper's answers must not
depend on the chunk: each run's are held bitwise to the first run's. One
line a run, then a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from pbr_tpu_torch import PathTracer, camera_to_torch
from pbr_tpu_torch.ops import cuda_sweep as cs


def _run(smoke, pt, cam, rays, chunk: int) -> dict:
    """One chunk size: the timed frames and the wrapper, with their peaks."""
    cs.SWEEP_CHUNK_RAYS = chunk
    for i in range(smoke.WARMUP):
        pt.render(cam, frame_seed=i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(smoke.WARMUP, smoke.WARMUP + smoke.FRAMES):
        pt.render(cam, frame_seed=i)
    end.record()
    end.synchronize()
    out = {"chunk": chunk, "ms_frame": start.elapsed_time(end) / smoke.FRAMES,
           "peak_frame_mib": torch.cuda.max_memory_allocated() / 2**20}
    torch.cuda.reset_peak_memory_stats()
    out["wrapper_ms"] = smoke._time_ms(lambda: cs.intersect_sweep(*rays), 5)
    out["peak_wrapper_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default="131072,262144,524288", help="rays a chunk, whole tiles")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_chunks: no CUDA device")
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    chunks = [int(c) for c in a.chunks.split(",")]
    if any(c <= 0 or c % cs.TILE for c in chunks):
        raise SystemExit(f"sweep_chunks: a chunk is a positive multiple of {cs.TILE} rays")
    dev = torch.device("cuda", 0)
    smoke._build_native()
    scene, cam = smoke.soup()
    settings = smoke.bench_settings(smoke.SIZE, compact_schedule="auto", intersector="sweep")
    pt = PathTracer(scene, settings, device=dev)
    pt.render(cam, frame_seed=0)  # the probes
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    rays = (o, d, pt.scene.clusters, smoke._light0(pt.scene))
    runs, ref = [], None
    for chunk in chunks + chunks[::-1]:
        cs.SWEEP_CHUNK_RAYS = chunk
        got = cs.intersect_sweep(*rays)
        ref = got if ref is None else ref
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"sweep_chunks: {chunk} rays a chunk changed the answers")
        runs.append(_run(smoke, pt, cam, rays, chunk))
        print(", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in runs[-1].items()), flush=True)
    print(json.dumps({"device": smi, "lane_order": pt.lane_order, "sweep_chunks": runs}),
          flush=True)


if __name__ == "__main__":
    main()
