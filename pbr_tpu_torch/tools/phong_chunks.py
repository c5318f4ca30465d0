"""The chunk of the Phong cluster search's plain version
(``phongtess.PHONG_CHUNK_RAYS``) against pass time, frame time and peak
memory, on a card. Since kernel K10 (``ops/cuda_phong.py``) runs the search
on the card, unchunked, the chunk sizes only the plain version, which
chip_smoke.py holds K10 to; the frames it times go through the dispatch's
searches (``phongtess.CLUSTER_MIN_RAYS``: K9 alone under the card's band).

    python3 -m pbr_tpu_torch.tools.phong_chunks [--chunks 65536,131072,262144,524288]
                                                [--frames 1]

Run it from the root of a checkout: it builds ``chip_smoke.py``'s Phong
scene (the Cornell box and a 24 x 12 smooth sphere, 562 faces, alpha 0.8)
and its path at 1024² with bench.py's settings and the probed compaction
schedule and lane order. For each chunk of ``--chunks`` in the order
given, then again in the reverse order, it sets
``phongtess.PHONG_CHUNK_RAYS`` and times one cluster search pass
(``intersect_clusters_phongtess``, host clock around a synchronised call,
after one call to warm up) on the path's 1,048,576 camera rays and on
1,048,576 bounce-like rays in the box, each with its peak device memory,
rounds and tile-rounds; the answers must not depend on the chunk (each
run's are held bitwise to the first run's). In the first pass over the
chunks it also renders ``--frames`` timed frames (CUDA events) with their
peak. One line a run, then a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from pbr_tpu_torch import PathTracer, camera_to_torch
from pbr_tpu_torch.ops import phongtess


def _pass(o, d, ts, alpha: float) -> tuple:
    """One cluster search pass: (answers, ms, peak MiB, stats)."""
    args = (o, d, ts.clusters, ts.tris, alpha)
    phongtess.intersect_clusters_phongtess(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    out = phongtess.intersect_clusters_phongtess(*args, stats=stats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() / 2**20, stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default="65536,131072,262144,524288",
                    help="rays a chunk, whole 128-ray tiles")
    ap.add_argument("--frames", type=int, default=1, help="timed frames a chunk")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phong_chunks: no CUDA device")
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings
    from pbr_tpu_torch.scene.build import scene_from_text

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    chunks = [int(c) for c in a.chunks.split(",")]
    if any(c <= 0 or c % 128 for c in chunks):
        raise SystemExit("phong_chunks: a chunk is a positive multiple of 128 rays")
    dev = torch.device("cuda", 0)
    alpha = smoke.PHONG_ALPHA
    scene, _ = scene_from_text(*smoke.cornell_sphere(), use_bvh=True, phong_tess_alpha=alpha)
    _, cam = smoke.cornell()
    settings = smoke.bench_settings(smoke.SIZE, compact_schedule="auto",
                                    phong_tessellation=alpha)
    pt = PathTracer(scene, settings, device=dev)
    pt.render(cam, frame_seed=0)  # the probes
    rays = {"camera": smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev,
                                         pt.pixel_ids),
            "bounce": smoke._rays_in_box(smoke.BOUNCE_RAYS, 5, dev)}
    default = phongtess.PHONG_CHUNK_RAYS
    runs, ref = [], {}
    try:
        for i, chunk in enumerate(chunks + chunks[::-1]):
            phongtess.PHONG_CHUNK_RAYS = chunk
            run = {"chunk": chunk}
            for name, (o, d) in rays.items():
                out, ms, peak, stats = _pass(o, d, pt.scene, alpha)
                ref.setdefault(name, out)
                if not all(torch.equal(x, y) for x, y in zip(out, ref[name])):
                    raise AssertionError(f"phong_chunks: {chunk} rays a chunk changed the "
                                         f"{name} answers")
                run.update({f"{name}_ms": ms, f"{name}_peak_mib": peak,
                            f"{name}_rounds": stats["rounds"],
                            f"{name}_tile_rounds": stats["tile_rounds"]})
            if i < len(chunks) and a.frames:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for f in range(a.frames):
                    pt.render(cam, frame_seed=1 + f)
                end.record()
                end.synchronize()
                run.update(ms_frame=start.elapsed_time(end) / a.frames,
                           peak_frame_mib=torch.cuda.max_memory_allocated() / 2**20)
            runs.append(run)
            print(", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in run.items()), flush=True)
    finally:
        phongtess.PHONG_CHUNK_RAYS = default
    print(json.dumps({"device": smi, "lane_order": pt.lane_order,
                      "schedule": pt.settings.compact_schedule, "phong_chunks": runs}),
          flush=True)


if __name__ == "__main__":
    main()
