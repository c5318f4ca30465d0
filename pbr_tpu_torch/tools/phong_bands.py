"""The Phong dispatch's band on a card: kernel K10 (the cluster search)
against kernel K9 (the Phong BVH walk) for each Phong pass, and the
threshold ``phongtess.CLUSTER_MIN_RAYS`` that the measurement calls for.

    python3 -m pbr_tpu_torch.tools.phong_bands [--out out/PHONG_BANDS_H100.json]
        [--rounds 3] [--sizes 4096,65536,262144,1048576]
    python3 -m pbr_tpu_torch.tools.phong_bands --summary docs/PHONG_BANDS_H100.json
    python3 -m pbr_tpu_torch.tools.phong_bands --oracle [--rounds 3]

Run it from the root of a checkout (it reads ``chip_smoke.py``'s Phong
scenes, camera and settings): the sphere (the Cornell box and a 24 x 12
smooth sphere, 562 faces, 9 clusters) and the dense sphere (48 x 96, 9,058
faces, 142 clusters), alpha 0.8. Each of ``--rounds`` interleaved rounds
times, for each scene, ray set (the 1024² path's camera rays in its lane
order, and 1,048,576 rays in the box) and pass size of ``--sizes`` (the
set's first rays), both searches through their wrappers (K10 with its ray
sort and candidate lists, K9 with its ray order), each a CUDA graph of
calls replayed (``k1_sweep.graph_ms``), the two in turn, the first of them
alternating between rounds; then, under each of the dispatch's two choices
(``CHOICES``: "K10", every pass of 4,096 rays or more to K10, the JAX
package's threshold; "K9", every pass to K9), the 1024² graphed frame's
ms/frame (CUDA events over ``FRAMES`` replays), its device ms (one replay
under torch.profiler, chip_smoke's ``_device_launches``) and ``fit``'s
ms/step at 64² (``app.fit_steps``' graphed ``value_and_grad``, host clock
over ``STEPS`` steps, each returning its loss). The first line is the
card's name and power limit, then ptxas's registers, shared memory and
spills of both kernels (the port's nvcc flags plus ``-Xptxas -v``, copies
built into ``build/pbr_tpu_torch/diag/``), then a line a measurement; the
JSON record
goes to ``--out`` and the policy's answer is the last line. ``--oracle``
times chip_smoke.py's Phong 64² CPU oracles under each choice instead, on
the CPU (``oracle_seconds``).

``phong_policy`` reads the record by ``band_table.band_policy``'s rule
(a move needs a win in every round on every metric): K10 keeps a pass size
only where it is faster than K9 in every round on both scenes and both ray
sets, and the "K10" choice beats the "K9" choice in every round on all
three frame metrics on both scenes; ``CLUSTER_MIN_RAYS`` is the least
measured size from which K10 keeps every larger one, None (every pass to
K9) where it keeps none. ``tests/test_torch_phong_bands.py`` holds the
constant to ``docs/PHONG_BANDS_H100.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

SIZES = (4096, 65536, 262144, 1048576)
SCENES = {"sphere": {}, "dense sphere": {"rings": 48, "segments": 96}}
RAYS = ("camera", "box")
# The dispatch's two choices: CLUSTER_MIN_RAYS under each.
CHOICES = {"K10": 4096, "K9": None}
METRICS = ("ms_frame", "device_ms", "ms_step")
FRAMES, STEPS, FIT_SIZE = 3, 5, 64


def phong_policy(record: dict) -> dict:
    """``{"cluster_min_rays": int or None, "k10_wins": [sizes where K10
    beat K9 on every pass row in every round], "frames_win": whether the
    "K10" choice beat the "K9" one on every frame metric in every round on
    every scene}``: the module's rule over ``record``."""
    sizes = sorted(record["sizes"])
    n = record["rounds"]

    def pass_win(size: int) -> bool:
        rows = [r for r in record["passes"] if r["size"] == size]
        return len(rows) == len(SCENES) * len(RAYS) and all(
            len(r["rounds"]) == n and all(x["K10"] < x["K9"] for x in r["rounds"])
            for r in rows)

    def frame_win(scene: str) -> bool:
        a, b = (record["frames"][scene][c]["rounds"] for c in ("K10", "K9"))
        return len(a) == len(b) == n and all(x[m] < y[m] for x, y in zip(a, b)
                                             for m in METRICS)

    wins = [s for s in sizes if pass_win(s)]
    frames = all(frame_win(s) for s in SCENES)
    threshold = None
    for s in reversed(sizes):
        if s not in wins or not frames:
            break
        threshold = s
    return {"cluster_min_rays": threshold, "k10_wins": wins, "frames_win": frames}


def summary(record: dict) -> str:
    """Markdown tables of ``record``: each pass row's medians (and ranges)
    of K10 and K9, each scene's frame metrics under each choice, and the
    policy."""
    rng = lambda xs: (f"{statistics.median(xs):.4f} ({min(xs):.4f}-{max(xs):.4f})")  # noqa
    out = [f"{record['device']}, {record['rounds']} rounds", "",
           "| scene | rays | pass | K10 ms | K9 ms | K10 / K9 |", "|---|---|---|---|---|---|"]
    for r in record["passes"]:
        a, b = ([x[k] for x in r["rounds"]] for k in ("K10", "K9"))
        out.append(f"| {r['scene']} | {r['rays']} | {r['size']:,} | {rng(a)} | {rng(b)} | "
                   f"{statistics.median(a) / statistics.median(b):.1f} |")
    out += ["", "| scene | choice | " + " | ".join(METRICS) + " |",
            "|---|---|" + "---|" * len(METRICS)]
    for scene, choices in record["frames"].items():
        for c, v in choices.items():
            out.append(f"| {scene} | {c} | " + " | ".join(
                rng([x[m] for x in v["rounds"]]) for m in METRICS) + " |")
    out += ["", f"policy: {json.dumps(phong_policy(record))}"]
    return "\n".join(out)


def registers() -> str:
    """ptxas's report on K9 and K10 (``k4_tiles._nvcc``), both built at
    once."""
    from concurrent.futures import ThreadPoolExecutor

    from pbr_tpu_torch.ops import cuda_intersect as ci
    from pbr_tpu_torch.tools import k4_tiles

    k4_tiles.DIAG_DIR.mkdir(parents=True, exist_ok=True)
    names = ("phong_walk", "phong_clusters")
    with ThreadPoolExecutor(len(names)) as pool:
        jobs = [pool.submit(k4_tiles._nvcc, ci.CSRC / f"{n}.cu",
                            k4_tiles.DIAG_DIR / f"{n}_ptxas.so") for n in names]
        return "\n".join(j.result() for j in jobs)


def oracle_seconds(rounds: int) -> dict:
    """Seconds of chip_smoke.py's Phong 64² CPU oracles under each of
    ``CHOICES``, ``rounds`` interleaved rounds in this process, on the CPU:
    the frame (``oracle_phase``'s CPU tracer, frame seed 5) and the
    gradient step (``_grads``, forward and backward). Under "K10" the
    passes of 4,096 rays take the plain cluster search, under "K9" the
    plain walk (host-driven, one step a node)."""
    import chip_smoke as smoke
    from pbr_tpu_torch import PathTracer, camera_to_torch
    from pbr_tpu_torch.ops import phongtess
    from pbr_tpu_torch.scene.build import scene_from_text
    from pbr_tpu_torch.scene.device import to_torch

    size = 64
    scene, _ = scene_from_text(*smoke.cornell_sphere(), use_bvh=True,
                               phong_tess_alpha=smoke.PHONG_ALPHA)
    _, cam = smoke.cornell()
    settings = smoke.bench_settings(size, phong_tessellation=smoke.PHONG_ALPHA)
    ts = to_torch(scene, "cpu").requires_grad_()
    cam_t = camera_to_torch(cam, "cpu")
    for c in cam_t.eye:
        c.requires_grad_()
    ids = torch.arange(size * size, dtype=torch.int32)
    out = {c: {"frame_s": [], "grads_s": []} for c in CHOICES}
    for k in range(rounds):
        for choice in (tuple(CHOICES) if k % 2 == 0 else tuple(CHOICES)[::-1]):
            with phongtess.threshold(CHOICES[choice]):
                t0 = time.perf_counter()
                PathTracer(scene, settings, device="cpu", lane_order="scanline").render(
                    cam, frame_seed=5)
                t1 = time.perf_counter()
                smoke._grads(ts, cam_t, settings, ids)
                t2 = time.perf_counter()
            out[choice]["frame_s"].append(t1 - t0)
            out[choice]["grads_s"].append(t2 - t1)
            print(f"round {k}: choice {choice}: frame {t1 - t0:.3f} s, gradient step "
                  f"{t2 - t1:.3f} s", flush=True)
    return {"size": size, "rounds": rounds, "threads": torch.get_num_threads(),
            "choices": CHOICES, "seconds": out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/PHONG_BANDS_H100.json")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sizes", default=",".join(str(s) for s in SIZES))
    ap.add_argument("--summary", help="print the tables of a record and exit (no card)")
    ap.add_argument("--oracle", action="store_true",
                    help="time chip_smoke.py's Phong 64² CPU oracles under each choice and "
                         "exit (no card)")
    a = ap.parse_args(argv)
    if a.summary:
        with open(a.summary) as f:
            print(summary(json.load(f)))
        return
    if a.oracle:
        print(json.dumps(oracle_seconds(a.rounds)), flush=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("phong_bands: no CUDA device")
    import chip_smoke as smoke  # the repo root's: its scenes, camera and settings
    from pbr_tpu_torch import PathTracer, app, camera_to_torch
    from pbr_tpu_torch.ops import cuda_phong as cp
    from pbr_tpu_torch.ops import phongtess
    from pbr_tpu_torch.scene.build import scene_from_text
    from pbr_tpu_torch.scene.device import to_torch
    from pbr_tpu_torch.tools import k1_sweep
    from pbr_tpu_torch.utils.config import RenderSettings
    from pbr_tpu_torch.ops.vec import Vec3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    ptxas = registers()
    print(ptxas, flush=True)
    sizes = sorted(int(s) for s in a.sizes.split(","))
    dev = torch.device("cuda", 0)
    alpha = smoke.PHONG_ALPHA
    _, cam = smoke.cornell()
    settings = smoke.bench_settings(smoke.SIZE, phong_tessellation=alpha)
    fit_settings = RenderSettings().replace(width=FIT_SIZE, height=FIT_SIZE, shadow_rays=1,
                                            brdf=0, max_depth=2, max_added_depth=0,
                                            phong_tessellation=alpha)
    box = smoke._rays_in_box(smoke.BOUNCE_RAYS, 5, dev)
    setup = {}
    for name, kw in SCENES.items():
        t0 = time.perf_counter()
        scene, _ = scene_from_text(*smoke.cornell_sphere(**kw), use_bvh=True,
                                   phong_tess_alpha=alpha)
        ts = to_torch(scene, dev)
        pts, fits = {}, {}
        prob = app.fit_problem(scene, fit_settings, cam, dev)
        kd0 = prob.ts.mat_kd.detach().clone()
        for choice, thr in CHOICES.items():
            with phongtess.threshold(thr):
                pts[choice] = PathTracer(scene, settings, device=dev)
                pts[choice].render(cam, frame_seed=0)  # the probes, the capture
                fits[choice] = app.fit_steps(prob)[0]
                fits[choice](kd0)  # the capture
        pt = pts["K9"]
        cam_rays = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
        setup[name] = dict(ts=ts, pts=pts, fits=fits, kd0=kd0,
                           rays={"camera": cam_rays, "box": box})
        print(f"{name}: {scene.tris.count} faces, {ts.clusters.count} clusters, set up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    record = {"device": smi, "ptxas": ptxas, "rounds": a.rounds, "sizes": sizes, "alpha": alpha,
              "choices": CHOICES, "passes": [], "frames": {}}
    rows = {}
    for k in range(a.rounds):
        for name, st in setup.items():
            ts = st["ts"]
            faces = ts.phong_records
            for rays in RAYS:
                for size in sizes:
                    o, d = (Vec3(*(c[:size].contiguous() for c in v)) for v in st["rays"][rays])
                    fns = {"K10": lambda: cp.intersect_clusters(o, d, ts.clusters, faces, alpha),
                           "K9": lambda: cp.intersect_walk(o, d, ts.bvh, faces, alpha)}
                    if k == 0:  # the share of rays on which the two find one face
                        same = float((fns["K10"]()[0] == fns["K9"]()[1]).float().mean())
                        rows[name, rays, size] = {"scene": name, "rays": rays, "size": size,
                                                  "same_face": same, "rounds": []}
                    got = {}
                    for search in (("K10", "K9") if k % 2 == 0 else ("K9", "K10")):
                        fn = fns[search]
                        got[search] = k1_sweep.graph_ms(fn, smoke._graph_iters(fn))
                    rows[name, rays, size]["rounds"].append(got)
                    print(f"round {k}: {name}, {rays} rays, {size}: K10 {got['K10']:.4f} ms, "
                          f"K9 {got['K9']:.4f} ms", flush=True)
            for choice in (tuple(CHOICES) if k % 2 == 0 else tuple(CHOICES)[::-1]):
                pt, vg = st["pts"][choice], st["fits"][choice]
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for i in range(FRAMES):
                    pt.render(cam, frame_seed=1 + i)
                end.record()
                end.synchronize()
                ms_frame = start.elapsed_time(end) / FRAMES
                dev_ms = smoke._device_launches(lambda: pt.render(cam, frame_seed=1 + FRAMES))[1]
                vg(st["kd0"])
                t0 = time.perf_counter()
                for _ in range(STEPS):
                    vg(st["kd0"])
                ms_step = (time.perf_counter() - t0) * 1e3 / STEPS
                got = {"ms_frame": ms_frame, "device_ms": dev_ms, "ms_step": ms_step}
                frames = record["frames"].setdefault(name, {})
                frames.setdefault(choice, {"cluster_min_rays": CHOICES[choice], "rounds": []})
                frames[choice]["rounds"].append(got)
                print(f"round {k}: {name}, choice {choice}: " + ", ".join(
                    f"{m} {v:.4f}" for m, v in got.items()), flush=True)
    record["passes"] = list(rows.values())
    record["policy"] = phong_policy(record)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(record, f, indent=1)
    print(summary(record), flush=True)
    print(json.dumps({"device": smi, "policy": record["policy"],
                      "phongtess.CLUSTER_MIN_RAYS": phongtess.CLUSTER_MIN_RAYS}), flush=True)


if __name__ == "__main__":
    main()
