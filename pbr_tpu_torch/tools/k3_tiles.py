"""Where kernel K3's time goes across its blocks, and what its passes need,
on a card.

    python3 -m pbr_tpu_torch.tools.k3_tiles [--out out/k3_tiles.json]

Run it from the root of a checkout: it takes ``chip_smoke.py``'s multiroom
scene (bench.py --scene multiroom: 1,428 faces in 32 clusters of 64) and
its 1,048,576 camera rays (frame 0 in the path's lane order), run through
the gated wrapper with both passes recorded (nearest, and the any-hit pass
of the hits' shadow rays), and the two passes of bounce 1 of a recorded
1024² ``auto`` frame (the second of its 8 bounces).

For each pass it prints the plain side's counts (``pass_counts``, torch
ops on the recorded arguments): tiles, gated-in clusters a tile (max,
mean), live lanes a tile, the real-face tests of the ``n_tests`` counter,
the tests whose t can change the result (the bound's u-v tests: nearest
``1e-5 <= t <=`` the ray's final t, any-hit up to and including the first
occluder), the u-v tests of a sweep in order against the running best,
and at each gated-in section the lanes and the 32-lane warps that can no
longer change (nearest: dead; any-hit: occluded or seeded 1).

``csrc/gated_intersect.cu`` is built into ``build/pbr_tpu_torch/diag/``
twice, at once, with the port's nvcc flags plus ``-Xptxas -v`` (every
kernel's registers, shared memory and spills are printed; ``csrc/`` is
not changed): as it is, and with a record a block: its ``%globaltimer``
(ns) at its start and at its end, its SM and the first ray of its thread
0. The first copy is held bitwise to the plain version
(``cuda_gated._sweep_plain``) on every pass, then timed with CUDA events
(20 launches of ``_sweep_kernel``, as chip_smoke times K3); the copy with
the record runs once, must give the same answers, and prints the blocks'
span, median and last end, the tail (last end after the median), the
longest block and its gated-in clusters (``k4_tiles.block_stats``). The
JSON record goes to ``--out``.

The tool drives only ``cuda_gated._gated``, ``_sweep_kernel``,
``_sweep_plain`` and ``load``, so that a copy of it measures an earlier
tree's K3 as well.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pbr_tpu_torch import PathTracer, camera_to_torch
from pbr_tpu_torch.ops import cuda_gated as cg
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.intersect import EPS5
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.tools.k4_tiles import _body, _nvcc, block_stats

DIAG_DIR = ci.BUILD_DIR / "diag"
FILE = "gated_intersect.cu"
KERNEL = "gated_kernel"
WARP = 32
_HEAD = "#include <cuda_runtime.h>\n"
_DECL = "__device__ long long* g_block_rec;  // 4 words a block: start, end, SM, first ray\n"
_SETTER = """
extern "C" int pbr_diag_set(long long* rec) {
  return static_cast<int>(cudaMemcpyToSymbol(g_block_rec, &rec, sizeof(rec)));
}
"""
_START = 'long long diag_t0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t0)); '
_END = (" __syncthreads(); if (threadIdx.x == 0) { long long diag_t1; unsigned diag_sm; "
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t1)); '
        'asm volatile("mov.u32 %0, %%smid;" : "=r"(diag_sm)); '
        "long long* diag_q = g_block_rec + 4 * static_cast<long long>(blockIdx.x); "
        "diag_q[0] = diag_t0; diag_q[1] = diag_t1; diag_q[2] = diag_sm; "
        "diag_q[3] = static_cast<long long>(@TAG@); } ")


def clock_patch(src: str, file: str, kernel: str, tag: str, decl: str = _DECL,
                setter: str = _SETTER) -> str:
    """``src`` with a record a block: ``kernel`` reads ``%globaltimer`` at
    its start and, after a ``__syncthreads``, at its end, and its thread 0
    writes (start, end, SM, ``tag``) to row ``blockIdx.x`` of the array
    that ``pbr_diag_set`` names. Raises where the kernel or the include is
    missing, or where the kernel returns early."""
    if _HEAD not in src:
        raise ValueError(f"{file}: no '#include <cuda_runtime.h>' line")
    lo, hi = _body(src, kernel, file)
    if re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", src[lo:hi])):
        raise ValueError(f"{file}: {kernel} returns early; the record is written at its end")
    src = src[:lo] + _START + src[lo:hi] + _END.replace("@TAG@", tag) + src[hi:] + setter
    return src.replace(_HEAD, _HEAD + decl, 1)


def build() -> dict:
    """The source as it is and with the record, built at once:
    {record: (library, ptxas report)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / FILE).read_text()
    jobs = {}
    for record in (False, True):
        copy = DIAG_DIR / f"k3{'_record' if record else ''}.cu"
        copy.write_text(clock_patch(src, FILE, KERNEL, "first") if record else src)
        jobs[record] = (copy, copy.with_suffix(".so"))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        reports = dict(zip(jobs, pool.map(lambda j: _nvcc(*j), jobs.values())))
    libs = {}
    for record, (_, so) in jobs.items():
        lib = ctypes.CDLL(str(so))
        if record:
            lib.pbr_diag_set.argtypes, lib.pbr_diag_set.restype = [ctypes.c_void_p], ctypes.c_int
        libs[record] = (lib, reports[record])
    return libs


def record_passes(call) -> list:
    """The K3 passes that ``call`` runs (``_sweep_kernel``'s arguments)."""
    passes = []
    real = cg._sweep_kernel

    def record(*args):
        passes.append(args)
        return real(*args)

    cg._sweep_kernel = record
    try:
        call()
    finally:
        cg._sweep_kernel = real
    return passes


def ray_sets(dev) -> tuple:
    """{name: recorded pass arguments} of multiroom's camera rays and of
    bounce 1 of a recorded frame, and the clusters' real faces."""
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings

    scene, cam = smoke.multiroom()
    pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE, compact_schedule="auto"), device=dev)
    pt.render(cam, frame_seed=0)  # the probes, and a warm-up frame
    frame = record_passes(lambda: smoke.eager_frame(pt, cam, 1))
    torch.cuda.synchronize()
    if len(frame) != 16:
        raise AssertionError(f"expected 16 K3 passes a frame, got {len(frame)}")
    ts = pt.scene
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    cam_passes = []

    def record(*args):
        cam_passes.append(args)
        return cg._sweep_kernel(*args)

    cg._gated(record, o, d, ts.tris, ts.clusters, smoke._light0(ts), None, 8, True)
    real = cg.real_faces(int(ts.tris.mtl.shape[0]), ts.clusters.count, dev)
    return {"camera rays, nearest": cam_passes[0], "camera rays, any-hit": cam_passes[1],
            "bounce 1, nearest": frame[2], "bounce 1, any-hit": frame[3]}, real


def pass_counts(args, real: torch.Tensor, out=None) -> dict:
    """What one recorded K3 pass needs and what a sweep in order meets, from
    the plain version's arithmetic (``cuda_intersect.mt_lin``) on the
    gated-in (tile, cluster) pairs; ``real`` (C,) the clusters' real faces;
    ``out`` the pass's result (nearest: ``(t, face)``; computed when None).

    Counts: ``sections`` (gated-in pairs), gated-in clusters a tile,
    ``live_lanes_per_tile`` at the start, ``tests`` (real-face tests for
    every ray of each gated-in tile: the ``n_tests`` counter),
    ``uv_tests`` (the tests whose t can change the result: nearest ``1e-5
    <= t <=`` the final t, any-hit ``1e-5 <= t < t_limit`` on a ray not yet
    occluded up to and including its first occluder), ``uv_running``
    (nearest: ``1e-5 <= t <`` the running best of a sweep in face order;
    any-hit: ``uv_tests``), and at each section's entry ``closed_lanes`` and
    ``closed_warps`` (lanes, and 32-lane groups with every lane, that can
    no longer change: nearest best <= 1e-5, i.e. dead; any-hit occluded or
    seeded 1)."""
    o, d, tab, verdict, tile, seed_t, _, t_limit = args[:8]
    any_hit = t_limit is not None
    if out is None:
        out = cg._sweep_plain(*args[:8])
    n_tiles, n_clusters = verdict.shape
    best = seed_t.clone()
    closed = best > 0.0 if any_hit else ~(best > EPS5)
    final = None if any_hit else out[0]
    c_all = ci.cross_od(o, d)
    lane = torch.arange(tile, device=o.x.device)
    j = torch.arange(cg.GATE_CLUSTER, device=o.x.device)
    per_tile = verdict.sum(dim=1)
    res = dict(tiles=n_tiles, sections=int(per_tile.sum()),
               clusters_per_tile_max=int(per_tile.max()) if n_tiles else 0,
               clusters_per_tile_mean=float(per_tile.double().mean()) if n_tiles else 0.0,
               live_lanes_per_tile=float((~closed).sum()) / max(n_tiles, 1),
               tests=int((verdict.to(torch.int64) * real).sum()) * tile,
               uv_tests=0, uv_running=0, closed_lanes=0, closed_warps=0,
               warps=int(per_tile.sum()) * tile // WARP)
    step = max(1, ci._PLAIN_ELEMS // (tile * cg.GATE_CLUSTER))
    for c in range(n_clusters):
        cols = tab[:, c * cg.GATE_CLUSTER:(c + 1) * cg.GATE_CLUSTER]
        is_real = j < real[c]
        tiles = torch.nonzero(verdict[:, c]).flatten()
        for k in range(0, tiles.shape[0], step):
            idx = (tiles[k:k + step, None] * tile + lane).reshape(-1)
            res["closed_lanes"] += int(closed[idx].sum())
            res["closed_warps"] += int(closed[idx].reshape(-1, WARP).all(dim=1).sum())
            col = lambda v: Vec3(v.x[idx, None], v.y[idx, None], v.z[idx, None])  # noqa: E731
            t, valid = ci.mt_lin(col(o), col(d), col(c_all), cols)
            ok = (t >= EPS5) & is_real
            if any_hit:
                lim = t_limit[idx, None]
                hit = valid & (t < lim)
                before = torch.cumsum(hit, dim=1, dtype=torch.int32) - hit.to(torch.int32)
                n = int((ok & (t < lim) & (before == 0) & ~closed[idx, None]).sum())
                res["uv_tests"] += n
                res["uv_running"] += n
                closed[idx] |= hit.any(dim=1)
                continue
            res["uv_tests"] += int((ok & (t <= final[idx, None])).sum())
            tt = torch.where(valid, t, torch.inf)
            prefix = torch.cummin(tt, dim=1).values
            shifted = torch.cat([torch.full_like(prefix[:, :1], torch.inf), prefix[:, :-1]],
                                dim=1)
            running = torch.minimum(best[idx, None], shifted)
            res["uv_running"] += int((ok & (t < running)).sum())
            best[idx] = torch.minimum(best[idx], prefix[:, -1])
    return res


def _run_with(lib, args, rec=None):
    """One ``_sweep_kernel`` call of the recorded ``args`` through the copy
    ``lib``; with ``rec``, the copy writes its block records there."""
    if rec is not None and lib.pbr_diag_set(rec.data_ptr()) != 0:
        raise RuntimeError("cudaMemcpyToSymbol of the record pointer failed")
    real = cg.load

    def copy_load(name, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    cg.load = copy_load
    try:
        out = cg._sweep_kernel(*args)
    finally:
        cg.load = real
    return out if isinstance(out, tuple) else (out,)


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _fmt(st: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in st.items())


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/k3_tiles.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_tiles: no CUDA device")
    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    for record, (_, report) in libs.items():
        print(f"ptxas{', with the record' if record else ''}:\n{report}", flush=True)
    (lib, report), diag = libs[False], libs[True][0]
    sets, real = ray_sets(dev)
    res = {"device": card, "ptxas": report, "sets": {}}
    for name, args in sets.items():
        ref = cg._sweep_plain(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        counts = pass_counts(args, real, ref)
        print(f"{name}: {_fmt(counts)}", flush=True)
        got = _run_with(lib, args)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        ms = _time_ms(lambda: _run_with(lib, args), 20)
        rec = torch.zeros((args[0].x.shape[0] // WARP + 64, 4), dtype=torch.int64, device=dev)
        _run_with(diag, args, rec)  # warm-up
        rec.zero_()
        out = _run_with(diag, args, rec)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(out, ref)):
            raise AssertionError(f"{name}: the copy with the record differs")
        r = rec.cpu().numpy()
        r = r[r[:, 0] > 0].copy()
        per_tile = args[3].sum(dim=1).cpu().numpy()
        r[:, 3] = per_tile[r[:, 3] // args[4]]  # first ray -> its tile's gated-in clusters
        st = res["sets"][name] = {"kernel_ms": ms, "counts": counts, "blocks": block_stats(r)}
        print(f"{name}: kernel {ms:.4f} ms; blocks {_fmt(st['blocks'])}", flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k3_tiles": {k: {"kernel_ms": v["kernel_ms"],
                                       "span_ms": v["blocks"]["span_ms"],
                                       "last_after_median_ms":
                                           v["blocks"]["last_after_median_ms"]}
                                   for k, v in res["sets"].items()}}), flush=True)


if __name__ == "__main__":
    main()
