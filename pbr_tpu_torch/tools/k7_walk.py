"""Where kernel K7's time goes across its warps and lanes, on a card.

    python3 -m pbr_tpu_torch.tools.k7_walk [--out out/k7_walk.json]

Run it from the root of a checkout: it takes ``chip_smoke.py``'s
soup:100000 scene (bench.py --scene soup:100000: 100,000 faces, a BVH of
4,523 nodes with 64-face leaves) and renders two 1024² frames through the
``pallas_bvh_hbm`` mode (the probes' lane order and compaction), recording
the 8 K7 NEE walks of the second (``chip_smoke._recorded``). It also takes
the path's 1,048,576 camera rays (frame 0, in the path's lane order),
walked by K7 NEE and by K7 nearest.

``csrc/bvh_packet.cu`` is built twice into ``build/pbr_tpu_torch/diag/``:
as it is, and with a record a warp (K7's block is one warp): its ``%globaltimer``
(ns) at its start and at its end, its node steps, its leaf visits (steps
at a leaf that some lane hits), the lanes that hit the leaf summed over
those visits (leaf SIMD = lanes / (32 x visits)), the SM clocks spent
staging leaf faces, the clocks of the nearest leg and of the shadow leg,
the lanes that walked a shadow ray and those of them whose nearest walk
had missed. Both copies are built at once with the port's nvcc flags plus
``-Xptxas -v``, and every kernel's registers, shared memory and spills
are printed; ``csrc/`` is not changed.

For each ray set (the camera rays, NEE and nearest; the frame's bounce-1
walk, NEE) it prints the plain version's bounds (``chip_smoke._walk_bound``:
the walks the contract needs, and for NEE also with the shadow ray walked
on every live lane, as the former contract did). The first copy is held
bitwise to the plain version (``cuda_bvh._run_plain``) on every output,
then timed with CUDA events (10 launches), and the copy with the record
run once, whose outputs must equal the first's. It
prints the kernel time, the warps' span, median and last end, the tail
(last end after the median), node steps and leaf visits a warp, the leaf
SIMD efficiency, the staging and shadow-leg shares of a warp's clocks and
the missed lanes that walked a shadow ray. It also times the recorded
frame's 8 walks (3 launches each), summed. The JSON record goes to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pbr_tpu_torch import PathTracer, camera_to_torch
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.tools.k4_tiles import _body, _nvcc

DIAG_DIR = ci.BUILD_DIR / "diag"
FILE = "bvh_packet.cu"
KERNEL = "slab_kernel"
WORDS = 10  # a warp's record: start, end and the 8 counters of _COUNTERS
_COUNTERS = ("node_steps", "leaf_visits", "hitting_lanes", "staging_clocks", "nearest_clocks",
             "shadow_clocks", "shadow_lanes", "missed_shadow_lanes")
_HEAD = "#include <cuda_runtime.h>\n"
_DECL = ("__device__ long long* g_warp_rec;  // 10 words a warp: start, end, node steps, leaf "
         "visits, hitting lanes, staging clocks, nearest clocks, shadow clocks, shadow lanes, "
         "missed shadow lanes\n__shared__ long long diag_n[8];\n")
_SETTER = """
extern "C" int pbr_diag_set(long long* rec) {
  return static_cast<int>(cudaMemcpyToSymbol(g_warp_rec, &rec, sizeof(rec)));
}
"""
_LANE0 = "if ((threadIdx.x & 31) == 0) "
_N = "diag_n"
_START = ('long long diag_t0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t0)); '
          f"{_LANE0}for (int q = 0; q < 8; ++q) {_N}[q] = 0; __syncwarp(); ")
_END = (f" __syncwarp(); {_LANE0}{{ long long diag_t1; "
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t1)); '
        f"long long* diag_q = g_warp_rec + {WORDS} * static_cast<long long>(blockIdx.x); "
        f"diag_q[0] = diag_t0; diag_q[1] = diag_t1; "
        f"for (int q = 0; q < 8; ++q) diag_q[2 + q] = {_N}[q]; }} ")
# The hooks: (function, pattern, text before the match, text after it).
# In slab_walk: the node step (every iteration of its loop declares
# t_near), the leaf visit (the lanes' hit bits where the warp stands at a
# leaf some lane hits), the staging of a leaf's faces (from the barrier
# before the copy to the one after it). In slab_kernel: its two legs, the
# shadow leg with the lanes it walks (its third argument).
_HOOKS = (
    ("slab_walk", r"float t_near;", f"{_LANE0}++{_N}[0]; ", ""),
    ("slab_walk", r"if \(lf >= 0\) \{", "",
     f" {{ const unsigned diag_m = __ballot_sync(0xffffffffu, hit); {_LANE0}{{ ++{_N}[1]; "
     f"{_N}[2] += __popc(diag_m); }} }}"),
    ("slab_walk",
     r"__syncwarp\(\);  // every lane is done with the previous slab.*?__syncwarp\(\);",
     "const long long diag_s = clock64(); ", f" {_LANE0}{_N}[3] += clock64() - diag_s;"),
    (KERNEL, r"slab_walk<false>\([^;]*\);", "{ const long long diag_s = clock64(); ",
     f" {_LANE0}{_N}[4] += clock64() - diag_s; }}"),
    (KERNEL, r"slab_walk<true>\(p, s, (\w+),[^;]*\);",
     "{ const unsigned diag_w = __ballot_sync(0xffffffffu, \\1), diag_x = __ballot_sync("
     "0xffffffffu, \\1 && !(t_best < INFINITY)); "
     f"{_LANE0}{{ {_N}[6] += __popc(diag_w); {_N}[7] += __popc(diag_x); }} "
     "const long long diag_s = clock64(); ",
     f" {_LANE0}{_N}[5] += clock64() - diag_s; }}"),
)


def _hook(src: str, func: str, pattern: str, before: str, after: str) -> str:
    """``src`` with the one match of ``pattern`` in the body of ``func``
    between ``before`` and ``after`` (both may name the match's groups)."""
    lo, hi = _body(src, func, FILE)
    found = list(re.finditer(pattern, src[lo:hi], re.S))
    if len(found) != 1:
        raise ValueError(f"{FILE}: {func} has {len(found)} matches of {pattern!r}, not 1")
    m = found[0]
    a, b = lo + m.start(), lo + m.end()
    return src[:a] + m.expand(before) + m.group(0) + m.expand(after) + src[b:]


def patched_source(src: str) -> str:
    """``src`` with the record a warp: ``slab_kernel`` reads the clock at
    its start and, after a ``__syncwarp``, at its end, and the hooks count
    node steps, leaf visits and hitting lanes, and time the staging and the
    two legs. Raises where a hook is missing or the kernel returns early."""
    if _HEAD not in src:
        raise ValueError(f"{FILE}: no '#include <cuda_runtime.h>' line")
    lo, hi = _body(src, KERNEL, FILE)
    if re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", src[lo:hi])):
        raise ValueError(f"{FILE}: {KERNEL} returns early; the record is written at its end")
    for hook in _HOOKS:
        src = _hook(src, *hook)
    src = src.replace(_HEAD, _HEAD + _DECL, 1)
    lo, hi = _body(src, KERNEL, FILE)
    return src[:lo] + _START + src[lo:hi] + _END + src[hi:] + _SETTER


def build() -> dict:
    """The source's two copies, built at once: {record: (library, ptxas
    report)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / FILE).read_text()
    jobs = {}
    for record in (False, True):
        copy = DIAG_DIR / f"k7{'_diag' if record else ''}.cu"
        copy.write_text(patched_source(src) if record else src)
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


def ray_sets(dev) -> tuple:
    """The 8 recorded K7 NEE walks of one soup:100000 ``pallas_bvh_hbm``
    frame, and {name: walk} of the sets measured one by one."""
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings

    smoke._build_native()
    scene, cam = smoke.soup()
    pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE, compact_schedule="auto",
                                                intersector="pallas_bvh_hbm"), device=dev)
    pt.render(cam, frame_seed=0)  # the probes, and a warm-up frame
    frame = smoke._recorded(lambda: smoke.eager_frame(pt, cam, 1))
    torch.cuda.synchronize()
    if len(frame) != 8 or any(w.kernel != "K7 NEE" for w in frame):
        raise AssertionError(f"expected 8 K7 NEE walks a frame, got {[w.kernel for w in frame]}")
    ts = pt.scene
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    near = cb.Walk("K7 nearest", o, d, ts.bvh, ci.face_table(ts.tris), pt.max_leaf, None,
                   cb.ray_order(o, d, ts.bvh))
    nee = near._replace(kernel="K7 NEE", light=cb._light(smoke._light0(ts)))
    return frame, {"camera rays, NEE": nee, "camera rays, nearest": near,
                   "bounce 1, NEE": frame[1]}


def _run_with(lib, w: cb.Walk, rec=None) -> tuple:
    """One launch of ``w`` through the copy ``lib``; with ``rec``, the copy
    writes its warp records there."""
    if rec is not None and lib.pbr_diag_set(rec.data_ptr()) != 0:
        raise RuntimeError("cudaMemcpyToSymbol of the record pointer failed")
    real = cb.load

    def copy_load(name, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    cb.load = copy_load
    try:
        out = cb._run_kernel(w)
    finally:
        cb.load = real
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


def warp_stats(rec: np.ndarray) -> dict:
    """Span, tail, leaf SIMD efficiency and clock shares of one launch's
    warp records (rows of warps that never ran are all zero)."""
    rec = rec[rec[:, 0] > 0].astype(np.float64)
    t0, t1 = rec[:, 0], rec[:, 1]
    e, dur = t1 - t0.min(), t1 - t0
    span, median = float(e.max()), float(np.median(e))
    n = dict(zip(_COUNTERS, rec[:, 2:].sum(axis=0)))
    clocks = max(n["nearest_clocks"] + n["shadow_clocks"], 1.0)
    return {
        "warps": int(rec.shape[0]), "span_ms": span / 1e6, "median_end_ms": median / 1e6,
        "last_after_median_ms": (span - median) / 1e6, "mean_warp_ms": float(dur.mean()) / 1e6,
        "longest_warp_ms": float(dur.max()) / 1e6,
        "node_steps_per_warp": n["node_steps"] / rec.shape[0],
        "leaf_visits_per_warp": n["leaf_visits"] / rec.shape[0],
        "hitting_lanes_per_visit": n["hitting_lanes"] / max(n["leaf_visits"], 1.0),
        "leaf_simd": n["hitting_lanes"] / max(32.0 * n["leaf_visits"], 1.0),
        "staging_share": n["staging_clocks"] / clocks,
        "shadow_share": n["shadow_clocks"] / clocks,
        "shadow_lanes": int(n["shadow_lanes"]),
        "missed_shadow_lanes": int(n["missed_shadow_lanes"]),
    }


def _fmt(st: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in st.items())


def _registers(report: str) -> str:
    """The K7 kernel's registers, nearest / NEE, from a ptxas report."""
    regs = dict(re.findall(KERNEL + r"ILi([01])E.*Used (\d+) registers", report))
    return " / ".join(regs.get(mode, "?") for mode in "01")


def plain_and_bounds(w: cb.Walk) -> tuple:
    """The plain version's outputs on ``w``, and its bounds
    (``chip_smoke._walk_bound``) in ms: of the walks the contract needs
    and, for a NEE walk, also with the shadow ray walked on every live lane
    that missed, as the former contract did."""
    import chip_smoke as smoke

    work, uv = [], []
    out = cb._run_plain(w, work, uv)
    bounds = {"bound_ms": smoke._walk_bound(w, work, uv)[0][0]}
    if w.light is not None:
        hit_p, s_dir, t_light = ci._shadow_ray(w.o, w.d, out[0], w.light)
        missed = out[0] == float("inf")
        missed = missed if w.alive is None else missed & w.alive
        cands = []
        work.append(cb.walk_plain(hit_p, s_dir, w.tree, w.faces, w.max_leaf, missed,
                                  t_limit=t_light, uv=cands)[3:])
        uv.append(cb.uv_counts(cands, w.o.x.shape[0], w.o.x.device))
        bounds["bound_ms_every_live_lane"] = smoke._walk_bound(w, work, uv)[0][0]
    return out, bounds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/k7_walk.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k7_walk: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    for record, (_, report) in libs.items():
        print(f"ptxas{', with the record' if record else ''}:\n{report}", flush=True)
    (lib, report), diag = libs[False], libs[True][0]
    frame, sets = ray_sets(dev)
    res = {"device": smi, "registers": _registers(report), "ptxas": report, "bounds": {},
           "sets": {}}
    for name, w in sets.items():
        ref, res["bounds"][name] = plain_and_bounds(w)
        print(f"{name}: {_fmt(res['bounds'][name])}", flush=True)
        got = _run_with(lib, w)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        ms = _time_ms(lambda: _run_with(lib, w), 10)
        rec = torch.zeros((w.o.x.shape[0] // 32 + 64, WORDS), dtype=torch.int64, device=dev)
        _run_with(diag, w, rec)  # warm-up
        rec.zero_()
        out = _run_with(diag, w, rec)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(out, got)):
            raise AssertionError(f"{name}: the copy with the record differs")
        st = res["sets"][name] = {"kernel_ms": ms, **warp_stats(rec.cpu().numpy())}
        print(f"{name}: {_fmt(st)}", flush=True)
    res["frame_ms"] = sum(_time_ms(lambda: _run_with(lib, w), 3) for w in frame)
    print(f"registers {res['registers']}; one pallas_bvh_hbm frame's 8 K7 NEE walks "
          f"{res['frame_ms']:.4f} ms", flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k7_walk": {"registers": res["registers"], "frame_ms": res["frame_ms"],
                                  **{k: {key: v[key] for key in (
                                      "kernel_ms", "span_ms", "last_after_median_ms",
                                      "leaf_simd")} for k, v in res["sets"].items()}}}),
          flush=True)


if __name__ == "__main__":
    main()
