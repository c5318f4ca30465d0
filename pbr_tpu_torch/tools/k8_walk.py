"""Where kernel K8's time goes across its warps and lanes, on a card.

    python3 -m pbr_tpu_torch.tools.k8_walk [--out out/k8_walk.json]

Run it from the root of a checkout: it takes ``chip_smoke.py``'s
soup:100000 scene (bench.py --scene soup:100000: 100,000 faces, a BVH of
4,523 nodes with 64-face leaves) and renders two 1024² frames through the
``bvh`` mode (the probes' lane order and compaction), recording the 16
walks of the second (``chip_smoke._recorded``): the nearest walk and the
NEE shadow walk of each of the 8 bounces. The shadow walks are K8's any-hit
instance on the lanes that cast a shadow ray; their *old form* is the
nearest walk on every lane of the bounce, whose ``t < t_light`` is the same
bit (checked here on every casting lane). It also takes the path's
1,048,576 camera rays (frame 0, in the path's lane order).

It builds two copies of ``csrc/bvh_walk.cu`` into
``build/pbr_tpu_torch/diag/`` (``csrc/`` is not changed): the source as it
is, and the source with a record a warp: its ``%globaltimer`` (ns) at its
start and at its end, and, separately for the node steps and the leaf face
tests, the loop iterations the warp ran and the lanes active in them
(``__popc(__activemask())``), so that lanes / (32 x iterations) is the
SIMD efficiency. Both are built at once with the port's nvcc flags plus
``-Xptxas -v``, and every kernel's registers, shared memory and spills are
printed.

For each ray set (the camera rays, nearest; the shadow rays of bounces 0
and 1, any-hit and in the old form) the first copy is held bitwise to the
plain version (``cuda_bvh._run_plain``), timed with CUDA events (10
launches), and the second run once, whose outputs must equal the first's.
It prints the kernel time, the warps' span, the median and last warp end,
the tail (last end after the median), the longest warp, and the node and
leaf SIMD efficiencies. It also times every walk of the recorded frame (3
launches each): the frame's nearest walks, its shadow walks and the old
form of its shadow walks, summed. The JSON record goes to ``--out``.
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

DIAG_DIR = ci.BUILD_DIR / "diag"
_HEAD = "#include <cuda_runtime.h>\n"
_DECL = ("__device__ unsigned long long* g_warp_rec;  // 6 words a warp: start, end, "
         "node iterations, node lanes, leaf iterations, leaf lanes\n")
_SETTER = """
extern "C" int pbr_diag_set(unsigned long long* rec) {
  return static_cast<int>(cudaMemcpyToSymbol(g_warp_rec, &rec, sizeof(rec)));
}
"""
_START = ('long long diag_t0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t0)); '
          "unsigned long long diag_n[4] = {0, 0, 0, 0}; ")
_NODE_ANCHOR = "++visits;"
_LEAF_ANCHOR = "for (int k = 0; k < cnt; ++k) {"


def _tally(j: int) -> str:
    """The lowest active lane adds one iteration and the active lanes to
    counters ``j`` and ``j + 1``."""
    return ("{ const unsigned diag_m = __activemask(); "
            f"if ((threadIdx.x & 31) == __ffs(diag_m) - 1) {{ diag_n[{j}] += 1; "
            f"diag_n[{j + 1}] += __popc(diag_m); }} }} ")


_NODE = _tally(0)
_LEAF = _tally(2)
_END = (" __syncwarp(); { unsigned long long* diag_q = g_warp_rec + 6 * "
        "((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5); "
        "atomicAdd(diag_q + 2, diag_n[0]); atomicAdd(diag_q + 3, diag_n[1]); "
        "atomicAdd(diag_q + 4, diag_n[2]); atomicAdd(diag_q + 5, diag_n[3]); "
        "if ((threadIdx.x & 31) == 0) { long long diag_t1; "
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t1)); '
        "diag_q[0] = diag_t0; diag_q[1] = diag_t1; } } ")


def _body(src: str, name: str) -> tuple:
    """(start, end) of the body of function ``name``'s definition: just
    after its opening brace, and at its closing brace."""
    m = re.search(name + r"\([^)]*\)\s*\{", src)
    if m is None:
        raise ValueError(f"bvh_walk.cu: no definition of {name}")
    depth = 0
    for i in range(m.end() - 1, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return m.end(), i
    raise ValueError(f"bvh_walk.cu: {name} does not end")


def patched_source(src: str) -> str:
    """``src`` with the record a warp: ``walk_kernel`` reads the clock at
    its start and, after a ``__syncwarp``, at its end, and tallies each
    node step (at ``++visits;``) and each face test of its leaf loop."""
    if _HEAD not in src:
        raise ValueError("bvh_walk.cu: no '#include <cuda_runtime.h>' line")
    src = src.replace(_HEAD, _HEAD + _DECL, 1)
    lo, hi = _body(src, "walk_kernel")
    body = src[lo:hi]
    for anchor, hook, after in ((_NODE_ANCHOR, _NODE, False), (_LEAF_ANCHOR, _LEAF, True)):
        if body.count(anchor) != 1:
            raise ValueError(f"bvh_walk.cu: walk_kernel has not one '{anchor}'")
        body = body.replace(anchor, anchor + " " + hook if after else hook + anchor)
    return src[:lo] + _START + body + _END + src[hi:] + _SETTER


def _nvcc(src: Path, out: Path) -> str:
    """Build ``src`` into ``out`` with the port's flags and ``-Xptxas -v``;
    returns ptxas's report on its kernels."""
    proc = subprocess.run([ci._nvcc(), *ci.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(ci.CSRC),
                           "-o", str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    lines, kernel = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("Used" in line or "spill" in line):
            lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return "\n".join(lines)


def build() -> dict:
    """Both copies, built at once: {record: (library, ptxas report)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / "bvh_walk.cu").read_text()
    jobs = {}
    for record in (False, True):
        copy = DIAG_DIR / ("bvh_walk_diag.cu" if record else "bvh_walk.cu")
        copy.write_text(patched_source(src) if record else src)
        jobs[record] = (copy, copy.with_suffix(".so"))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        reports = dict(zip(jobs, pool.map(lambda j: _nvcc(*j), jobs.values())))
    libs = {}
    for record, (_, so) in jobs.items():
        lib = libs[record] = ctypes.CDLL(str(so))
        if record:
            lib.pbr_diag_set.argtypes, lib.pbr_diag_set.restype = [ctypes.c_void_p], ctypes.c_int
    return {record: (lib, reports[record]) for record, lib in libs.items()}


def old_form(w: cb.Walk) -> cb.Walk:
    """The shadow walk ``w`` as the nearest walk on every lane of its
    bounce, in that launch's order (the form before K8's any-hit
    instance)."""
    return w._replace(kernel="K8", alive=None, t_limit=None, with_counts=False,
                      order=cb.ray_order(w.o, w.d, w.tree))


def ray_sets(dev) -> tuple:
    """The recorded walks of one soup:100000 ``bvh`` frame, and the K8 walk
    of the path's camera rays."""
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings

    smoke._build_native()
    scene, cam = smoke.soup()
    pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE, compact_schedule="auto",
                                                intersector="bvh"), device=dev)
    pt.render(cam, frame_seed=0)  # the probes, and a warm-up frame
    frame = smoke._recorded(lambda: smoke.eager_frame(pt, cam, 1))
    torch.cuda.synchronize()
    ts = pt.scene
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    camera = cb.Walk("K8", o, d, ts.bvh, ci.face_table(ts.tris), pt.max_leaf, None,
                     cb.ray_order(o, d, ts.bvh))
    return frame, camera


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
    """Span, tail and SIMD efficiency of one launch's warp records (ns;
    rows of warps that never ran are all zero)."""
    rec = rec[rec[:, 0] > 0].astype(np.float64)
    t0, t1 = rec[:, 0], rec[:, 1]
    s, e = t0 - t0.min(), t1 - t0.min()
    span, median = float(e.max()), float(np.median(e))
    times = np.concatenate([s, e])
    delta = np.concatenate([np.ones_like(s), -np.ones_like(e)])
    order = np.lexsort((delta, times))  # at a tie an end comes before a start
    node_it, node_ln, leaf_it, leaf_ln = (rec[:, i].sum() for i in range(2, 6))
    return {
        "warps": int(rec.shape[0]), "resident_warps": int(np.cumsum(delta[order]).max()),
        "span_ms": span / 1e6, "median_end_ms": median / 1e6,
        "last_after_median_ms": (span - median) / 1e6,
        "mean_warp_ms": float((e - s).mean()) / 1e6, "longest_warp_ms": float((e - s).max()) / 1e6,
        "node_iterations_per_warp": node_it / rec.shape[0],
        "leaf_iterations_per_warp": leaf_it / rec.shape[0],
        "node_simd": node_ln / max(32.0 * node_it, 1.0),
        "leaf_simd": leaf_ln / max(32.0 * leaf_it, 1.0),
    }


def _fmt(st: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in st.items())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/k8_walk.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k8_walk: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    for record, (_, report) in libs.items():
        print(f"ptxas{', with the record' if record else ', as built'}:\n{report}", flush=True)
    frame, camera = ray_sets(dev)
    near = [w for w in frame if w.kernel == "K8"]
    shadow = [w for w in frame if w.kernel == "K8 any-hit"]
    if len(near) != 8 or len(shadow) != 8:
        raise AssertionError(f"expected 8 + 8 walks a frame, got {len(near)} + {len(shadow)}")
    sets = {"camera rays, nearest": camera}
    for b in (0, 1):
        sets[f"bounce {b} shadow rays, any-hit"] = shadow[b]
        sets[f"bounce {b} shadow rays, old form"] = old_form(shadow[b])
    plain = {name: cb._run_plain(w) for name, w in sets.items()}
    for b in (0, 1):
        occ = plain[f"bounce {b} shadow rays, any-hit"]
        t_old = plain[f"bounce {b} shadow rays, old form"][0]
        casts = shadow[b].alive
        if not torch.equal(occ[casts], (t_old < shadow[b].t_limit)[casts]) or occ[~casts].any():
            raise AssertionError(f"bounce {b}: the any-hit bit differs from the old form's")
        print(f"bounce {b}: {shadow[b].o.x.shape[0]} lanes, {int(casts.sum())} cast a shadow "
              f"ray, {int(occ.sum())} occluded; the any-hit bit equals the old form's "
              f"t < t_light on every casting lane", flush=True)
    res = {"device": smi, "ptxas": {f"record {r}": v[1] for r, v in libs.items()},
           "sets": {}, "frame": {}}
    lib, diag = libs[False][0], libs[True][0]
    for name, w in sets.items():
        ref = plain[name] if isinstance(plain[name], tuple) else (plain[name],)
        got = _run_with(lib, w)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        ms = _time_ms(lambda: _run_with(lib, w), 10)
        rec = torch.zeros((w.o.x.shape[0] // 32 + 64, 6), dtype=torch.int64, device=dev)
        _run_with(diag, w, rec)  # warm-up
        rec.zero_()
        out = _run_with(diag, w, rec)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(out, got)):
            raise AssertionError(f"{name}: the copy with the record differs from the kernel")
        st = res["sets"][name] = {"kernel_ms": ms, **warp_stats(rec.cpu().numpy())}
        print(f"{name}, equal to the plain version bitwise: {_fmt(st)}", flush=True)
    res["frame"] = {part: sum(_time_ms(lambda: _run_with(lib, w), 3) for w in ws)
                    for part, ws in (("nearest walks", near), ("shadow walks", shadow),
                                     ("old form of the shadow walks",
                                      [old_form(w) for w in shadow]))}
    print(f"one bvh frame, ms summed over 8 walks each: {_fmt(res['frame'])}", flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k8_walk": {k: {"kernel_ms": v["kernel_ms"], "span_ms": v["span_ms"],
                                      "last_after_median_ms": v["last_after_median_ms"]}
                                  for k, v in res["sets"].items()}}), flush=True)


if __name__ == "__main__":
    main()
