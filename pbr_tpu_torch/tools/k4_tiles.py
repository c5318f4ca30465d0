"""Where kernel K4's time goes across its blocks, on a card.

    python3 -m pbr_tpu_torch.tools.k4_tiles [--threads 1,2,4] [--out out/k4_tiles.json]

Run it from the root of a checkout: it takes ``chip_smoke.py``'s
soup:100000 scene (bench.py --scene soup:100000: 100,000 faces, 784
clusters of 128) and its 1,048,576 camera rays at 1024² (scanline order,
frame 0), records the two passes of the cull wrapper (nearest, then any-hit
on the NEE shadow rays to light 0), and replays each pass through copies of
``csrc/cull_intersect.cu`` built into ``build/pbr_tpu_torch/diag/``
(``csrc/`` is not changed). For each threads-a-ray count K of ``--threads``
(the source's ``kThreadsPerRay``, 2, is the kernel as built; the others
exist only in the copies):

- a copy with ``kThreadsPerRay`` = K, held bitwise to the plain version,
  then timed with CUDA events (10 launches);
- the same copy whose ``slotted_kernel`` also writes one record a block:
  the ``%globaltimer`` (ns) at its start and at its end, its ``%smid`` and
  the slots it executed. Its outputs must equal the first copy's bitwise.

All copies are built at once with the port's nvcc flags plus ``-Xptxas
-v``, and the registers, shared memory and spills of every kernel are
printed. Per pass and K it prints the blocks' span, the median and the last
block end, the most blocks resident at once, what a perfect balance of the
same block durations over that many places would take, the executed slots
per block (max, mean, the top 1% of blocks' share of all), and two list
schedules of the measured durations on that many places: in launch order,
and heaviest (most executed slots) first. The JSON record goes to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import heapq
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pbr_tpu_torch.ops import cuda_cull as cc
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.scene import camera_to_torch, to_torch

DIAG_DIR = ci.BUILD_DIR / "diag"
_THREADS = re.compile(r"constexpr int kThreadsPerRay = (\d+);")
_HEAD = "#include <cuda_runtime.h>\n"
_DECL = "__device__ long long* g_block_rec;  // 4 words a block: start, end, SM, slots\n"
_SETTER = """
extern "C" int pbr_diag_set(long long* rec) {
  return static_cast<int>(cudaMemcpyToSymbol(g_block_rec, &rec, sizeof(rec)));
}
"""
_START = 'long long diag_t0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t0)); '
_END = (' if (threadIdx.x == 0) { long long diag_t1; unsigned diag_sm; '
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t1)); '
        'asm volatile("mov.u32 %0, %%smid;" : "=r"(diag_sm)); '
        "long long* p = g_block_rec + 4 * static_cast<long long>(blockIdx.x); "
        "p[0] = diag_t0; p[1] = diag_t1; p[2] = diag_sm; } ")
_COUNT = "++diag_slots; "
_COUNT_END = (" if (threadIdx.x == 0) "
              "g_block_rec[4 * static_cast<long long>(blockIdx.x) + 3] = diag_slots; ")


def built_threads(src: str) -> int:
    """The threads a ray of K4 as ``src`` builds it."""
    m = _THREADS.search(src)
    if m is None:
        raise ValueError("cull_intersect.cu: no 'constexpr int kThreadsPerRay = ...;'")
    return int(m.group(1))


def _body(src: str, name: str, file: str = "cull_intersect.cu") -> tuple:
    """(start, end) of the body of function ``name``'s definition in
    ``src`` (the text of ``file``): just after its opening brace, and at
    its closing brace."""
    m = re.search(name + r"\([^)]*\)\s*\{", src)
    if m is None:
        raise ValueError(f"{file}: no definition of {name}")
    depth = 0
    for i in range(m.end() - 1, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return m.end(), i
    raise ValueError(f"{file}: {name} does not end")


def patched_source(src: str, threads: int, record: bool) -> str:
    """``src`` with K4 at ``threads`` threads a ray and, with ``record``,
    the per-block record: ``slotted_kernel`` writes its start and end times
    and its SM; ``sweep_list`` counts the slots it sweeps and writes the
    count (only slotted_kernel is launched here)."""
    built_threads(src)
    src = _THREADS.sub(f"constexpr int kThreadsPerRay = {threads};", src, count=1)
    if not record:
        return src
    if _HEAD not in src:
        raise ValueError("cull_intersect.cu: no '#include <cuda_runtime.h>' line")
    src = src.replace(_HEAD, _HEAD + _DECL, 1)
    lo, hi = _body(src, "slotted_kernel")
    src = src[:lo] + _START + src[lo:hi] + _END + src[hi:]
    lo, hi = _body(src, "sweep_list")
    body = src[lo:hi]
    call = re.search(r"sweep_cluster<S, ANY_HIT, K>\(", body)
    if call is None:
        raise ValueError("cull_intersect.cu: sweep_list's sweep_cluster call not found")
    body = " int diag_slots = 0;" + body[:call.start()] + _COUNT + body[call.start():] + _COUNT_END
    return src[:lo] + body + src[hi:] + _SETTER


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


def build(threads) -> dict:
    """Every copy, built at once: {(K, record): (library, ptxas report)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / "cull_intersect.cu").read_text()
    jobs = {}
    for k in threads:
        for record in (False, True):
            stem = f"cull_intersect_k{k}" + ("_diag" if record else "")
            copy = DIAG_DIR / f"{stem}.cu"
            copy.write_text(patched_source(src, k, record))
            jobs[k, record] = (copy, DIAG_DIR / f"{stem}.so")
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        reports = dict(zip(jobs, pool.map(lambda j: _nvcc(*j), jobs.values())))
    return {key: (ctypes.CDLL(str(so)), reports[key]) for key, (_, so) in jobs.items()}


def camera_passes(dev) -> list:
    """soup:100000's 1024² camera rays through the cull wrapper with K4;
    returns each pass's recorded kernel arguments."""
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings

    smoke._build_native()
    scene, cam = smoke.soup()
    ts = to_torch(scene, dev)
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), smoke.bench_settings(smoke.SIZE), dev)
    passes, _ = smoke._cull_passes(o, d, ts.clusters, smoke._light0(ts), None)
    torch.cuda.synchronize()
    return [args for _, args in passes]


def _run_with(lib, args, rec=None):
    """One K4 launch of a recorded pass through the copy ``lib``; with
    ``rec``, the copy writes its block records there."""
    if rec is not None and lib.pbr_diag_set(ctypes.c_void_p(rec.data_ptr())) != 0:
        raise RuntimeError("cudaMemcpyToSymbol of the record pointer failed")
    real = cc.load

    def copy_load(name, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    cc.load = copy_load
    try:
        out = cc._slotted_kernel(*args)
    finally:
        cc.load = real
    return out if isinstance(out, tuple) else (out,)


def _list_schedule(dur: np.ndarray, places: int) -> float:
    """Makespan of running ``dur`` in the given order, each on the first
    place that comes free."""
    free = [0.0] * places
    for x in dur:
        heapq.heapreplace(free, free[0] + float(x))
    return max(free)


def block_stats(rec: np.ndarray) -> dict:
    """Span, tail and balance of one launch's block records (ns)."""
    t0, t1, sm, slots = (rec[:, i].astype(np.float64) for i in range(4))
    s, e = t0 - t0.min(), t1 - t0.min()
    dur = e - s
    span = float(e.max())
    times = np.concatenate([s, e])
    delta = np.concatenate([np.ones_like(s), -np.ones_like(e)])
    order = np.lexsort((delta, times))  # at a tie an end comes before a start
    resident = int(np.cumsum(delta[order]).max())
    top = np.sort(slots)[::-1]
    k = max(1, int(np.ceil(0.01 * top.size)))
    heavy = np.argsort(-slots, kind="stable")
    return {
        "blocks": int(rec.shape[0]), "sms": int(np.unique(sm).size),
        "span_ms": span / 1e6, "median_end_ms": float(np.median(e)) / 1e6,
        "last_after_median_ms": (span - float(np.median(e))) / 1e6,
        "max_resident": resident, "block_ms_sum": float(dur.sum()) / 1e6,
        "balanced_ms": float(dur.sum()) / resident / 1e6,
        "longest_block_ms": float(dur.max()) / 1e6,
        "longest_block_slots": int(slots[np.argmax(dur)]),
        "slots_max": int(top[0]), "slots_mean": float(slots.mean()),
        "slots_top1pct_share": float(top[:k].sum() / max(top.sum(), 1.0)),
        "schedule_launch_order_ms": _list_schedule(dur, resident) / 1e6,
        "schedule_heaviest_first_ms": _list_schedule(dur[heavy], resident) / 1e6,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="1,2,4", help="threads a ray to build K4 at")
    ap.add_argument("--out", default="out/k4_tiles.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_tiles: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    threads = [int(k) for k in a.threads.split(",")]
    libs = build(threads)
    for (k, record), (_, report) in libs.items():
        print(f"ptxas, K = {k}{', with the record' if record else ''}:\n{report}", flush=True)
    passes = camera_passes(dev)
    res = {"device": smi, "ptxas": {f"K={k}, record {r}": v[1] for (k, r), v in libs.items()},
           "passes": {}}
    for args in passes:
        name = "K4 any-hit" if args[-1] else "K4"
        plain = cc._slotted_plain(*args)
        plain = plain if isinstance(plain, tuple) else (plain,)
        for k in threads:
            lib, diag = libs[k, False][0], libs[k, True][0]
            ref = _run_with(lib, args)
            if not all(torch.equal(x, y) for x, y in zip(ref, plain)):
                raise AssertionError(f"{name}, {k} threads a ray: the kernel differs from its "
                                     f"plain version")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                _run_with(lib, args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 10
            rec = torch.zeros((args[2].shape[0], 4), dtype=torch.int64, device=dev)
            _run_with(diag, args, rec)  # warm-up
            out = _run_with(diag, args, rec)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                raise AssertionError(f"{name}: the copy with the record differs from the kernel")
            st = {"kernel_ms": ms, **block_stats(rec.cpu().numpy())}
            res["passes"][f"{name}, K={k}"] = st
            print(f"{name}, {k} thread(s) a ray, equal to the plain version bitwise: "
                  + ", ".join(f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
                              for key, v in st.items()), flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k4_tiles": {k: {"kernel_ms": v["kernel_ms"], "span_ms": v["span_ms"],
                                        "last_after_median_ms": v["last_after_median_ms"]}
                                    for k, v in res["passes"].items()}}), flush=True)


if __name__ == "__main__":
    main()
