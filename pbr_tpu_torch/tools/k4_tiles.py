"""Where kernel K4's (or K4m's) time goes across its blocks, on a card.

    python3 -m pbr_tpu_torch.tools.k4_tiles [--threads 1,2,4] [--out out/k4_tiles.json]
    python3 -m pbr_tpu_torch.tools.k4_tiles --masked [--out out/k4_tiles.json]

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

With ``--masked`` it measures K4m instead, on ``chip_smoke.py``'s multiroom
scene (32 clusters of 64): the 1024² camera rays through the cull wrapper
(nearest, then any-hit on the NEE shadow rays) and the two passes of bounce
1 of a recorded 1024² ``cull`` frame. For each pass it prints the plain
side's counts (``pass_counts``: gated-in clusters a tile, real-face tests,
those whose t can change the result, and the lanes and 32-ray warps that
can no longer change at each gated-in cluster; chip_smoke's K4 and K4m
bounds use them), holds ``csrc/cull_intersect.cu`` as it is bitwise to the
plain version, times it (20 launches) and prints the span and tail of a
copy with a record a block (``k3_tiles.clock_patch`` on ``masked_kernel``,
which must declare its ray index ``i``). It drives only ``cuda_cull``'s
``_masked_kernel``, ``_masked_plain`` and ``load``, so that a copy of the
tool measures an earlier tree's K4m as well.
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

from pbr_tpu_torch import PathTracer
from pbr_tpu_torch.ops import cuda_cull as cc
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.intersect import EPS5
from pbr_tpu_torch.scene import camera_to_torch, to_torch

DIAG_DIR = ci.BUILD_DIR / "diag"
WARP = 32
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


def pass_counts(kind: str, args) -> tuple:
    """A recorded K4 or K4m pass through the plain version, and what it
    needs: ``(out, counts, slots)``, with ``slots`` (T,) the slots (K4m:
    gated-in clusters) each tile executed.

    Counts, per (tile, cluster) pair the pass sweeps: ``tests``, the
    cluster's real faces (det's entries not all 0) for every ray of the
    tile; ``uv_tests``, those whose t can change the result (nearest ``1e-5
    <= t <=`` the ray's final t; any-hit ``1e-5 <= t < t_limit`` on a ray
    not yet occluded, up to and including its first occluder in the
    sweep's order, faces ascending within a cluster); ``sections`` (the
    pairs) and ``warps`` (32-ray groups of them); and at each pair's entry
    ``closed_lanes`` and ``closed_warps``, the lanes and the 32-ray groups
    with every lane that can no longer change (nearest: best < 1e-5, which
    holds a dead lane; any-hit: occluded or seeded 1, or t_limit <= 1e-5)."""
    table = args[1]
    real = (table[:, :, 0:3] != 0).any(dim=2)  # (C, S)
    s = table.shape[1]
    any_hit = args[-1]
    slots = torch.zeros(args[2].shape[0], dtype=torch.int64, device=table.device)
    res = dict.fromkeys(("tests", "uv_tests", "sections", "warps", "closed_lanes",
                         "closed_warps"), 0)
    swept = []  # nearest: (tiles, cids) of each sweep, for the u-v count against the final t
    step = max(1, cc._PLAIN_ELEMS // (cc.TILE * s))
    sweep = cc._SweepState.sweep

    def counted(self, table_, tiles, cids):
        res["tests"] += int(real[cids].sum()) * cc.TILE
        res["sections"] += tiles.numel()
        res["warps"] += tiles.numel() * cc.TILE // WARP
        slots[tiles] += 1
        best = self.best[tiles]
        if any_hit:
            closed = (best > 0.0) | ~(self.feats[10, tiles] > EPS5)
        else:
            closed = ~(best >= EPS5)
        res["closed_lanes"] += int(closed.sum())
        res["closed_warps"] += int(closed.reshape(-1, WARP).all(dim=1).sum())
        if not any_hit:
            swept.append((tiles, cids))
            return sweep(self, table_, tiles, cids)
        for k in range(0, tiles.shape[0], step):
            tl, cl = tiles[k:k + step], cids[k:k + step]
            t, valid = cc._face_test(table_[cl], self.feats[:, tl])
            lim = self.feats[10, tl][:, :, None]
            hit = valid & (t < lim)
            before = torch.cumsum(hit, dim=2, dtype=torch.int32) - hit.to(torch.int32)
            ok = (t >= EPS5) & (t < lim) & (before == 0) & real[cl][:, None, :]
            res["uv_tests"] += int((ok & (self.best[tl] == 0.0)[:, :, None]).sum())
        return sweep(self, table_, tiles, cids)

    cc._SweepState.sweep = counted
    try:
        out = (cc._slotted_plain if kind == "K4" else cc._masked_plain)(*args)
    finally:
        cc._SweepState.sweep = sweep
    if not any_hit:
        final = out[0].reshape(-1, cc.TILE)
        feats = torch.stack(list(args[0])).reshape(cc.FEATURE_ROWS, -1, cc.TILE)
        for tiles, cids in swept:
            for k in range(0, tiles.shape[0], step):
                tl, cl = tiles[k:k + step], cids[k:k + step]
                t, _ = cc._face_test(table[cl], feats[:, tl])
                ok = (t >= EPS5) & (t <= final[tl][:, :, None]) & real[cl][:, None, :]
                res["uv_tests"] += int(ok.sum())
    return out, res, slots


def _run_with(lib, args, rec=None, masked: bool = False):
    """One K4 (``masked``: K4m) launch of a recorded pass through the copy
    ``lib``; with ``rec``, the copy writes its block records there."""
    if rec is not None and lib.pbr_diag_set(ctypes.c_void_p(rec.data_ptr())) != 0:
        raise RuntimeError("cudaMemcpyToSymbol of the record pointer failed")
    real = cc.load

    def copy_load(name, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    cc.load = copy_load
    try:
        out = (cc._masked_kernel if masked else cc._slotted_kernel)(*args)
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


def masked_sets(dev) -> dict:
    """{name: recorded K4m pass arguments}: multiroom's 1024² camera rays
    (frame 0, the path's lane order) through the cull wrapper, and bounce 1
    of a recorded 1024² ``cull`` frame."""
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings

    scene, cam = smoke.multiroom()
    pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE, compact_schedule="auto",
                                                intersector="cull"), device=dev)
    pt.render(cam, frame_seed=0)  # the probes, and a warm-up frame
    frame = []
    real = cc._masked_kernel

    def record(*args):
        frame.append(args)
        return real(*args)

    cc._masked_kernel = record
    try:
        smoke.eager_frame(pt, cam, 1)  # eager: a graph's replay calls no wrapper
    finally:
        cc._masked_kernel = real
    torch.cuda.synchronize()
    if len(frame) != 16:
        raise AssertionError(f"expected 16 K4m passes a frame, got {len(frame)}")
    ts = pt.scene
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    passes, _ = smoke._cull_passes(o, d, ts.clusters, smoke._light0(ts), None)
    return {"camera rays, nearest": passes[0][1], "camera rays, any-hit": passes[1][1],
            "bounce 1, nearest": frame[2], "bounce 1, any-hit": frame[3]}


def build_masked() -> dict:
    """``cull_intersect.cu`` as it is and with a record a block of
    ``masked_kernel`` (``k3_tiles.clock_patch``: start and end
    ``%globaltimer``, SM, the block's first ray ``i``), built at once:
    {record: (library, ptxas report)}."""
    from pbr_tpu_torch.tools.k3_tiles import clock_patch

    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / "cull_intersect.cu").read_text()
    jobs = {}
    for record in (False, True):
        copy = DIAG_DIR / f"k4m{'_record' if record else ''}.cu"
        copy.write_text(clock_patch(src, "cull_intersect.cu", "masked_kernel", "i")
                        if record else src)
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


def masked_main(out: str, smi: str, dev) -> None:
    """K4m's passes on multiroom (``--masked``): the plain side's counts,
    then the kernel held bitwise to the plain version, timed (20 launches)
    and its copy's block records read."""
    from pbr_tpu_torch.tools.k3_tiles import _fmt, _time_ms

    libs = build_masked()
    for record, (_, report) in libs.items():
        print(f"ptxas{', with the record' if record else ''}:\n{report}", flush=True)
    (lib, report), diag = libs[False], libs[True][0]
    sets = masked_sets(dev)
    res = {"device": smi, "ptxas": report, "sets": {}}
    for name, args in sets.items():
        ref, counts, slots = pass_counts("K4m", args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        counts.update(clusters_per_tile_max=int(slots.max()),
                      clusters_per_tile_mean=float(slots.double().mean()))
        print(f"{name}: {_fmt(counts)}", flush=True)
        got = _run_with(lib, args, masked=True)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        ms = _time_ms(lambda: _run_with(lib, args, masked=True), 20)
        rec = torch.zeros((args[0][0].shape[0] // WARP + 64, 4), dtype=torch.int64, device=dev)
        _run_with(diag, args, rec, masked=True)  # warm-up
        rec.zero_()
        got = _run_with(diag, args, rec, masked=True)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{name}: the copy with the record differs")
        r = rec.cpu().numpy()
        r = r[r[:, 0] > 0].copy()
        r[:, 3] = slots.cpu().numpy()[r[:, 3] // cc.TILE]  # first ray -> its tile's clusters
        st = res["sets"][name] = {"kernel_ms": ms, "counts": counts, "blocks": block_stats(r)}
        print(f"{name}: kernel {ms:.4f} ms; blocks {_fmt(st['blocks'])}", flush=True)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k4_tiles": {k: {"kernel_ms": v["kernel_ms"],
                                       "span_ms": v["blocks"]["span_ms"],
                                       "last_after_median_ms":
                                           v["blocks"]["last_after_median_ms"]}
                                   for k, v in res["sets"].items()}}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="1,2,4", help="threads a ray to build K4 at")
    ap.add_argument("--masked", action="store_true",
                    help="measure K4m on multiroom's passes instead of K4")
    ap.add_argument("--out", default="out/k4_tiles.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_tiles: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    if a.masked:
        masked_main(a.out, smi, dev)
        return
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
