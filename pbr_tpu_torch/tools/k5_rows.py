"""Where the row sweep's time goes across its blocks, on a card: kernel K5
(slotted) and kernel K5m (masked).

    python3 -m pbr_tpu_torch.tools.k5_rows [--out out/k5_rows.json]

Run it from the root of a checkout: it takes ``chip_smoke.py``'s
soup:100000 scene (bench.py --scene soup:100000: 100,000 faces, 784 lin
clusters of 128, so K5) and its multiroom scene (bench.py --scene
multiroom: 1,428 faces, 16 lin clusters, so K5m), each with its 1,048,576
camera rays at 1024² (scanline order, frame 0), records the two passes of
the row sweep's wrapper (nearest, then any-hit on the NEE shadow rays to
light 0), and replays each pass through copies of ``csrc/row_sweep.cu``
built into ``build/pbr_tpu_torch/diag/`` (``csrc/`` is not changed):

- the source as it is, held bitwise to the plain version, then timed with
  CUDA events (10 launches);
- the source whose ``slotted_rows_kernel`` and ``masked_rows_kernel`` also
  write one record a block: the ``%globaltimer`` (ns) at its start and at
  its end, its ``%smid``, the lin cluster tables it staged, the (row, lin
  cluster) pairs it executed, and, in SM clocks, the time its thread 0
  spent staging tables (its copy of a table and the barrier after it)
  against the block's whole time. Its outputs must equal the first copy's
  bitwise, and its executed pairs and staged tables the plain version's.

Both are built at once with the port's nvcc flags plus ``-Xptxas -v``, and
the registers, shared memory and spills of every kernel are printed. Per
pass it prints the blocks' span, the median and the last block end, the
most blocks resident at once and what a perfect balance of their durations
over that many places would take, the active rows per staged table (of 8),
and the staging share of a block's time. The JSON record goes to
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

from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops import cuda_sweep as cs
from pbr_tpu_torch.scene import camera_to_torch, to_torch
from pbr_tpu_torch.tools.k4_tiles import _body, _nvcc, block_stats

DIAG_DIR = ci.BUILD_DIR / "diag"
WORDS = 8  # a block's record: start, end, SM, staged, pairs, wait clocks, block clocks, tile
_HEAD = "#include <cuda_runtime.h>\n"
_DECL = ("__device__ long long* g_block_rec;  // 8 words a block: start, end, SM, staged "
         "slots, executed pairs, wait clocks, block clocks, tile\n")
_SETTER = """
extern "C" int pbr_diag_set(long long* rec) {
  return static_cast<int>(cudaMemcpyToSymbol(g_block_rec, &rec, sizeof(rec)));
}
"""
_START = ('long long diag_t0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t0)); '
          "const long long diag_c0 = clock64(); __shared__ int diag_pairs; "
          "if (threadIdx.x == 0) diag_pairs = 0; long long diag_wait = 0; int diag_staged = 0; ")
_END = (" __syncthreads(); if (threadIdx.x == 0) { long long diag_t1; unsigned diag_sm; "
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t1)); '
        'asm volatile("mov.u32 %0, %%smid;" : "=r"(diag_sm)); '
        f"long long* p = g_block_rec + {WORDS} * static_cast<long long>(blockIdx.x); "
        "p[0] = diag_t0; p[1] = diag_t1; p[2] = diag_sm; p[3] = diag_staged; "
        "p[4] = diag_pairs; p[5] = diag_wait; p[6] = clock64() - diag_c0; p[7] = tile; } ")
KERNELS = ("slotted_rows_kernel", "masked_rows_kernel")
# The hooks of each kernel: the copy of a lin cluster's table up to the
# barrier after which the block sweeps it (timed and counted by thread 0),
# and the table's active rows, which thread 0 adds to the executed pairs.
_WAIT = (r"stage\(lin4, cid, buf\);\s*__syncthreads\(\);",
         "const long long diag_s = clock64(); ",
         " diag_wait += clock64() - diag_s; ++diag_staged;")
_PAIR = (r"const unsigned act = [^;]*;", "",
         " if (threadIdx.x == 0) diag_pairs += __popc(act);")


def _wrap(body: str, hook: tuple, kernel: str) -> str:
    """``body`` (of ``kernel``) with the one match of ``hook``'s pattern
    between its text before and after."""
    pattern, before, after = hook
    found = list(re.finditer(pattern, body))
    if len(found) != 1:
        raise ValueError(f"row_sweep.cu: {kernel} has {len(found)} matches of "
                         f"{pattern!r}, not 1")
    m = found[0]
    return body[:m.start()] + before + m.group(0) + after + body[m.end():]


def patched_source(src: str) -> str:
    """``src`` with the per-block record in both kernels (``KERNELS``);
    each declares the ``tile`` it sweeps."""
    if _HEAD not in src:
        raise ValueError("row_sweep.cu: no '#include <cuda_runtime.h>' line")
    src = src.replace(_HEAD, _HEAD + _DECL, 1)
    for kernel in KERNELS:
        lo, hi = _body(src, kernel, "row_sweep.cu")
        body = src[lo:hi]
        if re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", body)):
            raise ValueError(f"row_sweep.cu: {kernel} returns early; the record is written at "
                             f"its end")
        for hook in (_WAIT, _PAIR):
            body = _wrap(body, hook, kernel)
        src = src[:lo] + _START + body + _END + src[hi:]
    return src + _SETTER


def build() -> dict:
    """The source's two copies, built at once: {record: (library, ptxas
    report)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / "row_sweep.cu").read_text()
    jobs = {}
    for record in (False, True):
        copy = DIAG_DIR / ("row_sweep" + ("_diag" if record else "") + ".cu")
        copy.write_text(patched_source(src) if record else src)
        jobs[record] = (copy, copy.with_suffix(".so"))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        reports = dict(zip(jobs, pool.map(lambda j: _nvcc(*j), jobs.values())))
    return {record: (ctypes.CDLL(str(so)), reports[record]) for record, (_, so) in jobs.items()}


def camera_passes(dev) -> list:
    """soup:100000's and multiroom's 1024² camera rays through the sweep
    wrapper (K5 and K5m); returns each pass's kernel and recorded
    arguments."""
    import chip_smoke as smoke  # the repo root's: its scenes, camera and settings

    smoke._build_native()
    passes = []
    for make in (smoke.soup, smoke.multiroom):
        scene, cam = make()
        ts = to_torch(scene, dev)
        o, d = smoke._camera_rays(camera_to_torch(cam, dev), smoke.bench_settings(smoke.SIZE),
                                  dev)
        passes += smoke._sweep_passes(o, d, ts.clusters, smoke._light0(ts), None)[0]
    torch.cuda.synchronize()
    return passes


def run_with(lib, kind, args, rec=None, order=None):
    """One launch of a recorded ``kind`` ("K5" or "K5m") pass through the
    copy ``lib`` (K5's tiles in ``order``, default heaviest first); with
    ``rec``, the copy writes its block records there."""
    if rec is not None and lib.pbr_diag_set(ctypes.c_void_p(rec.data_ptr())) != 0:
        raise RuntimeError("cudaMemcpyToSymbol of the record pointer failed")
    real = cs.load

    def copy_load(name, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    cs.load = copy_load
    try:
        out = (cs._slotted_kernel(*args, order=order) if kind == "K5"
               else cs._masked_kernel(*args))
    finally:
        cs.load = real
    return out if isinstance(out, tuple) else (out,)


def row_stats(rec: np.ndarray) -> dict:
    """``k4_tiles.block_stats`` of one launch's block records, with the
    executed pairs as its slots, plus the staged slots, the active rows per
    staged slot and the staging share of the blocks' time."""
    st = block_stats(rec[:, [0, 1, 2, 4]])
    staged, pairs = int(rec[:, 3].sum()), int(rec[:, 4].sum())
    st = {k.replace("slots", "pairs"): v for k, v in st.items()}
    st.update({"staged": staged, "pairs": pairs,
               "rows_per_staged_slot": pairs / max(staged, 1),
               "staging_share": float(rec[:, 5].sum() / max(rec[:, 6].sum(), 1))})
    return st


def _plain_work(kind, args) -> tuple:
    """The plain version's outputs, executed (row, lin cluster) pairs and
    staged (tile, lin cluster) tables on a recorded ``kind`` pass."""
    work = []
    out = (cs._slotted_plain if kind == "K5" else cs._masked_plain)(*args, work=work)
    pairs = sum(int(r.numel()) for r, _ in work)
    staged = sum(int(torch.unique(r // cs.GROUPS).numel()) for r, _ in work)
    return (out if isinstance(out, tuple) else (out,)), pairs, staged


def time_ms(fn, iters: int = 10) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def record_pass(libs: dict, kind, args, plain=None) -> dict:
    """One recorded ``kind`` pass through the two copies (``libs``:
    {record: (library, report)}): the kernel held bitwise to the plain
    version (computed here unless given as ``_plain_work``'s tuple), timed;
    the record's outputs held to the kernel's, its pairs and staged tables
    to the plain version's; returns the kernel time and the block
    statistics."""
    name = kind + (" any-hit" if args[2] is not None else "")
    ref, pairs, staged = plain or _plain_work(kind, args)
    n_tiles = args[0].x.shape[0] // cs.TILE
    order = cs.row_order(args[4], args[5]) if kind == "K5" else None
    run = lambda lib, rec=None: run_with(lib, kind, args, rec, order)  # noqa: E731
    out = run(libs[False][0])
    if not all(torch.equal(x, y) for x, y in zip(out, ref)):
        raise AssertionError(f"{name}: the kernel differs from its plain version")
    ms = time_ms(lambda: run(libs[False][0]))
    rec = torch.zeros((n_tiles, WORDS), dtype=torch.int64, device=args[0].x.device)
    run(libs[True][0], rec)  # warm-up
    got = run(libs[True][0], rec)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, out)):
        raise AssertionError(f"{name}: the copy with the record differs from the kernel")
    st = {"kernel_ms": ms, **row_stats(rec.cpu().numpy())}
    if (st["pairs"], st["staged"]) != (pairs, staged):
        raise AssertionError(f"{name}: the kernel executed {st['pairs']} pairs and staged "
                             f"{st['staged']} slots, the plain version {pairs} and {staged}")
    return st


def _registers(report: str, kernel: str) -> str:
    """``kernel``'s registers, nearest / any-hit, from a ptxas report."""
    regs = re.findall(kernel + r"ILb([01]).*Used (\d+) registers", report)
    return " / ".join(r for _, r in sorted(regs))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/k5_rows.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k5_rows: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    for record, (_, report) in libs.items():
        print(f"ptxas{', with the record' if record else ''}:\n{report}", flush=True)
    res = {"device": smi, "ptxas": libs[False][1], "passes": {}}
    for kind, args in camera_passes(dev):
        name = kind + (" any-hit" if args[2] is not None else "")
        st = record_pass(libs, kind, args)
        st["registers"] = _registers(libs[False][1], KERNELS[kind == "K5m"])
        res["passes"][name] = st
        print(f"{name}, equal to the plain version bitwise: "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in st.items()), flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k5_rows": {k: {key: v[key] for key in (
        "kernel_ms", "span_ms", "last_after_median_ms", "rows_per_staged_slot",
        "staging_share", "registers")} for k, v in res["passes"].items()}}), flush=True)


if __name__ == "__main__":
    main()
