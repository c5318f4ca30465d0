"""Where kernel K6's single-tree walks spend their time, on a card.

    python3 -m pbr_tpu_torch.tools.k6_walk [--out out/k6_walk.json]

Run it from the root of a checkout: it takes ``chip_smoke.py``'s
soup:10000 scene (bench.py --scene soup:10000: 10,000 faces, a BVH of
11,953 nodes with 2-face leaves), renders two 1024² frames through the
``pallas_bvh`` mode (the probes' lane order and compaction) and records the
8 K6 NEE walks of the second (``chip_smoke._recorded``). Its ray sets:
the path's 1,048,576 camera rays (frame 0, in the path's lane order)
walked by K6 NEE, bounce 1 of the recorded frame (K6 NEE), and sub-tree
0's walks of soup:100000's forest (13 sub-trees of 8,192 faces, 4-face
leaves; K6 nearest and K6 any-hit) on its camera rays and on bounce 1 of a
recorded ``pallas_bvh_forest`` frame.

``csrc/bvh_packet.cu`` is built into ``build/pbr_tpu_torch/diag/`` as it
is and with a record a warp (``patched_source``): its ``%globaltimer`` (ns)
at its start and end and, tallied by the lowest active lane of each step
of ``ray_walk``, its node steps and its leaf face tests with the lanes
active in them on each leg (the nearest walk, the shadow walk). Both are
built at once with the port's nvcc flags plus ``-Xptxas -v``, whose
registers and spills are printed; ``csrc/`` is not changed.

For each ray set the kernel is held bitwise to the plain version
(``cuda_bvh._run_plain``) and timed with CUDA events (10 launches), and
the copy with the record runs once (its outputs must equal the plain
version's, and its node lanes of each leg the plain walk's node steps);
the tool prints node steps a warp and their SIMD efficiency (lanes / (32 x
steps)), the shadow leg's share of the node lanes, leaf face tests a warp
and their SIMD efficiency, and the warps' span and tail (last end after
the median). On the NEE sets it also times the per-ray walk K8 on the
same rays: ``cuda_bvh`` Walk "K8" on the nearest leg, then "K8 any-hit" on
the shadow rays of the lanes that hit, in the nearest walk's order and in
their own ``ray_order`` (the sort timed apart), each held bitwise to K6's
outputs. The JSON record goes to ``--out``. The tool drives only
``cuda_bvh``'s ``Walk``, ``run``, ``_run_kernel``, ``_run_plain`` and
``load``, so that a copy of it times an earlier tree's K6 as well (without
the record where the hooks do not fit that tree's walk).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pbr_tpu_torch import PathTracer, camera_to_torch
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.tools.k3_tiles import _fmt, _time_ms, smi
from pbr_tpu_torch.tools.k4_tiles import _body, _nvcc

DIAG_DIR = ci.BUILD_DIR / "diag"
FILE = "bvh_packet.cu"
KERNEL = "packet_kernel"
WALK = "ray_walk"
WARP = 32
WORDS = 8  # a warp's record: start, end and the 6 counters of _COUNTERS
_COUNTERS = ("node_iterations", "node_lanes_nearest", "node_lanes_shadow", "leaf_iterations",
             "leaf_lanes_nearest", "leaf_lanes_shadow")
_HEAD = "#include <cuda_runtime.h>\n"
_DECL = ("__device__ unsigned long long* g_warp_rec;  // 8 words a warp: start, end, node "
         "iterations, their lanes on the nearest and on the shadow leg, leaf face iterations, "
         "their lanes on each leg\n__shared__ unsigned long long diag_n[256][6];\n")
_SETTER = """
extern "C" int pbr_diag_set(unsigned long long* rec) {
  return static_cast<int>(cudaMemcpyToSymbol(g_warp_rec, &rec, sizeof(rec)));
}
"""
_START = ('long long diag_t0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t0)); '
          "for (int q = 0; q < 6; ++q) diag_n[threadIdx.x][q] = 0; ")
_END = (" __syncwarp(); { unsigned long long* diag_q = g_warp_rec + 8 * "
        "((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5); "
        "for (int q = 0; q < 6; ++q) atomicAdd(diag_q + 2 + q, diag_n[threadIdx.x][q]); "
        "if ((threadIdx.x & 31) == 0) { long long diag_t1; "
        'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_t1)); '
        "diag_q[0] = diag_t0; diag_q[1] = diag_t1; } } ")
_NODE_ANCHOR = "float t_near;"
_LEAF_ANCHOR = "for (int k = 0; k < cnt; ++k) {"


def _tally(j: int) -> str:
    """The lowest active lane adds one iteration and the active lanes on
    each leg (``shadow``) to counters ``j`` .. ``j + 2``."""
    return ("{ const unsigned diag_m = __activemask(); "
            "const unsigned diag_s = __ballot_sync(diag_m, shadow); "
            "if ((threadIdx.x & 31) == __ffs(diag_m) - 1) { "
            f"diag_n[threadIdx.x][{j}] += 1; "
            f"diag_n[threadIdx.x][{j + 1}] += __popc(diag_m & ~diag_s); "
            f"diag_n[threadIdx.x][{j + 2}] += __popc(diag_s); }} }} ")


_NODE = _tally(0)
_LEAF = _tally(3)


def patched_source(src: str) -> str:
    """``src`` with the record a warp: ``packet_kernel`` reads the clock at
    its start and, after a ``__syncwarp``, at its end, where each lane adds
    its counters to its warp's record; in ``ray_walk`` the lowest active
    lane of each node step (``float t_near;``) and each leaf face test
    tallies the iteration and the active lanes of each leg. Raises where a
    hook is missing or the kernel returns early."""
    if _HEAD not in src:
        raise ValueError(f"{FILE}: no '#include <cuda_runtime.h>' line")
    lo, hi = _body(src, KERNEL, FILE)
    if re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", src[lo:hi])):
        raise ValueError(f"{FILE}: {KERNEL} returns early; the record is written at its end")
    lo, hi = _body(src, WALK, FILE)
    body = src[lo:hi]
    for anchor, hook, after in ((_NODE_ANCHOR, _NODE, False), (_LEAF_ANCHOR, _LEAF, True)):
        if body.count(anchor) != 1:
            raise ValueError(f"{FILE}: {WALK} has not one '{anchor}'")
        body = body.replace(anchor, anchor + " " + hook if after else hook + anchor)
    src = src[:lo] + body + src[hi:]
    src = src.replace(_HEAD, _HEAD + _DECL, 1)
    lo, hi = _body(src, KERNEL, FILE)
    return src[:lo] + _START + src[lo:hi] + _END + src[hi:] + _SETTER


def build() -> dict:
    """The source as it is and, where the hooks fit it, with the record,
    built at once: {record: (library, ptxas report)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    texts = {False: (ci.CSRC / FILE).read_text()}
    try:
        texts[True] = patched_source(texts[False])
    except ValueError as err:  # an earlier tree's walk: times only
        print(f"no record copy: {err}", flush=True)
    jobs = {}
    for record, text in texts.items():
        copy = DIAG_DIR / f"k6_walk{'_record' if record else ''}.cu"
        copy.write_text(text)
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


def ray_sets(dev) -> dict:
    """{name: walk}: soup:10000's camera rays (K6 NEE), bounce 1 of a
    recorded ``pallas_bvh`` frame (K6 NEE), and sub-tree 0's walks of
    soup:100000's forest (K6 nearest, K6 any-hit) on its camera rays and
    on bounce 1 of a recorded ``pallas_bvh_forest`` frame."""
    import chip_smoke as smoke  # the repo root's: its scenes, cameras and settings
    from pbr_tpu_torch.scene.build import scene_from_text
    from pbr_tpu_torch.scene.camera import make_camera_state
    from pbr_tpu_torch.scene.procedural import grey_soup
    from pbr_tpu_torch.accel.forest import build_forest

    smoke._build_native()
    scene, _ = scene_from_text(*grey_soup(10_000), use_bvh=True)
    cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE, compact_schedule="auto",
                                                intersector="pallas_bvh"), device=dev)
    pt.render(cam, frame_seed=0)  # the probes, and a warm-up frame
    frame = smoke._recorded(lambda: smoke.eager_frame(pt, cam, 1))
    torch.cuda.synchronize()
    if len(frame) != 8 or any(w.kernel != "K6 NEE" for w in frame):
        raise AssertionError(f"expected 8 K6 NEE walks a frame, got {[w.kernel for w in frame]}")
    ts = pt.scene
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    nee = cb.Walk("K6 NEE", o, d, ts.bvh, ci.face_table(ts.tris), pt.max_leaf, None,
                  cb.ray_order(o, d, ts.bvh), light=cb._light(smoke._light0(ts)))
    sets = {"soup:10000 camera rays, NEE": nee, "soup:10000 bounce 1, NEE": frame[1]}
    scene, cam = smoke.soup()
    scene = scene._replace(forest=build_forest(scene.tris))
    pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE, compact_schedule="auto",
                                                intersector="pallas_bvh_forest"), device=dev)
    pt.render(cam, frame_seed=0)  # the probes, and a warm-up frame
    frame = smoke._recorded(lambda: smoke.eager_frame(pt, cam, 1))
    ts = pt.scene
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    camera = smoke._recorded(lambda: cb.intersect_bvh_forest(o, d, ts.forest, ts.bvh,
                                                             light_pos=smoke._light0(ts)))
    torch.cuda.synchronize()
    bounce1 = frame[len(frame) // pt.settings.max_total_depth:][:4]
    for where, walks in (("camera rays", camera), ("bounce 1", bounce1)):
        for w in walks:
            if w.kernel in ("K6 nearest", "K6 any-hit"):
                sets[f"forest sub-tree 0 {where}, {w.kernel[3:]}"] = w
    return sets


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


def own_steps(w: cb.Walk, work: list) -> dict:
    """Per leg ("nearest", "shadow"), the plain walk's node steps summed
    over the rays: the lane-steps the warps must run."""
    legs = ("shadow",) if w.t_limit is not None else ("nearest", "shadow")
    return {leg: int(v.sum()) for leg, (_, v) in zip(legs, work)}


def warp_stats(rec: np.ndarray, own: dict) -> dict:
    """Span, tail and SIMD efficiency of one launch's warp records (rows of
    warps that never ran are all zero); ``own``, the plain walk's node
    steps of each leg, which the warps' node lanes must equal."""
    r = rec[rec[:, 0] > 0].astype(np.float64)
    e = r[:, 1] - r[:, 0].min()
    span, median = float(e.max()), float(np.median(e))
    c = dict(zip(_COUNTERS, r[:, 2:].sum(axis=0)))
    lanes = c["node_lanes_nearest"] + c["node_lanes_shadow"]
    if any(int(c["node_lanes_" + leg]) != v for leg, v in own.items()):
        raise AssertionError(f"the warps' node lanes {c} are not the plain walk's steps {own}")
    return {
        "warps": int(r.shape[0]), "span_ms": span / 1e6, "last_after_median_ms":
        (span - median) / 1e6, "mean_warp_ms": float((r[:, 1] - r[:, 0]).mean()) / 1e6,
        "node_iterations_per_warp": c["node_iterations"] / r.shape[0],
        "node_simd": lanes / max(WARP * c["node_iterations"], 1.0),
        "shadow_node_lane_share": c["node_lanes_shadow"] / max(lanes, 1.0),
        "leaf_iterations_per_warp": c["leaf_iterations"] / r.shape[0],
        "leaf_simd": (c["leaf_lanes_nearest"] + c["leaf_lanes_shadow"])
        / max(WARP * c["leaf_iterations"], 1.0),
    }


def k8_pair(w: cb.Walk, got: tuple) -> dict:
    """The per-ray walk K8 on ``w``'s rays: its nearest leg, then its
    any-hit leg on the shadow rays of the lanes that hit, in the nearest
    walk's order and in their own ``ray_order``; each held bitwise to K6's
    outputs ``got``, each timed."""
    near = cb.Walk("K8", w.o, w.d, w.tree, w.faces, w.max_leaf, w.alive, w.order)
    t, f = cb.run(near)
    if not (torch.equal(t, got[0]) and torch.equal(f, got[1])):
        raise AssertionError(f"K8 differs from {w.kernel} on the nearest leg")
    hit_p, s_dir, t_light = ci._shadow_ray(w.o, w.d, t, w.light)
    casts = t < float("inf") if w.alive is None else w.alive & (t < float("inf"))
    sort = lambda: cb.ray_order(hit_p, s_dir, w.tree, casts)  # noqa: E731
    shadow = cb.Walk("K8 any-hit", hit_p, s_dir, w.tree, w.faces, w.max_leaf, casts, w.order,
                     t_limit=t_light)
    resorted = shadow._replace(order=sort())
    for s in (shadow, resorted):
        if not torch.equal(cb.run(s), got[2]):
            raise AssertionError(f"K8 any-hit differs from {w.kernel}'s shadow leg")
    return {"k8_ms": _time_ms(lambda: cb.run(near), 10),
            "k8_any_hit_nearest_order_ms": _time_ms(lambda: cb.run(shadow), 10),
            "k8_any_hit_own_order_ms": _time_ms(lambda: cb.run(resorted), 10),
            "shadow_sort_ms": _time_ms(sort, 10)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/k6_walk.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_walk: no CUDA device")
    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    for record, (_, report) in libs.items():
        print(f"ptxas{', with the record' if record else ''}:\n{report}", flush=True)
    lib, report = libs[False]
    diag = libs[True][0] if True in libs else None
    sets = ray_sets(dev)
    res = {"device": card, "ptxas": report, "sets": {}}
    for name, w in sets.items():
        work = []
        ref = cb._run_plain(w, work)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = _run_with(lib, w)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        st = res["sets"][name] = {"kernel_ms": _time_ms(lambda: _run_with(lib, w), 10),
                                  "own_steps_per_ray": [int(v.sum()) / w.o.x.shape[0]
                                                        for _, v in work]}
        if diag is not None:
            rec = torch.zeros((w.o.x.shape[0] // WARP + 64, WORDS), dtype=torch.int64,
                              device=dev)
            _run_with(diag, w, rec)  # warm-up
            rec.zero_()
            got = _run_with(diag, w, rec)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                raise AssertionError(f"{name}: the copy with the record differs")
            st["warps"] = warp_stats(rec.cpu().numpy(), own_steps(w, work))
        if w.light is not None:
            st["k8"] = k8_pair(w, ref)
        print(f"{name}: kernel {st['kernel_ms']:.4f} ms; own node steps a ray, per leg, "
              f"{st['own_steps_per_ray']}", flush=True)
        for key in ("warps", "k8"):
            if key in st:
                print(f"{name}, {key}: {_fmt(st[key])}", flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k6_walk": {k: {"kernel_ms": v["kernel_ms"],
                                      **{key: v["warps"][key] for key in ("span_ms", "node_simd")
                                         if "warps" in v}}
                                  for k, v in res["sets"].items()}}), flush=True)


if __name__ == "__main__":
    main()
