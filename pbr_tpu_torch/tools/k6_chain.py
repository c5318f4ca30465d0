"""Where the forest's seeded chain (kernel K6's instances "K6 seeded" and
"K6 seeded any-hit") spends its time, and what it walks, on a card.

    python3 -m pbr_tpu_torch.tools.k6_chain [--out out/k6_chain.json]

Run it from the root of a checkout: it takes ``chip_smoke.py``'s
soup:100000 scene with its forest (``accel.forest.build_forest``: 13
sub-trees of 8,192 faces) and the 1,048,576 camera rays of a
``pallas_bvh_forest`` frame 0 (the probes' lane order), runs the forest
walk with NEE (``cuda_bvh.intersect_bvh_forest``) and records its walks
(``chip_smoke._recorded``): sub-tree 0's ("K6 nearest", "K6 any-hit") and
the seeded chain's over sub-trees 1-12, whatever number of launches the
chain takes.

For each pass (nearest; any-hit, on the shadow rays of the combined hit)
it holds every chain walk bitwise to the plain version
(``cuda_bvh._run_plain``), then times the chain two ways: CUDA events
around its launches (10 runs), and the device time of its kernels in one
run by ``torch.profiler``. From the plain version (``chain_counts``) it
prints node steps and face tests a ray over sub-trees 1-12 and, for the
any-hit pass, the 32-ray warps of the launch order that enter each
sub-tree with every lane occluded or not walking.

``csrc/bvh_packet.cu`` is built into ``build/pbr_tpu_torch/diag/`` as it
is and, where it has a ``chain_kernel``, with a record a block: its
``%globaltimer`` (ns) at its start and end and its SM
(``k3_tiles.clock_patch``), which gives the chain's span and tail; both
with ``-Xptxas -v``, whose registers are printed. The tool drives
only ``cuda_bvh.intersect_bvh_forest``, ``_run_kernel``, ``_run_plain``,
``walk_plain`` and ``load``, so that a copy of it measures an earlier
tree's chain as well.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pbr_tpu_torch import PathTracer, camera_to_torch
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.tools.k3_tiles import _fmt, _time_ms, clock_patch, smi
from pbr_tpu_torch.tools.k4_tiles import _nvcc, block_stats

DIAG_DIR = ci.BUILD_DIR / "diag"
FILE = "bvh_packet.cu"
CHAIN = "chain_kernel"
WARP = 32


def build() -> dict:
    """The source as it is and, with a chain kernel, its copy with the
    record, built at once: {record: (library, ptxas report)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / FILE).read_text()
    jobs = {False: src}
    if re.search(CHAIN + r"\(", src):
        jobs[True] = clock_patch(src, FILE, CHAIN, "blockIdx.x")
    paths = {}
    for record, text in jobs.items():
        copy = DIAG_DIR / f"k6{'_record' if record else ''}.cu"
        copy.write_text(text)
        paths[record] = (copy, copy.with_suffix(".so"))
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        reports = dict(zip(paths, pool.map(lambda j: _nvcc(*j), paths.values())))
    libs = {}
    for record, (_, so) in paths.items():
        lib = ctypes.CDLL(str(so))
        if record:
            lib.pbr_diag_set.argtypes, lib.pbr_diag_set.restype = [ctypes.c_void_p], ctypes.c_int
        libs[record] = (lib, reports[record])
    return libs


def walks(dev) -> tuple:
    """The recorded walks of the forest's NEE walk on a ``pallas_bvh_forest``
    frame's camera rays, and the forest."""
    import chip_smoke as smoke  # the repo root's: its scene, camera and settings
    from pbr_tpu_torch.accel.forest import build_forest

    smoke._build_native()
    scene, cam = smoke.soup()
    scene = scene._replace(forest=build_forest(scene.tris))
    pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE, compact_schedule="auto",
                                                intersector="pallas_bvh_forest"), device=dev)
    pt.render(cam, frame_seed=0)  # the probes
    ts = pt.scene
    o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    rec = smoke._recorded(lambda: cb.intersect_bvh_forest(o, d, ts.forest, ts.bvh,
                                                          light_pos=smoke._light0(ts)))
    torch.cuda.synchronize()
    return rec, ts.forest


def chain_counts(forest, o, d, alive, order, max_leaf: int, t_limit=None) -> dict:
    """The plain chain over sub-trees 1..K-1 after sub-tree 0 (nearest, or
    any-hit against ``t_limit``): node steps and face tests a ray over
    sub-trees 1..K-1, and for any-hit, the 32-ray warps of the launch order
    ``order`` (identity when None) that enter each sub-tree with every lane
    occluded or not walking (dead, or past the last ray)."""
    n = o.x.shape[0]
    chunk = forest.chunk
    seq = torch.arange(n, device=o.x.device) if order is None else order.long()
    pad = (-n) % WARP
    t = f = occ = None
    steps = tests = 0
    entering = []
    for i in range(forest.count):
        if t_limit is not None and i:
            done = occ if alive is None else occ | ~alive
            done = torch.cat([done[seq], done.new_ones(pad)]).reshape(-1, WARP)
            entering.append(int(done.all(dim=1).sum()))
        t, f, occ, ts, vs = cb.walk_plain(o, d, forest.tree(i),
                                          forest.faces[:, i * chunk:(i + 1) * chunk], max_leaf,
                                          alive, i * chunk, t_seed=t, f_seed=f, t_limit=t_limit,
                                          occ_seed=occ)
        if i:
            steps += int(vs.sum())
            tests += int(ts.sum())
    res = {"rays": n, "subtrees": forest.count - 1, "node_steps_per_ray": steps / n,
           "face_tests_per_ray": tests / n, "warps": (n + pad) // WARP}
    if t_limit is not None:
        res["warps_entering_occluded"] = entering
    return res


def _run_with(lib, w):
    real = cb.load

    def copy_load(name, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    cb.load = copy_load
    try:
        return cb._run_kernel(w)
    finally:
        cb.load = real


def device_ms(fn, tries: int = 3) -> tuple:
    """Device time of the kernels ``fn`` launches, and their number, from
    one run under ``torch.profiler`` (run again, up to ``tries`` times,
    where the trace shows none of them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.device_time_total > 0
                and ("packet_kernel" in e.key or CHAIN in e.key)]
        if rows:
            break
    return sum(e.device_time_total for e in rows) / 1e3, sum(e.count for e in rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/k6_chain.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_chain: no CUDA device")
    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    for record, (_, report) in libs.items():
        print(f"ptxas{', with the record' if record else ''}:\n{report}", flush=True)
    lib = libs[False][0]
    rec_walks, forest = walks(dev)
    res = {"device": card, "ptxas": libs[False][1], "passes": {}}
    for kind, first in (("K6 seeded", "K6 nearest"), ("K6 seeded any-hit", "K6 any-hit")):
        chain = [w for w in rec_walks if w.kernel == kind]
        w0 = next(w for w in rec_walks if w.kernel == first)
        for w in chain:
            got, ref = _run_with(lib, w), cb._run_plain(w)
            got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                raise AssertionError(f"{kind}: the kernel differs from its plain version")
        run = lambda: [_run_with(lib, w) for w in chain]  # noqa: E731
        dev_ms, kernels = device_ms(run)
        st = res["passes"][kind] = {
            "launches": len(chain), "event_ms": _time_ms(run, 10), "device_ms": dev_ms,
            "kernels": kernels, "first_subtree_ms": _time_ms(lambda: _run_with(lib, w0), 10),
            **chain_counts(forest, w0.o, w0.d, w0.alive, w0.order, w0.max_leaf, w0.t_limit)}
        if True in libs and len(chain) == 1:
            diag = libs[True][0]
            rec = torch.zeros((w0.o.x.shape[0] // WARP + 64, 4), dtype=torch.int64, device=dev)
            if diag.pbr_diag_set(rec.data_ptr()) != 0:
                raise RuntimeError("cudaMemcpyToSymbol of the record pointer failed")
            out = _run_with(diag, chain[0])
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(
                    out if isinstance(out, tuple) else (out,), ref)):
                raise AssertionError(f"{kind}: the copy with the record differs")
            r = rec.cpu().numpy()
            st["blocks"] = block_stats(r[r[:, 0] > 0])
        print(f"{kind}: {_fmt({k: v for k, v in st.items() if not isinstance(v, (list, dict))})}",
              flush=True)
        if "warps_entering_occluded" in st:
            print(f"{kind}: warps entering sub-trees 1-{forest.count - 1} with every lane "
                  f"occluded or not walking, of {st['warps']}: {st['warps_entering_occluded']}",
                  flush=True)
        if "blocks" in st:
            print(f"{kind}: blocks {_fmt(st['blocks'])}", flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k6_chain": {k: {key: v[key] for key in (
        "launches", "event_ms", "device_ms", "node_steps_per_ray", "face_tests_per_ray")}
        for k, v in res["passes"].items()}}), flush=True)


if __name__ == "__main__":
    main()
