"""What kernels K1 and K2 (the brute sweep, ``csrc/brute_intersect.cu``)
need and do, on a card.

    python3 -m pbr_tpu_torch.tools.k1_sweep [--out out/k1_sweep.json]

Run it from the root of a checkout. Its ray sets: Cornell's 1,048,576
camera rays (``chip_smoke.py``'s scene and camera, frame 0 in the path's
lane order), bounce 1 of a recorded 1024² Cornell frame (the second of its
8 K1 calls), multiroom's camera rays (bench.py --scene multiroom: 1,428
faces) and 1,048,576 rays in the box against a 4,000-face soup, each with
light 0 of its scene (the soup: Cornell's). Each goes through all four
instances: K1 (NEE), K1' (nearest), K2 and K2' (the linear form).

For each set and form it prints the plain side's counts (``sweep_counts``,
torch ops; chip_smoke's K1 and K2 bounds use them), the bounds they give
(chip_smoke's ``_full_sweep_bounds``: t for every test, u and v where t
can change the result) and the plain version's time (one call).

``csrc/brute_intersect.cu`` is built into ``build/pbr_tpu_torch/diag/`` as
it is and with a record a block (its ``%globaltimer`` at its start and its
end, its SM; before every ``return`` of the kernel too), both at once with
the port's nvcc flags plus ``-Xptxas -v`` (registers, shared memory,
spills). ``cuobjdump -sass`` of each library gives every kernel's
instructions and its loops (a backward branch and its target):
instructions, shared loads, float32 arithmetic and MUFU a loop. Both are
held bitwise to the plain version on every set and instance; the first is
timed with CUDA events, 20 wrapper calls in a row and the same 20 calls
replayed from a CUDA graph (the device's time without the host's launch
gaps); the copy with the record runs once a set and instance and prints
the blocks' span and tail (``k4_tiles.block_stats``). The JSON record goes
to ``--out``.

The tool drives only ``cuda_intersect.intersect_fused``,
``intersect_fused_plain``, ``face_table``, ``lin_table`` and ``load``, so
that a copy of it measures an earlier tree's K1 and K2 as well.
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
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.intersect import EPS5, moller_trumbore
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene import to_torch
from pbr_tpu_torch.tools.k3_tiles import _DECL, _END, _HEAD, _SETTER, _START, _time_ms, smi
from pbr_tpu_torch.tools.k4_tiles import _body, _nvcc, block_stats

DIAG_DIR = ci.BUILD_DIR / "diag"
FILE = "brute_intersect.cu"
KERNEL = "brute_intersect_kernel"
WARP = 32
ITERS = 20
# (ray, face) pairs a chunk of ``sweep_counts``: some GiB of temporaries on
# an 80 GB card, so a million rays against 100,000 faces take 800 chunks.
SWEEP_ELEMS = 1 << 27
INSTANCES = (("K1", "mt", True), ("K1'", "mt", False), ("K2", "lin", True),
             ("K2'", "lin", False))


def record_patch(src: str) -> str:
    """``src`` with a record a block: ``brute_intersect_kernel`` reads
    ``%globaltimer`` at its start and, after a ``__syncthreads``, at its end
    and before each ``return``; its thread 0 writes (start, end, SM, block)
    to row ``blockIdx.x`` of the array that ``pbr_diag_set`` names. Raises
    where the kernel or the include is missing."""
    if _HEAD not in src:
        raise ValueError(f"{FILE}: no '#include <cuda_runtime.h>' line")
    lo, hi = _body(src, KERNEL, FILE)
    end = _END.replace("@TAG@", "blockIdx.x")
    body = re.sub(r"\breturn\s*;", "{" + end + "return; }", src[lo:hi])
    src = src[:lo] + _START + body + end + src[hi:] + _SETTER
    return src.replace(_HEAD, _HEAD + _DECL, 1)


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b[^;]*?0x([0-9a-f]+)")


def sass_loops(sass: str) -> dict:
    """Per kernel of ``cuobjdump -sass`` output: its instruction count and
    its loops, each a backward branch and its target, with the
    instructions, shared-memory loads (LDS), float32 arithmetic (FADD,
    FMUL, FFMA, FMNMX, FSETP, FSEL) and MUFU between them."""
    out, name, ins = {}, None, []

    def close():
        if name is None:
            return
        addr = {a: k for k, (a, _) in enumerate(ins)}
        loops = []
        for k, (a, text) in enumerate(ins):
            m = _BRANCH.search(text)
            if m is None or int(m.group(1), 16) > a or int(m.group(1), 16) not in addr:
                continue
            body = [t for _, t in ins[addr[int(m.group(1), 16)]:k + 1]]
            op = [t.split()[1] if t.startswith("@") else t.split()[0] for t in body]
            loops.append({"start": hex(int(m.group(1), 16)), "end": hex(a),
                          "instructions": len(body),
                          "lds": sum(o.startswith("LDS") for o in op),
                          "fp32": sum(o.split(".")[0] in ("FADD", "FMUL", "FFMA", "FMNMX",
                                                         "FSETP", "FSEL") for o in op),
                          "mufu": sum(o.startswith("MUFU") for o in op)})
        out[name] = {"instructions": len(ins), "loops": loops}

    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            name, ins = m.group(1), []
            continue
        m = _SASS_LINE.search(line)
        if m and name is not None:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    close()
    return out


def _sass(so: Path) -> dict:
    tool = Path(ci._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True)
    return sass_loops(proc.stdout)


def build() -> dict:
    """The source as it is and with the record, built at once: {name:
    (library, ptxas report, SASS loops)}."""
    DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = (ci.CSRC / FILE).read_text()
    texts = {"source": src, "record": record_patch(src)}
    jobs = {}
    for name, text in texts.items():
        copy = DIAG_DIR / f"k1_{name}.cu"
        copy.write_text(text)
        jobs[name] = (copy, copy.with_suffix(".so"))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        reports = dict(zip(jobs, pool.map(lambda j: _nvcc(*j), jobs.values())))
    libs = {}
    for name, (_, so) in jobs.items():
        lib = ctypes.CDLL(str(so))
        if name == "record":
            lib.pbr_diag_set.argtypes, lib.pbr_diag_set.restype = [ctypes.c_void_p], ctypes.c_int
        libs[name] = (lib, reports[name], _sass(so))
    return libs


def _cols(v: Vec3, sl) -> Vec3:
    return Vec3(v.x[sl, None], v.y[sl, None], v.z[sl, None])


def _det_tnum(o: Vec3, d: Vec3, table: torch.Tensor) -> tuple:
    """det and t's numerator of every (ray, face) pair, in the kernel's
    operations (mt.cuh::mt_t; mt_lin.cuh::lin_det, lin_tnum)."""
    if table.shape[0] == 16:
        m0, m1, m2, km = table[:4]
        return d.x * m0 + d.y * m1 + d.z * m2, km - (o.x * m0 + o.y * m1 + o.z * m2)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = table
    px, py, pz = d.y * e2z - d.z * e2y, d.z * e2x - d.x * e2z, d.x * e2y - d.y * e2x
    tx, ty, tz = o.x - v0x, o.y - v0y, o.z - v0z
    qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
    return e1x * px + e1y * py + e1z * pz, e2x * qx + e2y * qy + e2z * qz


def _test(o: Vec3, d: Vec3, table: torch.Tensor) -> tuple:
    """(t, valid) of every (ray, face) pair: the plain version's test."""
    if table.shape[0] == 16:
        return ci.mt_lin(o, d, ci.cross_od(o, d), table)
    c = table
    return moller_trumbore(o, d, Vec3(c[0], c[1], c[2]), Vec3(c[3], c[4], c[5]),
                           Vec3(c[6], c[7], c[8]))


def sweep_counts(o: Vec3, d: Vec3, table: torch.Tensor, light: torch.Tensor) -> dict:
    """What a full sweep needs on rays ``o``, ``d`` against the (9, F) or
    (16, F) ``table``, with light 0 at ``light`` (3,), from the plain
    version's arithmetic. Nearest: ``tests`` (every (ray, face) pair),
    ``uv_tests`` (``1e-5 <= t <=`` the ray's final t), ``skip_tests``
    (det and t's numerator not both > 0 nor both < 0: no division). The
    shadow rays of the nearest result (every ray): ``shadow_tests`` up to
    and including the first occluder in face order (all faces where none
    is), ``shadow_uv_tests`` (``1e-5 <= t < t_light`` among them),
    ``shadow_skip_tests``; ``occluded`` rays, and ``occluded_warps`` of
    ``warps`` (32 rays in a row, every one occluded). A chunk of rays holds
    at most ``SWEEP_ELEMS`` (ray, face) pairs; the counts are summed on the
    device and read once."""
    n, nf = o.x.shape[0], table.shape[1]
    step = max(WARP, SWEEP_ELEMS // max(nf, 1) // WARP * WARP)
    k = torch.arange(nf, device=table.device)
    keys = ("uv_tests", "skip_tests", "shadow_tests", "shadow_uv_tests", "shadow_skip_tests",
            "occluded", "occluded_warps")
    acc = torch.zeros(len(keys), dtype=torch.int64, device=table.device)
    tests = 0
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        oc, dc = _cols(o, sl), _cols(d, sl)
        t, valid = _test(oc, dc, table)
        t_min = torch.where(valid, t, float("inf")).amin(dim=1)
        det, tnum = _det_tnum(oc, dc, table)
        skip = ~((torch.fmin(det, tnum) > 0.0) | (torch.fmax(det, tnum) < 0.0))
        tests += t.numel()
        uv = ((t >= EPS5) & (t <= t_min[:, None])).sum()
        n_skip = skip.sum()
        hit_p, s_dir, t_light = ci._shadow_ray(Vec3(*(a[sl] for a in o)),
                                               Vec3(*(a[sl] for a in d)), t_min, light)
        hc, sc = _cols(hit_p, slice(None)), _cols(s_dir, slice(None))
        t, valid = _test(hc, sc, table)
        below = (t >= EPS5) & (t < t_light[:, None])
        first = torch.where(valid & below, k, nf).amin(dim=1)
        upto = k <= first[:, None]
        det, tnum = _det_tnum(hc, sc, table)
        skip = ~((torch.fmin(det, tnum) > 0.0) | (torch.fmax(det, tnum) < 0.0))
        occ = first < nf
        pad = torch.ones(-occ.shape[0] % WARP, dtype=torch.bool, device=occ.device)
        acc += torch.stack([
            uv, n_skip, torch.clamp(first + 1, max=nf).sum(), (below & upto).sum(),
            (skip & upto).sum(), occ.sum(),
            torch.cat([occ, pad]).reshape(-1, WARP).all(dim=1).sum()]).to(torch.int64)
    res = {"tests": tests, **dict(zip(keys, (int(v) for v in acc.tolist())))}
    res["warps"] = -(-n // WARP)
    return res


def ray_sets(dev) -> dict:
    """{name: (tris, o, d, light (3,))}: Cornell's camera rays and bounce 1
    of a recorded frame, multiroom's camera rays, 1M rays against a
    4,000-face soup."""
    import chip_smoke as smoke  # the repo root's: its scenes, camera and settings

    from pbr_tpu_torch.scene.build import scene_from_text
    from pbr_tpu_torch.scene.procedural import random_soup

    sets = {}
    for tag, (scene, cam) in (("cornell", smoke.cornell()), ("multiroom", smoke.multiroom())):
        pt = PathTracer(scene, smoke.bench_settings(smoke.SIZE), device=dev)
        pt.render(cam, frame_seed=0)  # the probes, and a warm-up frame
        ts = pt.scene
        light = torch.stack(list(smoke._light0(ts)))
        o, d = smoke._camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
        sets[f"{tag} camera rays"] = (ts.tris, o, d, light)
        if tag != "cornell":
            continue
        calls, real = [], ci.intersect_fused

        def record(o, d, tris, light_pos=None, variant="mt"):
            calls.append((o, d, tris, light_pos))
            return real(o, d, tris, light_pos=light_pos, variant=variant)

        ci.intersect_fused = record
        try:
            smoke.eager_frame(pt, cam, 1)  # eager: a graph's replay calls no wrapper
        finally:
            ci.intersect_fused = real
        torch.cuda.synchronize()
        o, d, tris, l0 = calls[1]
        sets["cornell bounce 1"] = (tris, o, d, torch.stack(list(l0)))
        cornell_light = light
    soup, _ = scene_from_text(random_soup(4000), use_bvh=False)
    o, d = smoke._rays_in_box(1 << 20, 2, dev)
    sets["soup:4000"] = (to_torch(soup, dev).tris, o, d, cornell_light)
    return sets


def _with(lib, fn):
    """``fn()`` with ``cuda_intersect.load`` answering with ``lib``."""
    real = ci.load

    def copy_load(name, symbol, argtypes):
        f = getattr(lib, symbol)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return lib

    ci.load = copy_load
    try:
        return fn()
    finally:
        ci.load = real


def graph_ms(fn, iters: int) -> float:
    """ms a call of ``iters`` calls of ``fn`` captured in a CUDA graph and
    replayed twice."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    g.replay()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def time_once(fn) -> tuple:
    """One call of ``fn`` timed with CUDA events: (ms, its result)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _fmt(st: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in st.items())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/k1_sweep.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_sweep: no CUDA device")
    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    res = {"device": card, "builds": {}, "sets": {}}
    for name, (_, report, sass) in libs.items():
        res["builds"][name] = {"ptxas": report, "sass": sass}
        print(f"{name}: ptxas\n{report}", flush=True)
        for kernel, st in sass.items():
            loops = [{k: v for k, v in lp.items() if k not in ("start", "end")}
                     for lp in st["loops"]]
            print(f"{name}: {kernel}: {st['instructions']} instructions; loops {loops}",
                  flush=True)
    import chip_smoke as smoke  # the repo root's: its bounds

    sets = ray_sets(dev)
    for sname, (tris, o, d, light) in sets.items():
        n, nf = o.x.shape[0], int(tris.mtl.shape[0])
        l0 = Vec3(*light)
        st = res["sets"][sname] = {"rays": n, "faces": nf, "forms": {}, "instances": {}}
        for form in ("mt", "lin"):
            table = ci.lin_table(tris) if form == "lin" else ci.face_table(tris)
            counts = sweep_counts(o, d, table, light)
            nee, near = smoke._full_sweep_bounds(counts, n, nf, form == "lin")
            st["forms"][form] = {"counts": counts, "bound_nee": nee, "bound_nearest": near}
            print(f"{sname}, {form}: {_fmt(counts)}; bound NEE {nee[0]:.4f} ms ({nee[1]}), "
                  f"nearest {near[0]:.4f} ms ({near[1]})", flush=True)
        for inst, form, nee in INSTANCES:
            table = ci.lin_table(tris) if form == "lin" else ci.face_table(tris)
            plain_ms, ref = time_once(lambda: ci.intersect_fused_plain(
                o, d, table, light if nee else None))
            row = st["instances"][inst] = {"plain_ms": plain_ms}

            def call(nee=nee, form=form):
                return ci.intersect_fused(o, d, tris, light_pos=l0 if nee else None, variant=form)

            for name, (lib, _, _) in libs.items():
                if name == "record":
                    rec = torch.zeros((n // WARP + 64, 4), dtype=torch.int64, device=dev)
                    if lib.pbr_diag_set(rec.data_ptr()) != 0:
                        raise RuntimeError("cudaMemcpyToSymbol of the record pointer failed")
                    _with(lib, call)  # warm-up
                    rec.zero_()
                got = _with(lib, call)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise AssertionError(f"{sname}, {inst}: build {name} differs from the "
                                         f"plain version")
                if name == "record":
                    r = rec.cpu().numpy()
                    row["blocks"] = block_stats(r[r[:, 0] > 0])
                    continue
                row[name] = {"ms": _with(lib, lambda: _time_ms(call, ITERS)),
                             "graph_ms": _with(lib, lambda: graph_ms(call, ITERS))}
            print(f"{sname}, {inst}: plain {plain_ms:.4f} ms; "
                  + "; ".join(f"{k} {v['ms']:.4f} / graph {v['graph_ms']:.4f} ms"
                              for k, v in row.items() if isinstance(v, dict) and "ms" in v)
                  + f"; blocks span {row['blocks']['span_ms']:.4f} ms, last after median "
                    f"{row['blocks']['last_after_median_ms']:.4f} ms, resident "
                    f"{row['blocks']['max_resident']}", flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"k1_sweep": {s: {i: {k: v["graph_ms"] for k, v in r.items()
                                          if isinstance(v, dict) and "graph_ms" in v}
                                       for i, r in st["instances"].items()}
                                   for s, st in res["sets"].items()}}), flush=True)


if __name__ == "__main__":
    main()
