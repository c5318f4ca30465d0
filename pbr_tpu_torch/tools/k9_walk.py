"""Kernel K9, the Phong BVH walk, on a card: the launch order each kind of
Phong pass takes, the kernel against an earlier tree's, its registers and
occupancy variants, and the SIMD efficiency of its curved tests.

    python3 -m pbr_tpu_torch.tools.k9_walk [--out out/K9_ORDER_H100.json] [--rounds 3]
        [--parent DIR] [--base DIR] [--min-blocks 1,8]
    python3 -m pbr_tpu_torch.tools.k9_walk --check
    python3 -m pbr_tpu_torch.tools.k9_walk --summary docs/K9_ORDER_H100.json

Scenes: chip_smoke.py's two Phong scenes (``scene/procedural.py::
cornell_sphere``: the sphere, 562 faces, and the dense sphere, 9,058 faces;
alpha 0.8) at 1024² with bench.py's settings, the compaction schedule and
lane order from the probes (``PathTracer``). For each, one eager frame's K9
passes are recorded (the wrappers' arguments), each tagged with its kind by
its place in the frame: the camera pass (the first nearest pass, bounce
0's), the nearest passes of bounces 1-7, and the 8 shadow legs (the any-hit
instance). Each of ``--rounds`` interleaved rounds times, for
each scene and pass kind, the sum over the kind's passes of each launch
order computed in the call and then the kernel (each pass a CUDA graph of
``ITERS`` calls replayed, ``k1_sweep.graph_ms``), the orders in turn, the
first rotating between rounds (``ORDERS``):

- "lane": the rays as given;
- "sort": the wrapper's sort, ``cuda_bvh.ray_order`` (octant, then Morton
  code of the origin; torch's argsort);
- "octant": a stable argsort of the direction's octant alone
  (``octant_order``);
- "live": the live lanes first in lane order (``live_order``: a stable
  partition, no sort).

``order_policy`` reads the record: a pass kind would be sorted only where
"sort" beats "lane" in every round on both scenes. On the H100 it sorts
none, so the wrappers launch the rays as given
(tests/test_torch_phong_bands.py holds the committed record to that); the
two cheaper orders are measured beside it.

Before the rounds it prints the card's name and power limit; ptxas's report
on the kernel as the port builds it and on the copies ``--min-blocks``
asks for (``-DPBR_K9_MIN_BLOCKS``) and ``--base`` gives, and each copy's
ms against the port's build in ``--rounds`` interleaved rounds (the first
build rotating) on the four 1M passes (the sphere's and the dense sphere's
camera rays and 1,048,576 rays in the box: chip_smoke.py's) and on each
scene's recorded passes of each kind (summed), in lane order; the
diagnostic build's counts over each scene's recorded passes by kind
(``-DPBR_K9_DIAG``: curved tests dealt, drains, dealt face steps with a
curved pair, curved tests and face steps of the steps where every lane at
a leaf stood at one leaf), which give the SIMD efficiency of the curved
tests as the kernel runs them (tests / 32 a drain or one-leaf face step)
and as each lane's own loop would run them (tests / 32 a face step with
one), and the shares of a warp's clock cycles in node steps, flat tests
and curved tests. ``--base DIR`` (an unpacked tree whose K9 takes this
entry point) builds that tree's ``csrc/phong_walk.cu`` as the copy
"base". ``--parent DIR`` (an unpacked earlier tree) builds that tree's
``csrc/phong_walk.cu`` (K9's entry point before its any-hit instance) and
times it against this one, parent, this, this, parent
(``against_parent``): on the four 1M passes each kernel alone in the
sorted order and in lane order and each with its wrapper's order step (the
parent's sorted every pass); on each scene's frame the nearest passes and
the shadow legs; the nearest results held bitwise equal.
``--check`` holds K9 and K9 any-hit to their plain versions, bitwise, on
the first ``CHECK_RAYS`` rays of each recorded pass and of the box rays,
and exits. Copies build into ``build/pbr_tpu_torch/diag/``; the record goes
to ``--out``, the policy's answer is the last line.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

SCENES = {"sphere": {}, "dense sphere": {"rings": 48, "segments": 96}}
KINDS = ("camera", "bounce", "shadow")
ORDERS = ("lane", "sort", "octant", "live")
ALPHA, SIZE, BOX_RAYS = 0.8, 1024, 1 << 20
ITERS = 5
CHECK_RAYS = 8192


class Pass(NamedTuple):
    kind: str
    o: object  # Vec3
    d: object
    alive: Optional[torch.Tensor]
    t_limit: Optional[torch.Tensor]


def order_policy(record: dict) -> dict:
    """``{"sort": [pass kinds the rule sorts], "wins": {kind: whether
    "sort" beat "lane" in every round on every scene}}``: the module's rule
    over ``record``."""
    n = record["rounds"]
    wins = {}
    for kind in KINDS:
        rows = [r for r in record["passes"] if r["kind"] == kind]
        wins[kind] = len(rows) == len(SCENES) and all(
            len(r["rounds"]) == n and all(x["sort"] < x["lane"] for x in r["rounds"])
            for r in rows)
    return {"sort": sorted(k for k in KINDS if wins[k]), "wins": wins}


def _rng(xs) -> str:
    """The median of ``xs`` and their range."""
    return f"{statistics.median(xs):.4f} ({min(xs):.4f}-{max(xs):.4f})"


def summary(record: dict) -> str:
    """Markdown tables of ``record``: each (scene, kind) row's medians and
    ranges a frame, the parent comparison, the variants and the SIMD
    efficiency, and the policy."""
    orders = [o for o in ORDERS if o in record["passes"][0]["rounds"][0]]
    out = [f"{record['device']}, {record['rounds']} rounds", "",
           "| scene | kind | passes | rays | " + " | ".join(f"{o} ms" for o in orders) + " |",
           "|---|---|---|---|" + "---|" * len(orders)]
    for r in record["passes"]:
        out.append(f"| {r['scene']} | {r['kind']} | {r['passes']} | {r['rays']:,} | "
                   + " | ".join(_rng([x[o] for x in r["rounds"]]) for o in orders) + " |")
    if record.get("parent"):
        for name, v in record["parent"].items():
            out += ["", f"{name}: " + ", ".join(f"{k.replace('_', ' ')} {x:.4f} ms"
                                                 for k, x in v.items())]
    var = record.get("variants")
    if var:
        out += ["", "| build | " + " | ".join(var["passes"]) + " |",
                "|---|" + "---|" * len(var["passes"])]
        for name in var["ms"]:
            per = [[r[name][j] for r in var["rounds"]] for j in range(len(var["passes"]))] \
                if "rounds" in var else [[x] for x in var["ms"][name]]
            out.append(f"| {name} | " + " | ".join(_rng(xs) for xs in per) + " |")
    if record.get("simd"):
        out += ["", "| scene | kind | curved tests | one-leaf tests | drains + one-leaf steps "
                "| as run | own loops | cycles in nodes / flat / curved |",
                "|---|---|---|---|---|---|---|---|"]
        for r in record["simd"]:
            out.append(f"| {r['scene']} | {r['kind']} | {r['tests']:,} | "
                       f"{r.get('own_tests', 0):,} | {r['drains']:,} + {r.get('own_steps', 0):,} "
                       f"| {r['dealt']:.3f} | {r['own']:.3f} | "
                       + " / ".join(f"{v:.3f}" for v in r["share"].values()) + " |")
    out += ["", f"policy: {json.dumps(order_policy(record))}"]
    return "\n".join(out)


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _nvcc(src: Path, out: Path, include: Path, defines=()) -> str:
    """``src`` built into ``out`` with the port's flags, ``include``'s
    headers, ``defines`` and ``-Xptxas -v``: ptxas's report."""
    from pbr_tpu_torch.ops import cuda_intersect as ci

    proc = subprocess.run([ci._nvcc(), *ci.NVCC_FLAGS, *(f"-D{x}" for x in defines),
                           "-Xptxas", "-v", "-I", str(include), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lines, kernel = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("Used" in line or "spill" in line):
            lines.append(f"{out.stem}: {kernel}: {line.split(':', 1)[-1].strip()}")
    return "\n".join(lines)


def build(min_blocks, parent: Optional[Path], base: Optional[Path] = None) -> tuple:
    """The copies, built at once: ({name: library}, ptxas's reports).
    "port": the source as the port builds it; "diag": with the counters;
    "min N": with ``PBR_K9_MIN_BLOCKS=N``; "parent": ``parent``'s; "base":
    ``base``'s."""
    from pbr_tpu_torch.ops import cuda_intersect as ci
    from pbr_tpu_torch.ops import cuda_phong as cp
    from pbr_tpu_torch.tools import k4_tiles

    k4_tiles.DIAG_DIR.mkdir(parents=True, exist_ok=True)
    src = ci.CSRC / "phong_walk.cu"
    jobs = {"port": (src, ci.CSRC, ()), "diag": (src, ci.CSRC, ("PBR_K9_DIAG",))}
    for m in min_blocks:
        jobs[f"min {m}"] = (src, ci.CSRC, (f"PBR_K9_MIN_BLOCKS={m}",))
    for name, tree in (("parent", parent), ("base", base)):
        if tree is not None:
            csrc = tree / "pbr_tpu_torch" / "csrc"
            jobs[name] = (csrc / "phong_walk.cu", csrc, ())
    outs = {k: k4_tiles.DIAG_DIR / f"k9_{k.replace(' ', '_')}.so" for k in jobs}
    with ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda k: _nvcc(jobs[k][0], outs[k], *jobs[k][1:]), jobs))
    libs = {}
    for k, so in outs.items():
        libs[k] = ctypes.CDLL(str(so))
        libs[k].pbr_phong_walk.restype = ctypes.c_int
        libs[k].pbr_phong_walk.argtypes = (_PARENT_ARGTYPES if k == "parent"
                                           else cp._WALK_ARGTYPES)
    libs["diag"].pbr_phong_walk_diag.argtypes = [ctypes.c_void_p]
    libs["diag"].pbr_phong_walk_diag.restype = ctypes.c_int
    return libs, "\n".join(reports)


# K9's entry point before its any-hit instance: rays (6), order, alive, n,
# nodes, n_nodes, faces, max_leaf, alpha, 1 - alpha, t, f, u, v, stream.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PARENT_ARGTYPES = [_P] * 8 + [_I, _P, _I, _P, _I, _F, _F] + [_P] * 5


def parent_kernel(lib, o, d, ts, ml: int, order, alive=None):
    """The parent tree's K9 (nearest): ``(t, face, u, v)``."""
    from pbr_tpu_torch.ops import cuda_phong as cp

    n, dev = o.x.shape[0], o.x.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    f = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    err = lib.pbr_phong_walk(*(a.data_ptr() for a in (*o, *d)),
                             None if order is None else order.data_ptr(),
                             None if alive is None else alive.data_ptr(), n,
                             ts.bvh.node_records.data_ptr(), ts.bvh.count,
                             ts.phong_records.data_ptr(), ml, *cp._alphas(ALPHA), t.data_ptr(),
                             f.data_ptr(), u.data_ptr(), v.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's K9 launch failed: cudaError {err}")
    return t, f, u, v


def rays_in_box(n: int, seed: int, dev) -> tuple:
    """chip_smoke.py's rays in the box: origins in [-0.8, 0.8] (y + 1),
    unit directions."""
    from pbr_tpu_torch.ops.vec import Vec3

    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.8, 0.8, (3, n)).astype(np.float32)
    o[1] += 1.0
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return tuple(Vec3(*(torch.tensor(c, device=dev) for c in a)) for a in (o, d))


def octant_order(d, alive) -> torch.Tensor:
    """The rays stably sorted by the octant of their direction, dead lanes
    last, (B,) int32."""
    key = ((d.x < 0).to(torch.int32) + 2 * (d.y < 0).to(torch.int32)
           + 4 * (d.z < 0).to(torch.int32))
    if alive is not None:
        key = torch.where(alive, key, 8)
    return torch.argsort(key, stable=True).to(torch.int32)


def live_order(alive) -> Optional[torch.Tensor]:
    """The live lanes first in lane order, then the dead ones: a stable
    partition by ``alive`` (two prefix sums and a scatter, no sort and no
    host read), (B,) int32; None where every lane is live."""
    if alive is None:
        return None
    live = alive.to(torch.int64)
    ahead = torch.cumsum(live, 0)
    pos = torch.where(alive, ahead - 1, ahead[-1:] + torch.cumsum(1 - live, 0) - 1)
    lanes = torch.arange(alive.shape[0], dtype=torch.int32, device=alive.device)
    return torch.empty_like(lanes).scatter_(0, pos, lanes)


def launch_order(p: Pass, ts, order: str) -> Optional[torch.Tensor]:
    """The launch ``order`` (``ORDERS``) of pass ``p``, None for the rays as
    given."""
    from pbr_tpu_torch.ops import cuda_bvh as cb

    orders = {"lane": lambda: None, "sort": lambda: cb.ray_order(p.o, p.d, ts.bvh, p.alive),
              "octant": lambda: octant_order(p.d, p.alive), "live": lambda: live_order(p.alive)}
    return orders[order]()


def record_passes(pt, cam) -> list:
    """Each K9 pass of one eager frame of ``pt`` (frame seed 1), its
    arguments copied."""
    from pbr_tpu_torch.models.pathtracer import render_frame
    from pbr_tpu_torch.ops import cuda_phong as cp
    from pbr_tpu_torch.ops.vec import Vec3
    from pbr_tpu_torch.scene.device import camera_to_torch

    passes = []
    near, occ = cp.intersect_walk, cp.occluded_walk
    copy = lambda v: Vec3(*(a.clone() for a in v))  # noqa: E731
    opt = lambda a: None if a is None else a.clone()  # noqa: E731

    def walk(o, d, bvh, faces, alpha, max_leaf=None, alive=None):
        kind = "bounce" if any(p.t_limit is None for p in passes) else "camera"
        passes.append(Pass(kind, copy(o), copy(d), opt(alive), None))
        return near(o, d, bvh, faces, alpha, max_leaf=max_leaf, alive=alive)

    def any_hit(o, d, t_limit, bvh, faces, alpha, max_leaf=None, alive=None):
        passes.append(Pass("shadow", copy(o), copy(d), opt(alive), t_limit.clone()))
        return occ(o, d, t_limit, bvh, faces, alpha, max_leaf=max_leaf, alive=alive)

    cp.intersect_walk, cp.occluded_walk = walk, any_hit
    try:
        with torch.no_grad():
            render_frame(pt.scene, camera_to_torch(cam, pt.device), pt.settings, pt.state,
                         pt.pixel_ids, 1, max_leaf=pt.max_leaf)
    finally:
        cp.intersect_walk, cp.occluded_walk = near, occ
    return passes


def launcher(p: Pass, ts, ml: int, order: str = "lane", lib=None):
    """A call of K9 on pass ``p`` with the launch ``order`` (``ORDERS``)
    computed in the call, by ``lib`` (None: the port's build)."""
    from pbr_tpu_torch.ops import cuda_phong as cp

    return lambda: cp.walk_kernel(p.o, p.d, ts.bvh, ts.phong_records, ALPHA, ml, p.alive,
                                  launch_order(p, ts, order), p.t_limit, lib=lib)


def graph_ms(fn) -> float:
    """``k1_sweep.graph_ms`` of ``ITERS`` calls, with Python's cycle
    collector run before and held off during the capture (a graph freed by
    it mid-capture invalidates the capture)."""
    from pbr_tpu_torch.tools import k1_sweep

    gc.collect()
    gc.disable()
    try:
        return k1_sweep.graph_ms(fn, ITERS)
    finally:
        gc.enable()


def check(setup: dict, box) -> None:
    """K9 and K9 any-hit bitwise their plain versions on the first
    ``CHECK_RAYS`` rays of each recorded pass and of the box rays (t_limit
    around the nearest t there), each in lane order and sorted."""
    from pbr_tpu_torch.ops import phongtess
    from pbr_tpu_torch.ops.vec import Vec3

    cut = lambda v: Vec3(*(a[:CHECK_RAYS].contiguous() for a in v))  # noqa: E731
    for name, st in setup.items():
        ts, ml = st["ts"], st["ml"]
        bo, bd = cut(box[0]), cut(box[1])
        t_box = phongtess.intersect_bvh_phongtess(bo, bd, ts.bvh, None, ALPHA, ml,
                                                  faces=ts.phong_records)[0]
        scale = torch.linspace(0.5, 1.5, CHECK_RAYS, device=t_box.device)
        lim = torch.where(torch.isfinite(t_box), t_box * scale, 10.0).contiguous()
        extra = [Pass("bounce", bo, bd, None, None), Pass("shadow", bo, bd, None, lim)]
        for j, p in enumerate(st["passes"] + extra):
            q = Pass(p.kind, cut(p.o), cut(p.d),
                     None if p.alive is None else p.alive[:CHECK_RAYS].contiguous(),
                     None if p.t_limit is None else p.t_limit[:CHECK_RAYS].contiguous())
            kw = dict(faces=ts.phong_records, alive=q.alive)
            ref = (phongtess.intersect_bvh_phongtess(q.o, q.d, ts.bvh, None, ALPHA, ml, **kw)
                   if q.t_limit is None else
                   phongtess.occluded_bvh_phongtess(q.o, q.d, q.t_limit, ts.bvh, None, ALPHA,
                                                    ml, **kw))
            for order in ("lane", "sort"):
                got = launcher(q, ts, ml, order)()
                pairs = zip(got, ref) if q.t_limit is None else [(got, ref)]
                bad = [int((a != b).sum()) for a, b in pairs]
                if any(bad):
                    raise AssertionError(f"{name} pass {j} ({q.kind}, {order}): K9 differs from "
                                         f"its plain version: {bad}")
            hit = float(((ref[1] >= 0) if q.t_limit is None else ref).float().mean())
            print(f"check: {name} pass {j} ({q.kind}, {q.o.x.shape[0]} rays): bitwise its "
                  f"plain version in lane order and sorted; hit {hit:.4f}", flush=True)


def simd(libs: dict, setup: dict) -> list:
    """The diagnostic build's counts over each scene's passes by kind."""
    out = []
    buf = (ctypes.c_ulonglong * 9)()
    for name, st in setup.items():
        for kind in KINDS:
            libs["diag"].pbr_phong_walk_diag(ctypes.addressof(buf))  # zero
            for p in st["passes"]:
                if p.kind == kind:
                    launcher(p, st["ts"], st["ml"], lib=libs["diag"])()
            torch.cuda.synchronize()
            err = libs["diag"].pbr_phong_walk_diag(ctypes.addressof(buf))
            if err != 0:
                raise RuntimeError(f"reading K9's counters failed: cudaError {err}")
            dealt, drains, steps, own_tests, own_steps, *cycles = (int(x) for x in buf)
            tests = dealt + own_tests
            share = {k: c / max(1, cycles[3]) for k, c in zip(("nodes", "flat", "curved"),
                                                              cycles)}
            row = {"scene": name, "kind": kind, "tests": tests, "drains": drains,
                   "own_tests": own_tests, "own_steps": own_steps, "steps": steps + own_steps,
                   "dealt": tests / max(1, 32 * (drains + own_steps)),
                   "own": tests / max(1, 32 * (steps + own_steps)), "cycles": cycles[3],
                   "share": share}
            out.append(row)
            print(f"SIMD: {name}, {kind}: {tests} curved tests, {own_tests} of them in "
                  f"{own_steps} one-leaf face steps, the rest in {drains} drains (efficiency "
                  f"{row['dealt']:.3f}); each lane's own loop: {row['steps']} face steps with "
                  f"one ({row['own']:.3f}); a warp's cycles: " + ", ".join(
                      f"{k} {v:.3f}" for k, v in share.items()), flush=True)
    return out


def big_passes(setup: dict, box) -> dict:
    """The four 1M passes: each scene's camera pass and the box rays."""
    out = {}
    for name, st in setup.items():
        out[f"{name} camera"] = (st, next(p for p in st["passes"] if p.kind == "camera"))
        out[f"{name} box"] = (st, Pass("bounce", box[0], box[1], None, None))
    return out


def variants(libs: dict, setup: dict, box, rounds: int) -> dict:
    """ms of each ``min N`` copy and of "base" against the port's build in
    ``rounds`` interleaved rounds, the first build rotating, on the four 1M
    passes and on each scene's passes of each kind (summed), in lane
    order."""
    names = ["port"] + [k for k in libs if k.startswith("min ") or k == "base"]
    sets = {name: [p] for name, (_, p) in big_passes(setup, box).items()}
    where = {name: setup[name.rsplit(" ", 1)[0]] for name in sets}
    for scene, st in setup.items():
        for kind in KINDS:
            sets[f"{scene} {kind} passes"] = [p for p in st["passes"] if p.kind == kind]
            where[f"{scene} {kind} passes"] = st
    per_round = []
    for r in range(rounds):
        got = {}
        for k in names[r % len(names):] + names[:r % len(names)]:
            lib = None if k == "port" else libs[k]
            got[k] = [sum(graph_ms(launcher(p, where[n]["ts"], where[n]["ml"], lib=lib))
                          for p in ps) for n, ps in sets.items()]
            print(f"round {r}, build {k}: " + ", ".join(
                f"{n} {x:.4f} ms" for n, x in zip(sets, got[k])), flush=True)
        per_round.append({k: got[k] for k in names})
    ms = {k: [statistics.median(row[k][j] for row in per_round) for j in range(len(sets))]
          for k in names}
    return {"passes": list(sets), "rounds": per_round, "ms": ms}


def against_parent(lib, setup: dict, box) -> dict:
    """The parent's K9 against this one, parent, this, this, parent: on the
    four 1M passes, the kernels alone in the sorted order and in lane order
    and each with its wrapper's order step (the parent's sorted every
    pass); on each scene's recorded frame, the nearest passes (camera and
    bounces) summed, the parent's kernel with its sort and in lane order
    against this wrapper's, and the shadow legs summed, the parent's
    nearest search with its sort against this any-hit wrapper's. The
    nearest results are held bitwise equal."""
    from pbr_tpu_torch.ops import cuda_bvh as cb
    from pbr_tpu_torch.ops import cuda_phong as cp

    def timed(fns: dict, pairs) -> dict:
        row = {}
        for pair in pairs:
            for k in (*pair, *pair[::-1]):
                row.setdefault(k, []).append(fns[k]())
        return {k: statistics.mean(v) for k, v in row.items()}

    out = {}
    for name, (st, p) in big_passes(setup, box).items():
        ts, ml = st["ts"], st["ml"]
        order = cb.ray_order(p.o, p.d, ts.bvh)
        calls = {
            "parent_kernel": lambda: parent_kernel(lib, p.o, p.d, ts, ml, order),
            "kernel": lambda: cp.walk_kernel(p.o, p.d, ts.bvh, ts.phong_records, ALPHA, ml,
                                             None, order),
            "parent_lane": lambda: parent_kernel(lib, p.o, p.d, ts, ml, None),
            "lane": lambda: cp.walk_kernel(p.o, p.d, ts.bvh, ts.phong_records, ALPHA, ml,
                                           None, None),
            "parent_wrapper": lambda: parent_kernel(lib, p.o, p.d, ts, ml,
                                                    cb.ray_order(p.o, p.d, ts.bvh)),
            "wrapper": lambda: cp.intersect_walk(p.o, p.d, ts.bvh, ts.phong_records, ALPHA)}
        ref = calls["parent_kernel"]()
        for k in ("kernel", "lane", "wrapper"):
            bad = [int((a != b).sum()) for a, b in zip(calls[k](), ref)]
            if any(bad):
                raise AssertionError(f"{name}: this tree's K9 ({k}) differs from the parent's: "
                                     f"{bad}")
        out[name] = timed({k: (lambda f=f: graph_ms(f)) for k, f in calls.items()},
                          (("parent_kernel", "kernel"), ("parent_lane", "lane"),
                           ("parent_wrapper", "wrapper")))
        print(f"parent vs this, {name} (bitwise equal): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in out[name].items()), flush=True)
    for name, st in setup.items():
        ts, ml = st["ts"], st["ml"]
        near = [p for p in st["passes"] if p.t_limit is None]
        shadow = [p for p in st["passes"] if p.t_limit is not None]
        for p in near:
            got = cp.intersect_walk(p.o, p.d, ts.bvh, ts.phong_records, ALPHA, alive=p.alive)
            ref = parent_kernel(lib, p.o, p.d, ts, ml, None, p.alive)
            if any(int((a != b).sum()) for a, b in zip(got, ref)):
                raise AssertionError(f"{name}, {p.kind}: this tree's K9 differs from the "
                                     f"parent's")

        def frame_sum(ps, fn):
            return lambda: sum(graph_ms(lambda p=p: fn(p)) for p in ps)

        sorted_parent = lambda p: parent_kernel(  # noqa: E731
            lib, p.o, p.d, ts, ml, cb.ray_order(p.o, p.d, ts.bvh, p.alive), p.alive)
        calls = {
            "nearest_parent_wrapper": frame_sum(near, sorted_parent),
            "nearest_parent_lane": frame_sum(near, lambda p: parent_kernel(
                lib, p.o, p.d, ts, ml, None, p.alive)),
            "nearest_wrapper": frame_sum(near, lambda p: cp.intersect_walk(
                p.o, p.d, ts.bvh, ts.phong_records, ALPHA, alive=p.alive)),
            "shadow_parent_wrapper": frame_sum(shadow, sorted_parent),
            "shadow_wrapper": frame_sum(shadow, lambda p: cp.occluded_walk(
                p.o, p.d, p.t_limit, ts.bvh, ts.phong_records, ALPHA, alive=p.alive))}
        out[f"{name} frame"] = timed(calls, (
            ("nearest_parent_wrapper", "nearest_wrapper"),
            ("nearest_parent_lane", "nearest_wrapper"),
            ("shadow_parent_wrapper", "shadow_wrapper")))
        print(f"parent vs this, {name}'s frame passes: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in out[f"{name} frame"].items()), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/K9_ORDER_H100.json")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", help="an unpacked earlier tree: time its K9 against this one")
    ap.add_argument("--base", help="an unpacked tree with this K9 entry point: time its K9 "
                                   "as the copy 'base'")
    ap.add_argument("--min-blocks", default="", help="PBR_K9_MIN_BLOCKS copies to build and time")
    ap.add_argument("--check", action="store_true",
                    help="hold K9 to its plain versions on part of each pass, and exit")
    ap.add_argument("--summary", help="print the tables of a record and exit (no card)")
    a = ap.parse_args(argv)
    if a.summary:
        with open(a.summary) as f:
            print(summary(json.load(f)))
        return
    if not torch.cuda.is_available():
        raise SystemExit("k9_walk: no CUDA device")
    from pbr_tpu_torch import PathTracer
    from pbr_tpu_torch.bench import bench_settings, load_scene
    from pbr_tpu_torch.ops.traverse import leaf_bound
    from pbr_tpu_torch.scene.build import scene_from_text
    from pbr_tpu_torch.scene.procedural import cornell_sphere

    card = smi()
    print(card, flush=True)
    min_blocks = [int(x) for x in a.min_blocks.split(",") if x]
    libs, ptxas = build(min_blocks, Path(a.parent) if a.parent else None,
                        Path(a.base) if a.base else None)
    print(ptxas, flush=True)
    dev = torch.device("cuda", 0)
    cam = load_scene("cornell")[1]
    settings = bench_settings(SIZE, compact_schedule="auto", phong_tessellation=ALPHA)
    box = rays_in_box(BOX_RAYS, 5, dev)
    setup = {}
    for name, kw in SCENES.items():
        t0 = time.perf_counter()
        scene, _ = scene_from_text(*cornell_sphere(**kw), use_bvh=True, phong_tess_alpha=ALPHA)
        pt = PathTracer(scene, settings, device=dev)
        pt.render(cam, frame_seed=0)
        passes = record_passes(pt, cam)
        ts = pt.scene
        setup[name] = {"ts": ts, "ml": leaf_bound(ts.bvh), "passes": passes}
        kinds = {k: [p.o.x.shape[0] for p in passes if p.kind == k] for k in KINDS}
        print(f"{name}: {scene.tris.count} faces, lane order {pt.lane_order}, schedule "
              f"{pt.settings.compact_schedule}; K9 passes of a frame by kind (rays): {kinds}; "
              f"set up in {time.perf_counter() - t0:.1f} s", flush=True)
        del pt
    if a.check:
        check(setup, box)
        return
    record = {"device": card, "ptxas": ptxas, "rounds": a.rounds, "alpha": ALPHA, "size": SIZE,
              "iters": ITERS, "passes": []}
    record["simd"] = simd(libs, setup)
    if min_blocks or a.base:
        record["variants"] = variants(libs, setup, box, a.rounds)
    if a.parent:
        record["parent"] = against_parent(libs["parent"], setup, box)
    rows = {}
    for name, st in setup.items():  # every order gives the lane order's results
        for p in st["passes"]:
            ref = launcher(p, st["ts"], st["ml"], "lane")()
            for order in ORDERS[1:]:
                got = launcher(p, st["ts"], st["ml"], order)()
                for x, y in zip(*((g,) if p.t_limit is not None else g for g in (got, ref))):
                    if not torch.equal(x, y):
                        raise AssertionError(f"{name}, {p.kind}: order {order} changed a result")
    for k in range(a.rounds):
        turn = ORDERS[k % len(ORDERS):] + ORDERS[:k % len(ORDERS)]
        for name, st in setup.items():
            for kind in KINDS:
                ps = [p for p in st["passes"] if p.kind == kind]
                got = {o: sum(graph_ms(launcher(p, st["ts"], st["ml"], o)) for p in ps)
                       for o in turn}
                row = rows.setdefault((name, kind), {
                    "scene": name, "kind": kind, "passes": len(ps),
                    "rays": sum(p.o.x.shape[0] for p in ps), "rounds": []})
                row["rounds"].append({o: got[o] for o in ORDERS})
                print(f"round {k}: {name}, {kind} ({len(ps)} passes): " + ", ".join(
                    f"{o} {got[o]:.4f} ms" for o in ORDERS), flush=True)
    record["passes"] = list(rows.values())
    record["policy"] = order_policy(record)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(record, f, indent=1)
    print(summary(record), flush=True)
    print(json.dumps({"device": card, "policy": record["policy"]}), flush=True)


if __name__ == "__main__":
    main()
