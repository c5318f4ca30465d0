"""The port's benchmark: rays/s on one card, forward and backward, 1 spp,
1024x1024, the Cornell box.

    python -m pbr_tpu_torch.bench                          # the headline, on the card
    python -m pbr_tpu_torch.bench --fwd-only
    python -m pbr_tpu_torch.bench --scene multiroom
    python -m pbr_tpu_torch.bench --scene soup:100000 --fwd-only
    python -m pbr_tpu_torch.bench --scaling                # dp overhead on gloo CPU ranks
    python -m pbr_tpu_torch.bench --device cpu --size 16 --iters 1

The counterpart of the repository root's ``bench.py``, which stays the JAX
package's. Its last line on stdout is one JSON object with ``bench.py``'s
keys, ``{"metric", "value", "unit": "rays/s", "vs_baseline"}``, against
the 200M rays/s target of BASELINE.json; everything else goes to stderr.

What it measures is ``bench.py``'s: the scene and settings
(``bench_scene``: 1 spp, max_depth 3 plus up to 5 added bounces, NEE,
anti-aliasing 0.7, the compaction schedule from the occupancy probe, and
scanline lanes on the Cornell box, Morton lanes elsewhere), rays counted as
the traced path segments plus the shadow rays at seed 0 (``count_rays``,
with the compaction drops checked over seeds 0-3), and its step
(``step``): the sum of a frame's colours, and without ``--fwd-only`` its
gradients to every material and light parameter and every field of the
camera.

How a step is timed: ``--frames-per-step`` K frames a step (default 32,
bench.py's), frame k traced with seed ``fold(seed0, k)``, as bench.py's
``lax.scan`` does, because sustained rendering pipelines frames. On the
card the step is bench.py's compiled dispatch in the port's form
(``FrameStep``): one frame's step captured once as a CUDA graph
(``utils/graph.py``), its frame seed derived on the device from a static
frame counter, and replayed K times, each replay adding the frame's
colour sum (and gradients) into static sums. One untimed first step
builds and loads the kernels (a kernel builds at its first launch, in the
occupancy probe where the schedule is probed) and captures the graph
("build+first step", with the capture's seconds, nodes and pool
logged); then ``--iters`` steps run between two CUDA events, with one
synchronise after the last, and the time a frame is the elapsed time
over ``iters`` x K. On the CPU the same ``FrameStep`` runs eagerly.
``--bounce-loop``, ``--remat`` and bench.py's compile cache exist only for
XLA and are not copied.

It runs on the card unless ``--device cpu`` asks for the CPU; with no
card it exits with an error and never falls back. A CPU run's metric ends
in `` [cpu]``. ``--scaling`` always runs on gloo CPU ranks
(``run_scaling``): its metric says so.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import torch

from pbr_tpu_torch.app import resolve_device
from pbr_tpu_torch.models.integrator import trace_rays
from pbr_tpu_torch.models.pathtracer import probe_compact_schedule
from pbr_tpu_torch.ops import counts, cuda_bvh, kernel_counts, zero_counts
from pbr_tpu_torch.ops import rng as rng_mod
from pbr_tpu_torch.parallel.mesh import leaf_camera, render_params
from pbr_tpu_torch.scene.build import derive_static_flags
from pbr_tpu_torch.scene.device import camera_to_torch, to_torch
from pbr_tpu_torch.utils.config import RenderSettings
from pbr_tpu_torch.utils.graph import CapturedStep
from pbr_tpu_torch.utils.morton import morton_pixel_ids

# bench.py's target (BASELINE.json): 200M rays/s a chip.
BASELINE_RAYS_S = 200e6
SKY = (0.85, 0.9, 1.0)
SCENES = "cornell | multiroom | soup:N | path/to/model.obj"
INTERSECTORS = ("brute", "gemm", "pallas", "bvh", "pallas_bvh", "pallas_bvh_forest",
                "pallas_bvh_hbm", "cull", "sweep", "gated")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def bench_settings(size: int, **kw) -> RenderSettings:
    """bench.py's main-path settings (bench.py:202-233) at ``size``²;
    ``kw`` overrides any field."""
    base = dict(width=size, height=size, samples=1, max_depth=3, max_added_depth=5,
                shadow_rays=1, anti_aliasing=0.7, sky_light=SKY)
    base.update(kw)
    return RenderSettings(**base)


def load_scene(name: str):
    """bench.py's scenes (bench.py:131-201), built by the port's host layer:
    returns ``(scene, camera, tag, sky_light, shadow_rays)``. ``name``:
    'cornell', 'multiroom', 'soup:N' (``grey_soup(N)``, with a BVH) or an
    .obj path (its .lights companion read; its sky and shadow settings
    taken). Raises FileNotFoundError for any other name, such as bench.py's
    'suzanne', a model this repository does not carry."""
    from pbr_tpu_torch.scene.build import scene_from_text
    from pbr_tpu_torch.scene.camera import make_camera_state
    from pbr_tpu_torch.scene.procedural import cornell_box, grey_soup, multi_room

    sky, shadow = SKY, 1
    if name.startswith("soup:"):
        n = int(name.split(":")[1])
        t0 = time.perf_counter()
        scene, _ = scene_from_text(*grey_soup(n), use_bvh=True)
        log(f"soup:{n}: BVH of {scene.bvh.count} nodes built in "
            f"{time.perf_counter() - t0:.2f}s")
        return scene, make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0)), \
            f"soup{n}", sky, shadow
    if name.endswith(".obj") and os.path.isfile(name):
        from pbr_tpu_torch.io.loader import load_model

        # shadow_rays > 0 reads the .lights companion; a model without one
        # turns it back off (LightParser.cpp:116-121).
        scene, lset, _ = load_model(name, RenderSettings(shadow_rays=1))
        return scene, make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0)), \
            os.path.splitext(os.path.basename(name))[0], lset.sky_light, lset.shadow_rays
    if name == "multiroom":
        scene, _ = scene_from_text(*multi_room(), use_bvh=True)
        return scene, make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0)), \
            "multiroom", sky, shadow
    if name != "cornell":
        raise FileNotFoundError(f"{name!r} ({SCENES})")
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    return scene, make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0)), \
        "cornell", sky, shadow


class Bench(NamedTuple):
    """A scene as the bench traces it: ``scene`` (a ``SceneParams``),
    ``cam`` (a ``CameraState`` of tensors) and ``pixel_ids`` on the device;
    ``settings`` with the schedule in effect; the metric's scene ``tag``."""

    scene: object
    cam: object
    settings: RenderSettings
    pixel_ids: torch.Tensor
    tag: str


def bench_scene(name: str, size: int, device, intersector: Optional[str] = None) -> Bench:
    """bench.py's scene ``name`` at ``size``² on ``device``, with its
    settings (bench.py:202-274): ``derive_static_flags``; its lane-order
    rule (scanline on the Cornell box, Morton on every other scene); the
    occupancy probe's compaction schedule (``probe_compact_schedule``) on
    rows of 128 lanes. ``intersector`` overrides the dispatch."""
    scene, cam, tag, sky, shadow = load_scene(name)
    dev = torch.device(device)
    settings = bench_settings(size, shadow_rays=shadow, sky_light=sky,
                              **({"intersector": intersector} if intersector else {}))
    settings = derive_static_flags(scene, settings)
    ts = to_torch(scene, dev)
    cam_t = camera_to_torch(cam, dev)
    perm = None if tag == "cornell" else morton_pixel_ids(size, size)
    if perm is not None:
        ids = torch.as_tensor(perm, device=dev)
        log("lane order: morton (16x8-pixel blocks)")
    else:
        ids = torch.arange(size * size, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    sched = probe_compact_schedule(ts, cam_t, settings, pixel_ids=perm)
    settings = settings.replace(compact_schedule=sched)
    log(f"probed compaction schedule {sched} in {time.perf_counter() - t0:.1f}s")
    return Bench(ts, cam_t, settings, ids, tag)


def count_rays(b: Bench) -> tuple:
    """bench.py's ray count (bench.py:287-323): ``(path segments, shadow
    rays, drops)`` of frame seed 0, each a Python int; the drops are the
    most lanes compaction cut short over seeds 0-3 (0 where no stage is
    active). Host reads: run it outside any timed window."""
    with torch.no_grad():
        res = trace_rays(b.scene, b.cam, b.settings, b.pixel_ids, 0, with_stats=True)
        n_path, n_shadow = int(res.n_path_rays), int(res.n_shadow_rays)
        drops = [res.n_dropped]
        if b.settings.compact_schedule:
            drops += [trace_rays(b.scene, b.cam, b.settings, b.pixel_ids, s,
                                 with_stats=True).n_dropped for s in (1, 2, 3)]
    return n_path, n_shadow, max(0 if d is None else int(d) for d in drops)


def differentiable(b: Bench) -> Bench:
    """``b`` with every floating parameter of its scene (materials and
    lights) requiring gradients and its camera's fields fresh leaves that
    require them: bench.py's step differentiates all of them."""
    return b._replace(scene=b.scene.requires_grad_(), cam=leaf_camera(b.cam))


def _frame_loss(scene, cam, settings, pixel_ids, seed, weights=None):
    """The sum of a frame's colours, each pixel's weighted by ``weights``
    where given."""
    c = trace_rays(scene, cam, settings, pixel_ids, seed).color
    if weights is None:
        return c.x.sum() + c.y.sum() + c.z.sum()
    return ((c.x + c.y + c.z) * weights).sum()


def step_grads(scene, cam, settings: RenderSettings, pixel_ids, seed0: int, frames: int = 1,
               weights=None) -> tuple:
    """bench.py's backward step (bench.py:350-378) over ``frames`` frames,
    frame k traced with seed ``fold(seed0, k)``: each frame's loss (the sum
    of its colours; ``weights`` weighs each pixel's, for a comparison that
    leaves out pixels whose path flips) differentiated with respect to
    every parameter of ``render_params`` (the scene's materials and
    lights, the camera's fields: make them require gradients first,
    ``differentiable``). Returns ``(loss, {name: gradient})``, each summed
    over the frames; the sums are detached and each frame's graph is
    dropped before the next."""
    params = render_params(scene, cam)
    loss_sum, gsum = 0.0, None
    for k in range(frames):
        loss = _frame_loss(scene, cam, settings, pixel_ids, rng_mod.fold(seed0, k), weights)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
        gsum = grads if gsum is None else [a + g for a, g in zip(gsum, grads)]
        loss_sum = loss_sum + loss.detach()
    return loss_sum, dict(zip(params, gsum))


def step(scene, cam, settings: RenderSettings, pixel_ids, seed0: int, frames: int = 1,
         fwd_only: bool = False):
    """bench.py's step (bench.py:334-378) over ``frames`` frames, frame k
    traced with seed ``fold(seed0, k)``. Forward only: returns the sum of
    the frames' colours. Otherwise it returns what bench.py returns,
    ``(loss, kd.x, rgb.x, eye.x)``: the loss and the gradients of
    ``mat_kd[0]``, ``light_rgb[0]`` and ``cam.eye.x`` of ``step_grads``,
    which differentiates every parameter."""
    if fwd_only:
        with torch.no_grad():
            return sum(_frame_loss(scene, cam, settings, pixel_ids, rng_mod.fold(seed0, k))
                       for k in range(frames))
    loss, g = step_grads(scene, cam, settings, pixel_ids, seed0, frames)
    return loss, g["mat_kd"][0], g["light_rgb"][0], g["cam.eye.x"]


class FrameStep:
    """bench.py's timed step on the card: ``step`` (or, without
    ``fwd_only``, ``step_grads`` without weights) over ``frames`` frames,
    as one frame's step captured once as a CUDA graph and replayed once a
    frame (``utils/graph.py::CapturedStep``; on the CPU the same step runs
    eagerly). Its static tensors: ``seed0`` and the frame counter ``k``,
    from which each replay derives its seed ``fold(seed0, k)`` on the
    device, and the sums each replay adds into: ``loss`` (the colour sum)
    and, for the backward step, ``grads``, one a parameter of
    ``render_params`` (make them require gradients first,
    ``differentiable``).

    ``fs(seed0, frames)`` returns the step's sums, static tensors that the
    next call overwrites: the loss, or ``(loss, {name: gradient})``.
    ``graph`` is the captured step."""

    def __init__(self, b: Bench, fwd_only: bool = False):
        dev = b.pixel_ids.device
        self.b, self.fwd_only = b, fwd_only
        self.params = {} if fwd_only else render_params(b.scene, b.cam)
        self.seed0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        self.grads = [torch.zeros_like(p) for p in self.params.values()]
        self.graph = CapturedStep(self._frame, self.seed0, self.k, self.loss, *self.grads,
                                  name=f"the bench's {'forward' if fwd_only else 'backward'} "
                                       f"step ({b.settings.intersector})")

    def _frame(self, seed0, k, loss, *grads) -> None:
        b = self.b
        seed = rng_mod.fold(seed0, k)
        if self.fwd_only:
            with torch.no_grad():
                loss.add_(_frame_loss(b.scene, b.cam, b.settings, b.pixel_ids, seed))
        else:
            val = _frame_loss(b.scene, b.cam, b.settings, b.pixel_ids, seed)
            got = torch.autograd.grad(val, list(self.params.values()), allow_unused=True)
            for acc, g in zip(grads, got):
                if g is not None:
                    acc.add_(g)
            loss.add_(val.detach())
        k.add_(1)

    def __call__(self, seed0: int, frames: int):
        self.seed0.fill_(int(seed0) & 0xFFFFFFFF)
        for t in (self.k, self.loss, *self.grads):
            t.zero_()
        for _ in range(frames):
            self.graph()
        return self.loss if self.fwd_only else (self.loss, dict(zip(self.params, self.grads)))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run(args) -> dict:
    """The benchmark of ``args`` (``main``'s flags): returns its JSON
    line's object."""
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    log(f"device: {card_line()}" if cuda else "device: cpu")
    size = args.size
    try:
        b = bench_scene(args.scene, size, dev, intersector=args.intersector)
    except FileNotFoundError as e:
        log(f"scene not found: {e}")
        sys.exit(2)
    if b.scene.bvh is not None:
        log(f"BVH leaf bound: {cuda_bvh.leaf_bound(b.scene.bvh)} faces (the tree's own)")
    n_path, n_shadow, n_drop = count_rays(b)
    rays = n_path + n_shadow
    log(f"{size}x{size}: {n_path} path segments + {n_shadow} shadow rays = {rays} rays/frame")
    if b.settings.compact_schedule:
        log(f"compaction drops: {n_drop} lanes")
        if n_drop > 0:
            log("WARNING: capacity overflow — the probed schedule drops live lanes")

    if not args.fwd_only:
        b = differentiable(b)
    k_frames = args.frames_per_step
    fstep = FrameStep(b, args.fwd_only)

    def go(seed0):
        fstep(seed0, k_frames)

    t0 = time.perf_counter()
    go(1)
    if cuda:
        torch.cuda.synchronize()
    log(f"build+first step: {time.perf_counter() - t0:.1f}s ({k_frames} frames a step)")
    if cuda:
        g = fstep.graph
        log(f"CUDA graph of one frame: captured in {g.capture_s:.3f}s, {g.nodes} nodes, "
            f"pool {g.pool_bytes / 2**20:.1f} MiB, the port's kernel nodes (launches a "
            f"replay) {json.dumps(kernel_counts(g.kernels))}")

    zero_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(args.iters):
            go(i + 2)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (args.iters * k_frames)
    else:
        t0 = time.perf_counter()
        for i in range(args.iters):
            go(i + 2)
        ms = (time.perf_counter() - t0) * 1e3 / (args.iters * k_frames)
    launched = {k: v for k, v in counts().items() if v}
    mode = "fwd" if args.fwd_only else "fwd+bwd"
    log(f"launches over {args.iters} timed steps: {json.dumps(launched)}")
    if cuda:
        # A graph's pool is reserved at its capture; what its replays use
        # is held there, not allocated anew.
        log(f"peak memory over the timed steps: "
            f"{torch.cuda.max_memory_reserved() / 2**20:.1f} MiB reserved, of which the "
            f"graph's pool {fstep.graph.pool_bytes / 2**20:.1f} MiB; "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated outside it")
    rays_per_s = rays / (ms / 1e3)
    log(f"{ms:.2f} ms/frame -> {rays_per_s / 1e6:.1f} M rays/s ({mode})")
    return {"metric": f"rays/s/chip ({mode}) 1spp {size}x{size} {b.tag}"
                      + ("" if cuda else " [cpu]"),
            "value": round(rays_per_s, 1), "unit": "rays/s",
            "vs_baseline": round(rays_per_s / BASELINE_RAYS_S, 4)}


# ---- --scaling: pixel sharding over gloo CPU ranks ----------------------------

def _cpu_busy() -> tuple:
    """(busy, total) jiffies of the host's CPUs (/proc/stat: user, nice,
    system, irq and softirq against all)."""
    with open("/proc/stat") as f:
        vals = [int(v) for v in f.readline().split()[1:9]]
    return vals[0] + vals[1] + vals[2] + vals[5] + vals[6], sum(vals)


def _scaling_settings(size: int, height: int) -> RenderSettings:
    """bench.py's --scaling settings (bench.py:451-455)."""
    return bench_settings(size, height=height, max_added_depth=2)


def _scaling_rank(rank: int, size: int, height: int, iters: int, threads: int) -> tuple:
    """One gloo rank of ``run_scaling``: ``sharded_render`` of the Cornell
    box over the world's dp mesh, one warm-up frame, then ``iters`` frames
    between two barriers. Returns (seconds a frame, host CPU share over the
    timed window)."""
    import torch.distributed as dist

    from pbr_tpu_torch.parallel.mesh import make_mesh, sharded_render
    from pbr_tpu_torch.utils.log import Logger

    Logger.stream = sys.stderr
    torch.set_num_threads(threads)
    scene, cam, _, _, _ = load_scene("cornell")
    ts, cam_t = to_torch(scene, "cpu"), camera_to_torch(cam, "cpu")
    settings = _scaling_settings(size, height)
    mesh = make_mesh(n_dp=dist.get_world_size(), n_sp=1)
    sharded_render(mesh, ts, cam_t, settings, 1)
    dist.barrier()
    b0, t0c = _cpu_busy()
    t0 = time.perf_counter()
    for i in range(iters):
        sharded_render(mesh, ts, cam_t, settings, i + 2)
    dist.barrier()
    dt = (time.perf_counter() - t0) / iters
    b1, t1c = _cpu_busy()
    return dt, (b1 - b0) / max(1, t1c - t0c)


def _cores() -> int:
    """The CPU cores this run may use: its affinity, or OMP_NUM_THREADS
    where that is set lower."""
    n = len(os.sched_getaffinity(0))
    omp = os.environ.get("OMP_NUM_THREADS")
    return max(1, min(n, int(omp))) if omp and omp.isdigit() else n


def run_scaling(iters: int = 5, dps=(1, 2, 4, 8), size: int = 256,
                timeout: float = 900.0) -> dict:
    """bench.py's dp-scaling harness (bench.py:414-536) on the port: the
    same sharded render (``parallel/mesh.py::sharded_render``) at each dp
    of ``dps``, one gloo CPU rank a dp index (``parallel/multihost.py::
    spawn_ranks``), the Cornell box at ``size``² (bench.py's 256),
    max_added_depth 2. The ranks share the host's cores: each
    takes cores / dp torch threads, so the total work and the cores are the
    same at every dp, and T1/TN measures what the sharding adds (1.0:
    nothing), not a speed-up. A solo run of one 1/N-sized shard (N the
    largest dp) with a dp=N rank's threads is the contention-free control;
    the host CPU share says whether the cores were saturated. Returns the
    JSON line's object: T1/TN."""
    iters = max(2, iters)
    cores = _cores()
    scene, cam, _, _, _ = load_scene("cornell")
    settings = _scaling_settings(size, size)
    with torch.no_grad():
        res = trace_rays(to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"), settings,
                         torch.arange(size * size, dtype=torch.int32), 0, with_stats=True)
    rays = int(res.n_path_rays) + int(res.n_shadow_rays)
    # By its import path, so that the spawned ranks find it whatever module
    # ran as __main__.
    rank_fn = importlib.import_module("pbr_tpu_torch.bench")._scaling_rank
    from pbr_tpu_torch.parallel.multihost import spawn_ranks

    def timed(world: int, height: int, threads: int) -> tuple:
        with tempfile.TemporaryDirectory() as tmp:
            out = spawn_ranks(rank_fn, world, f"file://{tmp}/rendezvous",
                              args=(size, height, iters, threads), device="cpu",
                              backend="gloo", timeout=timeout)
        return max(dt for dt, _ in out), out[0][1]

    table = {}
    for n_dp in dps:
        dt, util = timed(n_dp, size, max(1, cores // n_dp))
        table[n_dp] = dt
        print(f"[scaling] dp={n_dp}: {dt * 1e3:8.1f} ms/frame  {rays / dt / 1e6:7.2f} M rays/s  "
              f"overhead-eff {table[dps[0]] / dt:.2f}  host-cpu {util:5.1%}  "
              f"({max(1, cores // n_dp)} threads a rank)", file=sys.stderr, flush=True)
    top = max(dps)
    shard_h = size // top
    solo, _ = timed(1, shard_h, max(1, cores // top))
    print(f"[scaling] solo 1/{top} shard ({size}x{shard_h}): {solo * 1e3:8.1f} ms/frame -> "
          f"ideal-overlap T{top} {solo * 1e3:8.1f} ms vs measured {table[top] * 1e3:8.1f} ms "
          f"(x{table[top] / solo:.2f})", file=sys.stderr, flush=True)
    eff = table[dps[0]] / table[top]
    return {"metric": f"dp-sharding overhead efficiency T{dps[0]}/T{top} (gloo CPU ranks, "
                      f"{size}x{size})",
            "value": round(eff, 4), "unit": "ratio", "vs_baseline": round(eff / 0.85, 4)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m pbr_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--fwd-only", action="store_true", dest="fwd_only")
    ap.add_argument("--iters", type=int, default=10, help="timed steps")
    ap.add_argument("--frames-per-step", type=int, default=32, dest="frames_per_step",
                    help="frames a timed step (bench.py's 32; on the card one frame's CUDA "
                    "graph replayed this many times)")
    ap.add_argument("--scene", default="cornell", help=SCENES)
    ap.add_argument("--intersector", default=None, choices=INTERSECTORS,
                    help="override the intersector dispatch (default: auto); 'brute' is "
                    "the plain sweep, for the CPU only")
    ap.add_argument("--scaling", action="store_true",
                    help="dp-scaling harness on gloo CPU ranks at dp 1/2/4/8, 256x256 "
                    "(sharding overhead, not a card's speed-up; ignores --device and --size)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.frames_per_step < 1:
        ap.error("--frames-per-step must be at least 1")

    from pbr_tpu_torch.utils.log import Logger

    saved, Logger.stream = Logger.stream, sys.stderr  # stdout carries only the JSON line
    try:
        out = run_scaling(args.iters) if args.scaling else run(args)
    finally:
        Logger.stream = saved
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
