#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pbr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one frame

Run from the root of a checkout. It builds kernel K1 from the checkout's
sources, then drives the port's main path — the procedural Cornell box at
1024², one sample per pixel, 8 bounces, NEE, Shirley-Ashikhmin, compaction
from the occupancy probe — through ``PathTracer(...).render(...)``:

1. device: a CUDA card of compute capability 9.0, its name and power limit;
2. build: K1 with nvcc, timed;
3. K1 against its plain PyTorch version on the card, bitwise (t, face,
   occluded), nearest and NEE, on the main path's camera rays, on a ragged
   random batch and on a 4,000-face soup; faces also against the plain
   sweep on the host's CPU;
4. a 128² frame on the card, with the probed compaction schedule and lane
   order, against the same frame rendered by the port on the CPU with
   neither: no NaN and at least 99% of pixels within 1e-3 (the CPU path is
   held to the JAX package's NumPy oracle by tests/test_torch_render.py);
5. the full-size frame: its first frame, compacted, must equal bitwise the
   same frame traced at full width in the same lane order; then 8 timed
   progressive frames after 2 warm-up frames, in which K1 must launch
   exactly 8 times a frame, no lane may be dropped by compaction, and the
   image must be finite with a plausible mean.

Every failure raises, so the exit code is not 0. The last two lines of
standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. The script needs no JAX: any import of
it fails (``sys.modules['jax'] = None``). Of the JAX package it imports only
the NumPy host layer (scene building, camera, config).
"""

import sys

sys.modules["jax"] = None  # the port must run where JAX is absent

import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pbr_tpu.scene.build import scene_from_text  # noqa: E402
from pbr_tpu.scene.camera import make_camera_state  # noqa: E402
from pbr_tpu.scene.procedural import cornell_box, random_soup  # noqa: E402
from pbr_tpu.utils.config import RenderSettings  # noqa: E402
from pbr_tpu_torch import PathTracer, camera_to_torch, to_torch, trace_rays  # noqa: E402
from pbr_tpu_torch.models.integrator import _gen_rays  # noqa: E402
from pbr_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from pbr_tpu_torch.ops.rng import PixelRng  # noqa: E402
from pbr_tpu_torch.ops.vec import Vec3  # noqa: E402

SIZE = 1024
WARMUP, FRAMES = 2, 8
K1_SOURCE = "pbr_tpu_torch/csrc/brute_intersect.cu"
K1_REPLACES = "pbr_tpu/ops/pallas_intersect.py:182"


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bench_settings(size: int, **kw) -> RenderSettings:
    """bench.py's main-path settings (bench.py:202-233) at ``size``²."""
    base = dict(width=size, height=size, samples=1, max_depth=3, max_added_depth=5,
                shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0))
    base.update(kw)
    return RenderSettings(**base)


def cornell():
    scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    return scene, cam


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}, capability {cap}, torch "
                    f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def build_phase() -> None:
    t0 = time.perf_counter()
    path = ci.build()
    phase("build", f"K1 built in {time.perf_counter() - t0:.3f} s -> {path.name}")


def _rays_in_box(n: int, seed: int, dev) -> tuple:
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.8, 0.8, (3, n)).astype(np.float32)
    o[1] += 1.0
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return Vec3(*(torch.tensor(c, device=dev) for c in o)), Vec3(*(torch.tensor(c, device=dev) for c in d))


def _camera_rays(cam_t, settings: RenderSettings, dev) -> tuple:
    """The main path's first-bounce rays: all pixels of frame 0."""
    ids = torch.arange(settings.width * settings.height, dtype=torch.int32, device=dev)
    px = (ids % settings.width).to(torch.float32)
    py = (ids // settings.width).to(torch.float32)
    prev_t = torch.full(px.shape, float("inf"), device=dev)
    return _gen_rays(cam_t, settings, px, py, PixelRng(0, ids), 0, prev_t)


def kernel_phase(scene, cam, dev) -> dict:
    """K1 against its plain version, bitwise; returns the largest |t| error
    and the main-path-shape rays for timing."""
    ts = to_torch(scene, dev)
    light = torch.stack([ts.lights.pos.x[0], ts.lights.pos.y[0], ts.lights.pos.z[0]])
    l0 = Vec3(*light)
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), bench_settings(SIZE), dev)
    soup, _ = scene_from_text(random_soup(4000), use_bvh=False)
    cases = [
        ("cornell camera rays", ts.tris, cam_o, cam_d),
        ("cornell random rays", ts.tris, *_rays_in_box(1_000_003, 1, dev)),
        ("soup:4000", to_torch(soup, dev).tris, *_rays_in_box(65_536, 2, dev)),
    ]
    max_err = 0.0
    for name, tris, o, d in cases:
        t, f, occ = ci.intersect_fused(o, d, tris, light_pos=l0)
        t1, f1 = ci.intersect_fused(o, d, tris)
        tp, fp, op = ci.intersect_fused_plain(o, d, ci.face_table(tris), light)
        torch.cuda.synchronize()
        mism = {
            "t": int((t != tp).sum()), "face": int((f != fp).sum()),
            "occluded": int((occ != op).sum()),
            "t (nearest-only)": int((t1 != tp).sum()), "face (nearest-only)": int((f1 != fp).sum()),
        }
        fin = torch.isfinite(tp)
        if not torch.equal(torch.isfinite(t), fin):
            raise AssertionError(f"{name}: kernel and plain disagree on which rays hit")
        if fin.any():
            max_err = max(max_err, float((t[fin] - tp[fin]).abs().max()))
        phase("kernel", f"{name}: {o.x.shape[0]} rays x {tris.mtl.shape[0]} faces, "
                        f"{int((f >= 0).sum())} hits, {int(occ.sum())} occluded; mismatches {mism}")
        if any(mism.values()):
            raise AssertionError(f"{name}: K1 differs from its plain version: {mism}")
    # Faces against the plain sweep on the host's CPU, on a subset of camera
    # rays (CPU tensors take the plain version and launch nothing).
    sub = slice(0, 1 << 16)
    o_s = Vec3(*(c[sub].contiguous() for c in cam_o))
    d_s = Vec3(*(c[sub].contiguous() for c in cam_d))
    t_h, f_h = ci.intersect_fused(Vec3(*(c.cpu() for c in o_s)), Vec3(*(c.cpu() for c in d_s)),
                                  to_torch(scene, "cpu").tris)
    t_k, f_k = ci.intersect_fused(o_s, d_s, ts.tris)
    n_bad = int((f_k.cpu() != f_h).sum())
    n_t = int((t_k.cpu() != t_h).sum())
    phase("kernel", f"vs the plain sweep on the CPU, {f_h.numel()} camera rays: "
                    f"{n_bad} face mismatches, {n_t} t mismatches")
    if n_bad:
        raise AssertionError("K1 faces differ from the plain sweep on the CPU")
    return {"max_abs_err": max_err, "tris": ts.tris, "o": cam_o, "d": cam_d, "light": l0}


def oracle_phase(scene, cam, dev) -> None:
    """The card's path (K1, probed schedule and lane order, compaction on
    the device) against the CPU's (plain sweep, full width, scanline)."""
    pt = PathTracer(scene, bench_settings(128, compact_schedule="auto"), device=dev)
    pt.render(cam, frame_seed=5)
    got = pt.image()
    host = PathTracer(scene, bench_settings(128), device="cpu", lane_order="scanline")
    host.render(cam, frame_seed=5)
    ref = host.image()
    if np.isnan(got).any():
        raise AssertionError("NaN in the 128² frame")
    d = np.abs(got - ref).max(axis=-1)
    within = float((d <= 1e-3).mean())
    phase("oracle", f"128² frame ({pt.lane_order}, schedule {pt.settings.compact_schedule}) "
                    f"vs the CPU path: {within:.4%} of pixels within 1e-3, "
                    f"max |diff| {d.max():.3g}, means {got.mean():.6f} / {ref.mean():.6f}")
    if within < 0.99:
        raise AssertionError(f"only {within:.4%} of pixels within 1e-3 of the oracle")


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def full_size_phase(scene, cam, dev, k1: dict, profile: bool) -> dict:
    settings = bench_settings(SIZE, compact_schedule="auto")
    pt = PathTracer(scene, settings, device=dev)
    pt.render(cam, frame_seed=0)
    phase("full", f"lane order {pt.lane_order}, compaction schedule "
                  f"{pt.settings.compact_schedule}")
    # Compaction only permutes lanes: the first frame equals, bitwise, the
    # same frame traced at full width in the same lane order.
    wide = PathTracer(scene, bench_settings(SIZE), device=dev, lane_order=pt.lane_order)
    wide.render(cam, frame_seed=0)
    n_diff = int((pt.image() != wide.image()).any(axis=-1).sum())
    phase("full", f"first frame compacted vs full width: {n_diff} pixels differ")
    if n_diff:
        raise AssertionError(f"compaction changed {n_diff} pixels of the first frame")
    del wide
    for i in range(1, WARMUP):
        pt.render(cam, frame_seed=i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ci.launches = 0
    start.record()
    for i in range(WARMUP, WARMUP + FRAMES):
        pt.render(cam, frame_seed=i)
    end.record()
    end.synchronize()
    launches = ci.launches
    ms_frame = start.elapsed_time(end) / FRAMES
    peak = torch.cuda.max_memory_allocated()
    expect = FRAMES * pt.settings.max_total_depth * pt.settings.samples
    phase("full", f"K1 launches over {FRAMES} frames: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"K1 launched {launches} times, expected {expect}")

    img = pt.image()
    mean = float(img.mean())
    phase("full", f"image {img.shape}, finite {bool(np.isfinite(img).all())}, mean {mean:.6f}")
    if not np.isfinite(img).all() or not 1.0 < mean < 5.0:
        raise AssertionError(f"implausible image: mean {mean}")

    # Rays per frame from the counters (path segments + shadow rays, as
    # bench.py counts them), and the compaction drop count.
    res = trace_rays(pt.scene, camera_to_torch(cam, dev), pt.settings, pt.pixel_ids, 0,
                     with_stats=True)
    n_path, n_shadow = int(res.n_path_rays), int(res.n_shadow_rays)
    n_drop = int(res.n_dropped) if res.n_dropped is not None else 0
    rays = n_path + n_shadow
    phase("full", f"{n_path} path segments + {n_shadow} shadow rays = {rays} rays/frame; "
                  f"{n_drop} lanes dropped by compaction")
    if n_drop:
        raise AssertionError(f"compaction dropped {n_drop} live lanes")

    t, o, d, light = k1["tris"], k1["o"], k1["d"], k1["light"]
    table = ci.face_table(t)
    light3 = torch.stack(list(light))
    k1_ms = _time_ms(lambda: ci.intersect_fused(o, d, t, light_pos=light), 20)
    plain_ms = _time_ms(lambda: ci.intersect_fused_plain(o, d, table, light3), 5)
    k1n_ms = _time_ms(lambda: ci.intersect_fused(o, d, t), 20)
    plainn_ms = _time_ms(lambda: ci.intersect_fused_plain(o, d, table), 5)
    phase("full", f"{ms_frame:.3f} ms/frame, {rays / ms_frame / 1e3:.3f} M rays/s forward, "
                  f"peak memory {peak / 2**20:.1f} MiB")
    phase("full", f"K1 per call at the main-path shape ({o.x.shape[0]} rays, NEE): "
                  f"{k1_ms:.4f} ms; plain version {plain_ms:.4f} ms")
    phase("full", f"K1 nearest-only instance, same rays: {k1n_ms:.4f} ms; "
                  f"plain version {plainn_ms:.4f} ms")
    if profile:
        profile_phase(pt, cam)
    return {"launches": launches, "ms": k1_ms, "plain_ms": plain_ms}


def profile_phase(pt: PathTracer, cam) -> None:
    """Device time by kernel over one frame (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pt.render(cam, frame_seed=99)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_time_total > 0]
    total = sum(r[1] for r in rows)
    k1 = sum(r[1] for r in rows if "brute_intersect" in r[0])
    phase("profile", f"device time over one frame: {total / 1e3:.3f} ms in "
                     f"{sum(r[2] for r in rows)} kernel launches; K1 {k1 / 1e3:.3f} ms")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        phase("profile", f"{us / 1e3:9.3f} ms {count:6d}x {key[:90]}")


def main() -> None:
    profile = "--profile" in sys.argv[1:]
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    scene, cam = cornell()
    k1 = kernel_phase(scene, cam, dev)
    oracle_phase(scene, cam, dev)
    full = full_size_phase(scene, cam, dev, k1, profile)
    phase("done", f"all phases passed on {smi}")
    print(json.dumps({"kernels": [{
        "name": "brute_intersect (K1)", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": full["launches"],
        "max_abs_err": k1["max_abs_err"], "ms": full["ms"], "plain_ms": full["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
