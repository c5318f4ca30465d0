"""Command-line renderer of the port: the counterpart of ``pbr_tpu/app.py``
(the headless form of the reference's Qt app: load config, import model,
run the progressive render loop, display). Frames accumulate on the device
and are written as PNG.

Every command runs on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the CPU; with no card and no ``--device cpu`` it
stops with an error and never falls back to the CPU.

Usage examples:
    python -m pbr_tpu_torch.app render --scene cornell --frames 64 --out out.png
    python -m pbr_tpu_torch.app render --scene model.obj --config config.json \\
        --frames 16 --out out.png --stats --heatmap heat.png
    python -m pbr_tpu_torch.app render --scene cornell --checkpoint ckpt/ --frames 8
    python -m pbr_tpu_torch.app fit --scene cornell --steps 60 --out fit.png
    python -m pbr_tpu_torch.app view --scene cornell --device cpu --size 64

``main(argv)`` returns what the command returns (a summary dict for
``render`` and ``fit``, the ``Viewer`` for ``view``), so a script can drive
the CLI in-process.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

# The frame seed of fit's target and of every loss evaluation.
FIT_SEED = 5


def resolve_device(name: str) -> torch.device:
    """The device a command runs on; raises where it asks for a card and
    there is none (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "pbr_tpu_torch: no CUDA device (torch.cuda.is_available() is False); "
            "pass --device cpu to run on the CPU"
        )
    return dev


def _load_scene(spec: str, settings, bvh_cfg=None):
    """Scene from a spec: an .obj path or a procedural name
    (cornell | triangle | multiroom | soup:N)."""
    from pbr_tpu_torch.io.lights import parse_lights
    from pbr_tpu_torch.io.mtl import parse_mtl
    from pbr_tpu_torch.io.obj import parse_obj
    from pbr_tpu_torch.scene.build import apply_scene_constants, build_scene
    from pbr_tpu_torch.scene.procedural import (
        cornell_box,
        multi_room,
        random_soup,
        single_triangle,
    )
    from pbr_tpu_torch.utils.config import ACCEL_BVH

    use_bvh = settings.accel_struct == ACCEL_BVH
    if spec.endswith(".obj"):
        from pbr_tpu_torch.io.loader import load_model

        scene, settings, _ = load_model(spec, settings, bvh_cfg)
        return scene, settings
    if spec == "cornell":
        obj, mtl, li = cornell_box()
    elif spec == "triangle":
        obj, mtl, li = single_triangle()
    elif spec == "multiroom":
        obj, mtl, li = multi_room()
        use_bvh = True
    elif spec.startswith("soup:"):
        obj, mtl, li = random_soup(int(spec.split(":")[1])), "", ""
    else:
        raise SystemExit(f"unknown scene spec: {spec}")
    objd = parse_obj(obj, mtl=parse_mtl(mtl) if mtl else None,
                     lights=parse_lights(li) if li else [])
    scene = build_scene(objd, bvh_cfg=bvh_cfg, use_bvh=use_bvh,
                        phong_tess_alpha=settings.phong_tessellation)
    return scene, apply_scene_constants(settings, objd)


def _parse_vec3(s: str):
    v = tuple(float(c) for c in s.replace(",", " ").split())
    if len(v) != 3:
        raise SystemExit(f"expected 3 comma-separated floats, got {s!r}")
    return v


def _camera_config(args, cfg_camera, scene_spec: str):
    """The camera config with the CLI's overrides: ``--eye``/``--center``,
    and the Cornell eye (0, 1, 3.2) for --scene cornell without --eye."""
    cam_cfg = cfg_camera
    if getattr(args, "eye", None):
        cam_cfg = dataclasses.replace(cam_cfg, eye=_parse_vec3(args.eye))
    elif scene_spec == "cornell":
        cam_cfg = dataclasses.replace(cam_cfg, eye=(0.0, 1.0, 3.2))
    if getattr(args, "center", None):
        cam_cfg = dataclasses.replace(cam_cfg, center=_parse_vec3(args.center))
    return cam_cfg


def _camera_for(args, cfg_camera, scene_spec: str):
    """The interactive ``Camera`` from config + CLI overrides."""
    from pbr_tpu_torch.scene.camera import Camera

    return Camera(_camera_config(args, cfg_camera, scene_spec))


def apply_tuning_flags(settings, args):
    """``--compact``: 'auto' (the default) routes through the occupancy
    probe (models/pathtracer.py::probe_compact_schedule), 'off' disables
    compaction, 'bounce:frac[,...]' pins a schedule."""
    compact = getattr(args, "compact", "auto")
    if compact in ("off", "none"):
        return settings.replace(compact_schedule=())
    if compact == "auto":
        return settings.replace(compact_schedule="auto")
    return settings.replace(compact_schedule=tuple(
        (int(p.split(":")[0]), float(p.split(":")[1])) for p in compact.split(",")))


def _render_settings(args, cfg):
    """The render settings of ``render`` and ``view`` before the scene's
    constants: the config's, at ``--size``² (and ``--spp``), with NEE on
    for the Cornell box."""
    settings = cfg.render
    if args.size:
        settings = settings.replace(width=args.size, height=args.size)
    if getattr(args, "spp", None) is not None:
        settings = settings.replace(samples=args.spp)
    if args.scene == "cornell":
        settings = settings.replace(shadow_rays=1)
    return settings


def _denoised(pt, cam_t, img: np.ndarray, dev) -> np.ndarray:
    """``img`` (PathTracer.image(): top row first) through the feature-guided
    filter, its features from one primary-hit pass on ``dev``."""
    from pbr_tpu_torch.ops.denoise import first_hit_features, noise_filter

    feats = first_hit_features(pt.scene, cam_t, pt.settings, max_leaf=pt.max_leaf)
    # The features are in pixel-row order (row 0 is the camera's bottom
    # row); the image puts the top row first.
    feats = [f.flip(0) for f in feats]
    color = torch.as_tensor(np.ascontiguousarray(img), device=dev)
    return noise_filter(color, *feats).cpu().numpy()


def cmd_render(args) -> dict:
    """Progressive render to PNG. Returns ``{"tracer", "timers", "ms_frame",
    "image"}``: the PathTracer, the stage timer, the steady-state ms a
    frame (host clock, the device synchronised) and the image written."""
    from pbr_tpu_torch.models.pathtracer import PathTracer
    from pbr_tpu_torch.scene.device import camera_to_torch
    from pbr_tpu_torch.utils import checkpoint as ckpt_mod
    from pbr_tpu_torch.utils.config import load_config
    from pbr_tpu_torch.utils.image import save_render
    from pbr_tpu_torch.utils.log import Logger, Timer
    from pbr_tpu_torch.utils.profiling import StageTimer

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    Logger.set_level(cfg.logging_level)
    settings = _render_settings(args, cfg)

    timers = StageTimer()
    with timers.span("scene build"):
        scene, settings = _load_scene(args.scene, settings, cfg.bvh)
    settings = apply_tuning_flags(settings, args)
    cam = _camera_for(args, cfg.camera, args.scene).state()

    with timers.span("tracer init", sync=dev):
        pt = PathTracer(scene, settings, device=dev, lane_order=args.lane_order)

    start_frame = 0
    if args.checkpoint and os.path.exists(os.path.join(args.checkpoint, "meta.json")):
        with timers.span("restore", sync=dev):
            pt.state, meta = ckpt_mod.restore(args.checkpoint, pt.state)
            start_frame = int(meta.get("frames", pt.sample_count))
        Logger.info(f"[app] Resumed at frame {start_frame}.")

    # The first frame runs the occupancy probes (lane order, compaction).
    with timers.span("probe+first frame", sync=dev):
        pt.render(cam, frame_seed=start_frame)

    t = Timer()
    with timers.span(f"{max(args.frames - 1, 0)} frames", sync=dev):
        for i in range(start_frame + 1, start_frame + args.frames):
            pt.render(cam, frame_seed=i)
    n_done = max(args.frames - 1, 1)
    ms_frame = t.s() / n_done * 1e3
    Logger.info(
        f"[app] {args.frames} frames at {settings.width}x{settings.height} "
        f"({ms_frame:.2f} ms/frame steady-state); {pt.sample_count} samples accumulated."
    )

    if args.checkpoint:
        with timers.span("checkpoint"):
            ckpt_mod.save(args.checkpoint, pt.state, meta={"frames": start_frame + args.frames})

    img = None
    if args.out:
        img = pt.image()
        if args.denoise:
            with timers.span("denoise", sync=dev):
                img = _denoised(pt, camera_to_torch(cam, dev), img, dev)
        if args.bvh_overlay or args.lights_overlay:
            from pbr_tpu_torch.accel.visualize import overlay_bvh, overlay_lights

            img = np.clip(img * args.exposure, 0.0, 1.0)
            if args.bvh_overlay and scene.bvh is not None:
                img = overlay_bvh(img, scene, cam)
            if args.lights_overlay and scene.lights.count:
                img = overlay_lights(img, scene, cam)
            with timers.span("write png"):
                save_render(args.out, img, exposure=1.0)
        else:
            with timers.span("write png"):
                save_render(args.out, img, exposure=args.exposure)
        Logger.info(f"[app] Wrote {args.out}")
    if args.depth_out:
        from pbr_tpu_torch.utils.image import tonemap, write_png

        depth = pt.depth_image()
        finite = np.isfinite(depth)
        scale = depth[finite].max() if finite.any() else 1.0
        write_png(args.depth_out, tonemap(np.repeat(
            (np.where(finite, depth, scale) / max(scale, 1e-9))[..., None], 3, axis=-1
        )))
        Logger.info(f"[app] Wrote {args.depth_out}")
    if args.heatmap:
        # Full width (no compaction): the work counters are exact per
        # pixel and nothing can drop.
        with timers.span("heatmap", sync=dev):
            _write_heatmap(args.heatmap, pt, camera_to_torch(cam, dev),
                           pt.settings.replace(compact_schedule=()))
    if args.stats:
        print(timers.table())
    return {"tracer": pt, "timers": timers, "ms_frame": ms_frame, "image": img}


def _write_heatmap(path: str, pt, cam_t, settings) -> None:
    """Per-pixel work heatmap — the debug image of the reference
    (writeDebugImage, pathtracing.cl:73-78; the counters come from the
    per-ray ``uint debugCounter`` incremented per intersection test,
    pt_bvh.cl:23,89), from ``trace_rays(..., with_stats=True)`` on the
    tracer's scene.

    Three channels, each normalised to its own max:
      R = ray-face intersection tests executed for the pixel's paths (the
          counts ``ops/traverse.py::intersect_scene`` gives: exact on the
          gated sweep and the BVH walk, F a pass on the full sweeps, 0 on
          the modes that count nothing),
      G = live bounces (path length),
      B = BVH node visits (0 where no nodes are visited or counted).
    """
    from pbr_tpu_torch.models.integrator import trace_rays
    from pbr_tpu_torch.utils.image import tonemap, write_png
    from pbr_tpu_torch.utils.log import Logger

    npx = settings.width * settings.height
    ids = torch.arange(npx, dtype=torch.int32, device=pt.device)
    res = trace_rays(pt.scene, cam_t, settings, ids, 0, with_stats=True, max_leaf=pt.max_leaf)

    def chan(a):
        img = a.to(torch.float32).cpu().numpy().reshape(settings.height, settings.width)[::-1]
        return img / max(float(img.max()), 1.0)

    rgb = np.repeat(chan(res.heat_bounces)[..., None], 3, axis=-1)
    rgb[..., 0] = chan(res.heat_tests)
    rgb[..., 2] = chan(res.heat_visits)
    write_png(path, tonemap(rgb, gamma=1.0))
    Logger.info(f"[app] Wrote {path}")


class FitProblem(NamedTuple):
    """The fit's fixed parts on one device: the scene's tensors ``ts``
    (the variable is ``ts.mat_kd``), the camera, the settings, the pixel
    ids, the BVH leaf bound and the target colours (the scene's own albedos
    rendered with frame seed ``FIT_SEED``)."""

    ts: object
    cam: object
    settings: object
    ids: torch.Tensor
    max_leaf: int
    target: object = None

    def colors(self):
        """(B,) colours of the frame of seed ``FIT_SEED`` at ``ts.mat_kd``."""
        from pbr_tpu_torch.models.integrator import trace_rays

        return trace_rays(self.ts, self.cam, self.settings, self.ids, FIT_SEED,
                          max_leaf=self.max_leaf).color

    def loss(self) -> torch.Tensor:
        """The squared colour error against ``target``, summed over the
        channels, over the pixel count."""
        c, t = self.colors(), self.target
        return (((c.x - t.x) ** 2).sum() + ((c.y - t.y) ** 2).sum()
                + ((c.z - t.z) ** 2).sum()) / self.ids.shape[0]


def fit_problem(scene, settings, cam, dev) -> FitProblem:
    """The ``FitProblem`` of a NumPy scene and camera on ``dev``."""
    from pbr_tpu_torch.scene.build import bvh_max_leaf
    from pbr_tpu_torch.scene.device import camera_to_torch, to_torch

    ids = torch.arange(settings.width * settings.height, dtype=torch.int32, device=dev)
    prob = FitProblem(to_torch(scene, dev), camera_to_torch(cam, dev), settings, ids,
                      bvh_max_leaf(scene))
    with torch.no_grad():
        return prob._replace(target=prob.colors())


def fit_steps(prob: FitProblem) -> tuple:
    """The fit's two steps, ``(value_and_grad, loss_at)``, each a
    ``utils/graph.py::CapturedStep`` whose static input is the variable
    ``prob.ts.mat_kd``: captured once as a CUDA graph on the card (the JAX
    CLI's jitted ``value_and_grad`` and loss), eager on the CPU.
    ``value_and_grad(kd)`` copies ``kd`` into the variable and returns the
    loss as a float and its gradient in kd (a static tensor that the next
    call overwrites); ``loss_at(kd)`` returns the loss alone, as a float,
    under ``torch.no_grad()``."""
    from pbr_tpu_torch.utils.graph import CapturedStep

    param = prob.ts.mat_kd

    def vg(kd):
        param.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = prob.loss()
                (g,) = torch.autograd.grad(loss, param)
        finally:
            param.requires_grad_(False)
        return loss.detach(), g

    def lo(kd):
        with torch.no_grad():
            return prob.loss()

    vg_step = CapturedStep(vg, param, name="fit's value_and_grad")
    loss_step = CapturedStep(lo, param, name="fit's loss")

    def value_and_grad(kd):
        loss, g = vg_step(kd)
        return float(loss), g

    def loss_at(kd):
        return float(loss_step(kd))

    return value_and_grad, loss_at


def cmd_fit(args) -> dict:
    """Inverse-rendering demo: perturb the albedos' red channel, recover it
    by gradient descent on ``materials.kd`` against the original render.

    Each step takes the loss and its gradient under ``torch.autograd``,
    then a backtracking line search (loss evaluations under
    ``torch.no_grad()``) halves the step until the loss does not rise;
    both are ``fit_steps``, CUDA graphs on the card. A
    search that runs out (step at most 1e-6) keeps the current albedos: no
    accepted step raises the loss. Returns ``{"losses", "final_loss",
    "kd_err", "ms_step", "accepted", "kd", "settings"}``: the loss at the
    start of each step, the loss at the final albedos, the largest
    red-albedo error, the ms a step (host clock, the device synchronised),
    which steps moved the albedos, the final albedos (3, M) and the
    frames' settings."""
    from pbr_tpu_torch.utils.config import load_config
    from pbr_tpu_torch.utils.image import save_render
    from pbr_tpu_torch.utils.log import Logger, Timer
    from pbr_tpu_torch.utils.profiling import synchronize

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    settings = cfg.render.replace(
        width=args.size or 64, height=args.size or 64, shadow_rays=1, brdf=0,
        max_depth=2, max_added_depth=0,
    )
    scene, settings = _load_scene(args.scene, settings, cfg.bvh)
    cam = _camera_for(args, cfg.camera, args.scene).state()
    prob = fit_problem(scene, settings, cam, dev)
    param = prob.ts.mat_kd  # (3, M): the variable of the fit
    value_and_grad, loss_at = fit_steps(prob)

    kd0 = param.detach().clone()
    rng = np.random.RandomState(0)
    noise = torch.tensor(rng.uniform(-0.3, 0.3, kd0.shape[1]), dtype=torch.float32, device=dev)
    kd = kd0.clone()
    kd[0] = torch.clamp(kd0[0] + noise, 0.0, 1.0)
    losses, accepted = [], []
    lr = args.lr
    t = Timer()
    for i in range(args.steps):
        loss, g = value_and_grad(kd)
        losses.append(loss)
        # Backtracking line search: per-scene gradient magnitudes vary by
        # orders of magnitude (the sum-loss grows with resolution), and a
        # fixed lr either crawls or saturates the albedos at the clip
        # bounds. Halve until the step does not raise the loss; grow
        # gently on acceptance so the fit adapts both ways.
        step = None
        while lr > 1e-6:
            cand = torch.clamp(kd - lr * g, 0.0, 1.0)
            if loss_at(cand) <= loss:
                step = cand
                break
            lr *= 0.5
        accepted.append(step is not None)
        if step is not None:
            kd = step
        lr = min(lr * 1.3, 1.0)
        if i % 10 == 0:
            Logger.info(f"[fit] step {i}: loss {loss:.6f} (lr {lr:.2e})")
    synchronize(dev)
    ms_step = t.ms() / max(args.steps, 1)
    final = loss_at(kd)
    err = float((kd[0] - kd0[0]).abs().max())
    first = losses[0] if losses else final
    Logger.info(f"[fit] loss {first:.6f} -> {final:.6f}; max albedo error {err:.4f}; "
                f"{ms_step:.2f} ms/step")
    if args.out:
        with torch.no_grad():
            param.copy_(kd)
            rgb = prob.colors().stack().cpu().numpy()
        save_render(args.out, rgb.reshape(settings.height, settings.width, 3)[::-1],
                    exposure=args.exposure)
        Logger.info(f"[fit] Wrote {args.out}")
    return {"losses": losses, "final_loss": final, "kd_err": err, "ms_step": ms_step,
            "accepted": accepted, "kd": kd, "settings": settings}


def cmd_view(args):
    """Interactive progressive viewer (Window/GLWidget analog, viewer.py).
    Returns the ``Viewer``."""
    import shutil

    from pbr_tpu_torch.utils.config import load_config
    from pbr_tpu_torch.utils.log import Logger
    from pbr_tpu_torch.viewer import Viewer

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    Logger.set_level(cfg.logging_level)
    scene, settings = _load_scene(args.scene, _render_settings(args, cfg), cfg.bvh)
    settings = apply_tuning_flags(settings, args)
    size = shutil.get_terminal_size((80, 24))
    viewer = Viewer(
        scene, settings, _camera_config(args, cfg.camera, args.scene),
        exposure=args.exposure, term_cols=size.columns, term_rows=size.lines,
        lane_order=args.lane_order, device=dev,
    )
    viewer.run(max_frames=args.frames, keys=args.keys, draw=not args.no_draw,
               target_fps=args.fps)
    if args.startup_json:
        viewer.write_startup_breakdown(args.startup_json)
    return viewer


def _common(p, scene_help: str) -> None:
    """Flags every command takes."""
    p.add_argument("--scene", default="cornell", help=scene_help)
    p.add_argument("--config", default=None, help="config.json (reference key layout)")
    p.add_argument("--eye", default=None, help="camera eye 'x,y,z' (overrides config)")
    p.add_argument("--center", default=None, help="camera view direction 'x,y,z'")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; 'cpu' runs the plain versions)")


def _tuning(p) -> None:
    p.add_argument("--lane-order", default="auto", dest="lane_order",
                   choices=["auto", "scanline", "morton"],
                   help="pixel->lane mapping (auto = per-scene dual probe)")
    p.add_argument("--compact", default="auto",
                   help="'auto' (occupancy probe, default), 'off', or "
                   "bounce:frac[,bounce:frac...]")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbr_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    scenes = ".obj path or cornell|triangle|multiroom|soup:N"

    r = sub.add_parser("render", help="progressive render to PNG")
    _common(r, scenes)
    _tuning(r)
    r.add_argument("--frames", type=int, default=16)
    r.add_argument("--size", type=int, default=256)
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--out", default="render.png")
    r.add_argument("--depth-out", default=None)
    r.add_argument("--heatmap", default=None)
    r.add_argument("--bvh-overlay", action="store_true", dest="bvh_overlay",
                   help="draw BVH leaf wireframes (View menu toggle analog)")
    r.add_argument("--lights-overlay", action="store_true", dest="lights_overlay",
                   help="draw light-position boxes")
    r.add_argument("--exposure", type=float, default=0.4)
    r.add_argument("--denoise", action="store_true",
                   help="feature-guided a-trous noise filter on the output "
                        "(the reference's unfinished noise_filtering.cl, completed)")
    r.add_argument("--checkpoint", default=None, help="checkpoint directory (npz)")
    r.add_argument("--stats", action="store_true")
    r.set_defaults(fn=cmd_render)

    v = sub.add_parser("view",
                       help="interactive terminal viewer (the reference's Qt window analog)")
    _common(v, scenes)
    _tuning(v)
    v.add_argument("--size", type=int, default=256)
    v.add_argument("--frames", type=int, default=None, help="stop after N frames")
    v.add_argument("--keys", default=None, help="scripted keys, one per frame (CI)")
    v.add_argument("--fps", type=float, default=30.0)
    v.add_argument("--exposure", type=float, default=2.5)
    v.add_argument("--no-draw", action="store_true", dest="no_draw")
    v.add_argument("--startup-json", default=None, dest="startup_json",
                   help="write the startup-stage wall-time breakdown JSON")
    v.set_defaults(fn=cmd_view)

    f = sub.add_parser("fit", help="inverse-rendering demo")
    _common(f, scenes)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--size", type=int, default=64)
    f.add_argument("--lr", type=float, default=0.01)
    f.add_argument("--out", default=None)
    f.add_argument("--exposure", type=float, default=0.4)
    f.set_defaults(fn=cmd_fit)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
