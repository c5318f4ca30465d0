"""The H100's band table: every intersect mode's frame, step and device time
across the face-count band, and the ``auto`` policy read from it.

    python3 -m pbr_tpu_torch.tools.band_table [--quick] [--resume]
        [--out docs/BAND_TABLE_H100.json]

Run it from the root of a checkout, on a card. It is the port's
counterpart of the JAX package's ``tools/band_table.py``: it drives the
port's ``PathTracer`` through its normal entry points with
``chip_smoke.py``'s settings (bench.py's main path at 1024²: 1 spp, 8
bounces, NEE, compaction from the probe, each tracer's own probed lane
order) on these rows:

- Cornell (34 faces, no BVH);
- ``multi_room(nx, nz, clutter)`` with bench.py's multiroom camera, for
  (3, 3, 10), (4, 4, 20), (5, 5, 30), (6, 6, 30), (8, 8, 40), (10, 10,
  40): 1,428 to 52,380 faces;
- ``grey_soup(N)`` (bench.py's soup:N) with its camera, N from 512 to
  100,000, on both sides of each band edge;
- one soup just above 10,000 faces with its clusters dropped (the default
  build's rule then decides its forest): the only row that reaches the
  no-cluster band above 10,000 faces.

Each row runs ``auto`` and every mode the default build serves on it
(``servable``). For each (row, mode), in ``ROUNDS`` rounds with the mode
order rotated each round: ms/frame by CUDA events (2 warm-up frames, then
``FRAMES`` timed), device ms and kernel launches of one frame
(torch.profiler, as ``chip_smoke._device_launches`` reads them), ms/step of
bench.py's forward+backward step (``chip_smoke._grads``: loss = the sum of
the colours, gradients to materials, lights and the eye; one warm-up step
in the first round, then ``STEPS`` timed), and the peak memory above what
was allocated before the mode's turn. Once per mode: the port's kernels
launched in one frame (``chip_smoke.counts``) and the share of pixels of
its first frame within 1e-3 of the row's K1 (``pallas``) first frame.
Above ``K1_SKIP_FACES`` faces K1 runs its first frame and one timed frame;
when that frame is more than ``K1_SKIP_RATIO`` times the fastest other
mode's, its other measurements are skipped and the row says so.

The JSON record (the card's name and power limit from nvidia-smi, the
settings, every row) is rewritten after each round of each row, so a cut
run leaves a valid file. ``--quick`` runs a subset of the rows.
``band_policy(rows, incumbent)`` reads the bands from a record (its rows,
and ``incumbent``, the bands they were measured under): the port's
``ops/traverse.py`` carries the result as constants, and
``tests/test_torch_band_policy.py`` holds the two equal on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pbr_tpu_torch.ops.traverse import band_mode

MODES = ("pallas", "gated", "cull", "bvh", "pallas_bvh_hbm", "pallas_bvh", "pallas_bvh_forest")
METRICS = ("ms_frame", "device_ms", "ms_step")
SIZE, ROUNDS, WARMUP, FRAMES, STEPS = 1024, 3, 2, 4, 2
K1_SKIP_FACES, K1_SKIP_RATIO = 20_000, 3.0
WITHIN = 1e-3

# (tag, family, argument): the rows, in rising face count within a family.
ROWS = (
    ("cornell", "cornell", None),
    ("multiroom:3,3,10", "multiroom", (3, 3, 10)),
    ("multiroom:4,4,20", "multiroom", (4, 4, 20)),
    ("multiroom:5,5,30", "multiroom", (5, 5, 30)),
    ("multiroom:6,6,30", "multiroom", (6, 6, 30)),
    ("multiroom:8,8,40", "multiroom", (8, 8, 40)),
    ("multiroom:10,10,40", "multiroom", (10, 10, 40)),
    *((f"soup:{n}", "soup", n) for n in (512, 1_024, 1_025, 4_000, 10_000, 12_288, 12_289,
                                         20_000, 50_000, 100_000)),
    ("soup:10001, no clusters", "soup_plain", 10_001),
)
QUICK = ("cornell", "multiroom:3,3,10", "soup:12289", "soup:20000", "soup:10001, no clusters")


def build_row(family: str, arg):
    """(scene, camera) of a row, built by the port's host layer."""
    from pbr_tpu_torch.accel.forest import build_forest
    from pbr_tpu_torch.ops.cuda_bvh import packet_fits
    from pbr_tpu_torch.scene.build import scene_from_text
    from pbr_tpu_torch.scene.camera import make_camera_state
    from pbr_tpu_torch.scene.procedural import cornell_box, grey_soup, multi_room

    if family == "cornell":
        scene, _ = scene_from_text(*cornell_box(), use_bvh=False)
        return scene, make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    if family == "multiroom":
        scene, _ = scene_from_text(*multi_room(*arg), use_bvh=True)
        return scene, make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0))
    scene, _ = scene_from_text(*grey_soup(arg), use_bvh=True)
    if family == "soup_plain":
        # scene/build.py's rule for a BVH without clusters: a forest only
        # where the single-tree packet walk cannot hold the scene.
        forest = None if packet_fits(scene.bvh, scene.tris) else build_forest(scene.tris)
        scene = scene._replace(clusters=None, forest=forest)
    return scene, make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))


def servable(scene, mode: str) -> bool:
    """Whether ``mode`` runs on ``scene`` as the default build made it."""
    from pbr_tpu_torch.ops.cuda_bvh import packet_fits, packet_hbm_fits
    from pbr_tpu_torch.ops.cuda_gated import GATE_CLUSTER

    if mode == "pallas":
        return True
    if mode == "gated":  # K3 takes 64-face clusters only
        return scene.clusters is not None and scene.clusters.size == GATE_CLUSTER
    if mode == "cull":
        return scene.clusters is not None
    if scene.bvh is None:
        return False
    if mode == "pallas_bvh_hbm":
        return packet_hbm_fits(scene.bvh)
    if mode == "pallas_bvh":
        return packet_fits(scene.bvh, scene.tris)
    if mode == "pallas_bvh_forest":
        return scene.forest is not None
    return mode == "bvh"


def row_class(row: dict) -> str:
    return "clusters" if row["clusters"] else "plain"


def concrete(mode: str, row: dict) -> str:
    """A band's mode on ``row`` ("tree" resolved by ``band_mode``)."""
    return band_mode(((None, mode),), row["faces"], row["bvh"], row["forest"])


def beats(row: dict, challenger: str, incumbent: str) -> bool:
    """True when ``challenger`` is faster than ``incumbent`` on ``row`` in
    every round on every one of ``METRICS``; False where either was not
    measured (not servable, or skipped)."""
    modes = row["modes"]
    if challenger not in modes or incumbent not in modes:
        return False
    a, b = modes[challenger].get("rounds"), modes[incumbent].get("rounds")
    if not a or not b or len(a) != len(b):
        return False
    return all(ra[m] < rb[m] for ra, rb in zip(a, b) for m in METRICS)


def _median_ms(row: dict, mode: str) -> float:
    return statistics.median(r["ms_frame"] for r in row["modes"][mode]["rounds"])


def band_policy(rows, incumbent) -> dict:
    """The ``auto`` bands that the measured ``rows`` call for, starting
    from the ``incumbent`` bands (``traverse.AUTO_BANDS``' form: per class
    of scene, (largest face count or None, mode) in rising order; the
    "plain" class's "tree" is the forest where the scene has one, else the
    BVH walk, else K1), the dispatch the rows were measured under.

    Each band keeps its mode (its incumbent) except where another mode
    beats it (``beats``: every round, every metric):

    - its lowest rows go to the band below's mode while that mode beats
      the incumbent on each of them (the edge moves up);
    - its highest rows go to the challenger that beats the incumbent on
      every row above some face count T, for the lowest such T (a
      challenger that beats it on every row left takes them all); ties go
      to the lower median ms/frame over those rows. Where that challenger
      is the band above's mode, the edge moves down; else a band of its
      own is born.

    Each new edge is the largest measured face count at which the mode
    below it still holds. A challenger that wins a row that no move takes
    leaves the incumbent there; so do rounds that disagree. Each such row
    gets a note.

    Returns ``{"bands": {class: ((top, mode), ...)}, "picks": {tag: mode},
    "notes": {tag: text}}``: "picks" is each row's mode under the new
    bands, "tree" resolved per row (``concrete``)."""
    bands, notes = {}, {}
    for cls, seed_bands in incumbent.items():
        seed_bands = [tuple(b) for b in seed_bands]
        mine = sorted((r for r in rows if row_class(r) == cls), key=lambda r: r["faces"])
        out, lo = [], None
        for i, (top, inc) in enumerate(seed_bands):
            band = [r for r in mine if (lo is None or r["faces"] > lo)
                    and (top is None or r["faces"] <= top)]
            lo = top
            below = seed_bands[i - 1][1] if i else None
            n_low = 0
            while (below is not None and out[-1][1] == below and n_low < len(band)
                   and beats(band[n_low], concrete(below, band[n_low]),
                             concrete(inc, band[n_low]))):
                n_low += 1
            if n_low:
                out[-1] = (band[n_low - 1]["faces"], below)
            rest = band[n_low:]
            best = None  # (first row taken, median ms over the rows taken, mode)
            for c in MODES:
                k = len(rest)
                while k and c != concrete(inc, rest[k - 1]) and beats(
                        rest[k - 1], c, concrete(inc, rest[k - 1])):
                    k -= 1
                if k < len(rest):
                    ms = sum(_median_ms(r, c) for r in rest[k:])
                    if best is None or (k, ms) < best[:2]:
                        best = (k, ms, c)
            if best is not None and best[0]:
                out.append((rest[best[0] - 1]["faces"], inc))
            out.append((top, inc if best is None else best[2]))
            for r in rest[:len(rest) if best is None else best[0]]:
                here = concrete(inc, r)
                won = [c for c in MODES if c != here and beats(r, c, here)]
                split = [c for c in MODES if c != here and _split(r, c, here)]
                if won:
                    notes[r["tag"]] = (f"{', '.join(won)} beat {here} in every round on every "
                                       f"metric, but no move of the band takes this row: "
                                       f"{here} stays")
                elif split:
                    notes[r["tag"]] = (f"the rounds disagree: {', '.join(split)} beat {here} "
                                       f"in some rounds or metrics, not all: {here} stays")
        bands[cls] = tuple(_merge(out))
    picks = {r["tag"]: band_mode(bands[row_class(r)], r["faces"], r["bvh"], r["forest"])
             for r in rows}
    return {"bands": bands, "picks": picks, "notes": notes}


def _split(row: dict, mode: str, incumbent: str) -> bool:
    """True when ``mode`` beats ``incumbent`` on ``row`` in some rounds and
    metrics but not in all."""
    modes = row["modes"]
    if mode not in modes or incumbent not in modes:
        return False
    a, b = modes[mode].get("rounds"), modes[incumbent].get("rounds")
    if not a or not b:
        return False
    won = [ra[m] < rb[m] for ra, rb in zip(a, b) for m in METRICS]
    return any(won) and not all(won)


def _merge(bands: list) -> list:
    """Adjacent bands of one mode joined."""
    out = []
    for top, mode in bands:
        if out and out[-1][1] == mode:
            out[-1] = (top, mode)
        else:
            out.append((top, mode))
    return out


# ---------------------------------------------------------------- the card --

def build_kernels() -> None:
    """Every kernel source with nvcc and the native BVH builder with g++,
    all at once."""
    from pbr_tpu_torch.accel import native
    from pbr_tpu_torch.ops import cuda_intersect as ci

    names = ("brute_intersect", "gated_intersect", "cull_intersect", "row_sweep", "bvh_packet",
             "bvh_walk")
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        jobs = [pool.submit(ci.build, n) for n in names]
        jobs.append(pool.submit(native.load_library, rebuild=True))
        for j in jobs:
            j.result()


class _Clock:
    """ms of a block: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            self.ms = self.ev[0].elapsed_time(self.ev[1])
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


class _Mode:
    """One mode's tracer on a row, its step's tensors and its record."""

    def __init__(self, smoke, scene, cam, mode: str, dev, size: int):
        from pbr_tpu_torch import PathTracer, camera_to_torch

        self.smoke, self.cam, self.dev = smoke, cam, dev
        self.pt = PathTracer(scene, smoke.bench_settings(size, compact_schedule="auto",
                                                         intersector=mode), device=dev)
        self.cam_t = camera_to_torch(cam, dev)
        for c in self.cam_t.eye:
            c.requires_grad_()
        self.seed = 0
        self.stepped = False
        self.rec = {"rounds": []}

    def frame(self) -> None:
        self.pt.render(self.cam, frame_seed=self.seed)
        self.seed += 1

    def first(self) -> np.ndarray:
        """The probes and frame 0, its image, and the kernels of one frame."""
        self.frame()
        img = self.pt.image()
        self.smoke.zero_counts()
        self.frame()
        _sync(self.dev)
        self.rec.update(lane_order=self.pt.lane_order,
                        schedule=list(self.pt.settings.compact_schedule),
                        launches_per_frame={k: v for k, v in self.smoke.counts().items() if v})
        return img

    def frames_ms(self, n: int) -> float:
        with _Clock(self.dev) as c:
            for _ in range(n):
                self.frame()
        return c.ms / n

    def step(self):
        return self.smoke._grads(self.pt.scene, self.cam_t, self.pt.settings,
                                 self.pt.pixel_ids)

    def round(self, order: int) -> dict:
        _sync(self.dev)
        cuda = self.dev.type == "cuda"
        base = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for _ in range(WARMUP):
            self.frame()
        ms_frame = self.frames_ms(FRAMES)
        if cuda:
            launches, dev_ms, ours_ms, _ = self.smoke._device_launches(self.frame)
        else:
            self.frame()
            launches, dev_ms, ours_ms = 0, 0.0, 0.0
        self.pt.scene.requires_grad_()
        try:
            if not self.stepped:
                self.step()
                self.stepped = True
            with _Clock(self.dev) as c:
                for _ in range(STEPS):
                    loss, grads, _ = self.step()
        finally:
            self.pt.scene.requires_grad_(False)
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError("a gradient is not finite")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda else 0.0
        r = {"order": order, "ms_frame": ms_frame, "device_ms": dev_ms, "port_kernel_ms": ours_ms,
             "launches": launches, "ms_step": c.ms / STEPS, "peak_mib": peak,
             "loss": float(loss.detach())}
        self.rec["rounds"].append(r)
        return r


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def measure_row(smoke, tag: str, family: str, arg, dev, size: int, flush, card: str) -> dict:
    from pbr_tpu_torch.ops import cuda_bvh as cb
    from pbr_tpu_torch.ops import traverse as tt

    t0 = time.perf_counter()
    scene, cam = build_row(family, arg)
    nf = scene.tris.count
    row = {"tag": tag, "card": card, "family": family, "faces": nf,
           "clusters": scene.clusters is not None,
           "cluster_size": scene.clusters.size if scene.clusters is not None else None,
           "bvh": scene.bvh is not None, "forest": scene.forest is not None,
           "bvh_nodes": scene.bvh.count if scene.bvh is not None else None,
           "packet_fits": scene.bvh is not None and cb.packet_fits(scene.bvh, scene.tris),
           "packet_hbm_fits": scene.bvh is not None and cb.packet_hbm_fits(scene.bvh),
           "build_s": time.perf_counter() - t0, "modes": {}, "skipped": {}}
    row["auto_resolves_to"] = tt.resolve_mode("auto", dev, nf, row["clusters"], row["bvh"],
                                              row["forest"])
    names = ["auto"] + [m for m in MODES if servable(scene, m)]
    if nf > K1_SKIP_FACES:  # K1 measured last in the first round, for its skip
        names.remove("pallas")
        names.append("pallas")
    runs, first = {}, {}
    for m in names:
        runs[m] = _Mode(smoke, scene, cam, m, dev, size)
        first[m] = runs[m].first()
        _say(tag, f"{m}: lane order {runs[m].pt.lane_order}, one frame's launches "
                  f"{runs[m].rec['launches_per_frame']}")
        row["modes"][m] = runs[m].rec
    ref = first["pallas"]
    for m in names:
        d = np.abs(first[m] - ref).max(axis=-1)
        runs[m].rec["within_1e3_of_k1"] = float((d <= WITHIN).mean())
        runs[m].rec["nan"] = bool(np.isnan(first[m]).any())
    active = list(names)
    for k in range(ROUNDS):
        order = active[k % len(active):] + active[:k % len(active)]
        for i, m in enumerate(order):
            if m == "pallas" and nf > K1_SKIP_FACES and k == 0:
                ms = runs[m].frames_ms(1)
                others = [runs[o].rec["rounds"][0]["ms_frame"] for o in order if o != m]
                if ms > K1_SKIP_RATIO * min(others):
                    row["skipped"][m] = (f"one timed frame {ms:.3f} ms against the fastest "
                                         f"other mode's {min(others):.3f} ms (more than "
                                         f"{K1_SKIP_RATIO:g}x): not measured further")
                    runs[m].rec["one_frame_ms"] = ms
                    active.remove(m)
                    _say(tag, f"K1 skipped: {row['skipped'][m]}")
                    continue
            r = runs[m].round(i)
            _say(tag, f"round {k + 1}, {m}: {r['ms_frame']:.3f} ms/frame, device "
                      f"{r['device_ms']:.3f} ms in {r['launches']} launches, "
                      f"{r['ms_step']:.3f} ms/step, peak {r['peak_mib']:.1f} MiB")
        flush(row)
    del runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


KERNEL = {"pallas": "K1", "gated": "K3", "cull": "K4", "bvh": "K8", "pallas_bvh_hbm": "K7",
          "pallas_bvh": "K6", "pallas_bvh_forest": "K6 forest"}


def summary(record: dict) -> str:
    """A record's rows as a markdown table: per mode the medians over the
    rounds of ms/frame, device ms and ms/step, and the launches of the
    profiled frame (thousands); the policy's pick in bold."""
    pol = band_policy(record["rows"], record["incumbent"])
    modes = [m for m in MODES if any(m in r["modes"] for r in record["rows"])]
    lines = ["| scene (faces) | auto: measured → table | "
             + " | ".join(KERNEL[m] for m in modes)
             + " |", "|---" * (len(modes) + 2) + "|"]
    for r in record["rows"]:
        cells = []
        for m in modes:
            rec = r["modes"].get(m)
            if rec is None:
                cells.append("—")
                continue
            if not rec["rounds"]:
                cells.append(f"skipped ({rec['one_frame_ms']:.0f} one frame)")
                continue
            med = {k: statistics.median(x[k] for x in rec["rounds"])
                   for k in (*METRICS, "launches")}
            cell = (f"{med['ms_frame']:.0f} / {med['device_ms']:.1f} / {med['ms_step']:.0f}, "
                    f"{med['launches'] / 1e3:.1f}k")
            cells.append(f"**{cell}**" if pol["picks"][r["tag"]] == m else cell)
        lines.append(f"| {r['tag']} ({r['faces']:,}) | {KERNEL[r['auto_resolves_to']]} → "
                     f"{KERNEL[pol['picks'][r['tag']]]} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _say(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="docs/BAND_TABLE_H100.json")
    ap.add_argument("--quick", action="store_true", help="a subset of the rows")
    ap.add_argument("--resume", action="store_true",
                    help="keep the rows of --out that ran every round, measure the rest")
    ap.add_argument("--device", default="cuda", help="'cpu' rehearses the tool at --size")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--summary", metavar="JSON", default=None,
                    help="print a record's table as markdown and exit (no card needed)")
    a = ap.parse_args(argv)
    if a.summary:
        print(summary(json.loads(Path(a.summary).read_text())))
        return
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("band_table: no CUDA device")
    import chip_smoke as smoke  # the repo root's: settings, counters, the step

    from pbr_tpu_torch.tools.k3_tiles import smi

    card = smi() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        build_kernels()
        _say("build", f"kernels built in {time.perf_counter() - t0:.1f} s")
    rows = [r for r in ROWS if not a.quick or r[0] in QUICK]
    from pbr_tpu_torch.ops.traverse import AUTO_BANDS

    record = {"card": card, "device": str(dev), "size": a.size, "rounds": ROUNDS,
              "incumbent": {k: [list(b) for b in v] for k, v in AUTO_BANDS.items()},
              "warmup_frames": WARMUP, "frames": FRAMES, "steps": STEPS,
              "settings": "chip_smoke.bench_settings(size, compact_schedule='auto', "
                          "intersector=mode): 1 spp, max_depth 3 + 5, NEE, anti_aliasing "
                          "0.7, sky (0.85, 0.9, 1.0)",
              "metrics": {"ms_frame": "CUDA events over the timed frames, per frame",
                          "device_ms": "torch.profiler's kernel time over one frame",
                          "ms_step": "CUDA events over the timed forward+backward steps",
                          "peak_mib": "peak allocated during the mode's turn, above what "
                                      "was allocated before it",
                          "within_1e3_of_k1": "share of frame 0's pixels within 1e-3 of "
                                              "the row's K1 frame 0"},
              "rows": []}
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if a.resume and out.exists():  # keep the rows that ran every round
        old = json.loads(out.read_text())
        record["incumbent"] = old["incumbent"]
        record["rows"] = [r for r in old["rows"] if all(
            len(m["rounds"]) == ROUNDS or k in r["skipped"] for k, m in r["modes"].items())]
        _say("resume", f"{len(record['rows'])} rows kept from {out}")
    done = {r["tag"] for r in record["rows"]}

    def flush(row):
        done = [r for r in record["rows"] if r["tag"] != row["tag"]]
        record["rows"] = done + [row]
        out.write_text(json.dumps(record, indent=1) + "\n")

    t0 = time.perf_counter()
    for tag, family, arg in rows:
        if tag not in done:
            measure_row(smoke, tag, family, arg, dev, a.size, flush, card)
    order = {t: i for i, (t, _, _) in enumerate(ROWS)}
    record["rows"].sort(key=lambda r: order.get(r["tag"], len(ROWS)))
    pol = band_policy(record["rows"], record["incumbent"])
    record["policy"] = {"bands": {k: [list(b) for b in v] for k, v in pol["bands"].items()},
                        "picks": pol["picks"], "notes": pol["notes"]}
    out.write_text(json.dumps(record, indent=1) + "\n")
    _say("done", f"{len(rows)} rows in {time.perf_counter() - t0:.1f} s; bands "
                 f"{pol['bands']}; picks {pol['picks']}")
    print(json.dumps({"band_table": str(out), "card": card, "bands": pol["bands"]}), flush=True)


if __name__ == "__main__":
    main()
