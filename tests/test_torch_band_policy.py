"""The ``auto`` bands of the port (``pbr_tpu_torch/ops/traverse.py``) and
the card's band table they come from (``docs/BAND_TABLE_H100.json``,
written by ``pbr_tpu_torch/tools/band_table.py`` on an H100):

- ``band_policy`` on synthetic rows: a win in every round on every metric
  moves a band; a split round keeps it and the row says so; a new edge sits
  at the largest measured face count the mode below it still holds;
- ``resolve_mode('auto', ...)`` on each row of the committed table equals
  ``band_policy`` of that table, on the card and on the CPU;
- on each side of each edge the table moved, the port's CPU ``auto`` frame
  at 16² is within the frame gate of its plain K1 (``brute``) frame and of
  the JAX package's CPU frame through the same mode.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from pbr_tpu.models import integrator as jax_integrator
from pbr_tpu.ops import pallas_gated as jax_pallas_gated
from pbr_tpu.scene.build import bvh_max_leaf as jax_max_leaf
from pbr_tpu.scene.build import scene_from_text as jax_scene_from_text
from pbr_tpu.utils.config import RenderSettings as JaxSettings
from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.ops import traverse as tt
from pbr_tpu_torch.scene.build import bvh_max_leaf
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import grey_soup
from pbr_tpu_torch.tools import band_table as bt
from pbr_tpu_torch.utils.config import RenderSettings

torch.set_num_threads(1)

TABLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs",
                     "BAND_TABLE_H100.json")


def _row(tag, faces, times, clusters=True, forest=False):
    """A measured row: ``times`` maps a mode to its rounds, each
    (ms_frame, device_ms, ms_step)."""
    return {"tag": tag, "faces": faces, "clusters": clusters, "bvh": True, "forest": forest,
            "modes": {m: {"rounds": [dict(zip(bt.METRICS, r)) for r in rounds]}
                      for m, rounds in times.items()}}


FAST, SLOW = [(1.0, 1.0, 1.0)] * 3, [(2.0, 2.0, 2.0)] * 3
# The incumbent of the synthetic rows: the bands before the card's table.
SEED = {"clusters": ((1_024, "pallas"), (12_288, "gated"), (None, "cull")),
        "plain": ((10_000, "pallas"), (None, "tree"))}


def _policy(rows):
    return bt.band_policy(rows, SEED)


def _cull_band(*rows):
    """Clustered rows above the gated band, each (faces, bvh's rounds
    against cull's SLOW)."""
    return [_row(f"r{f}", f, {"cull": SLOW, "bvh": b}) for f, b in rows]


def test_a_win_in_every_round_moves_the_band():
    """bvh beats cull on every row above 14,000 faces in every round on all
    three metrics: the band above 14,000 goes to bvh, and the edge is
    14,000, the largest row cull still holds."""
    rows = _cull_band((13_000, [(3.0, 3.0, 3.0)] * 3), (14_000, [(3.0, 1.0, 1.0)] * 3),
                      (20_000, FAST), (50_000, FAST))
    pol = _policy(rows)
    assert pol["bands"]["clusters"] == ((1_024, "pallas"), (12_288, "gated"), (14_000, "cull"),
                                        (None, "bvh"))
    assert pol["bands"]["plain"] == SEED["plain"]
    assert pol["picks"] == {"r13000": "cull", "r14000": "cull", "r20000": "bvh",
                            "r50000": "bvh"}


@pytest.mark.parametrize("metric", range(3))
def test_a_split_round_keeps_the_pick(metric):
    """bvh beats cull everywhere but on one metric of one round of the
    top row: nothing moves, and the row's note says the rounds disagree."""
    split = list(FAST)
    split[1] = tuple(3.0 if i == metric else 1.0 for i in range(3))
    rows = _cull_band((20_000, FAST), (50_000, split))
    pol = _policy(rows)
    assert pol["bands"] == SEED
    assert set(pol["picks"].values()) == {"cull"}
    assert "disagree" in pol["notes"]["r50000"]
    assert "no move" in pol["notes"]["r20000"]


def test_the_edge_sits_at_the_incumbents_largest_winning_row():
    """bvh wins at 13,000, loses at 14,000 and wins above: the edge is
    14,000 and 13,000 keeps cull, with a note."""
    rows = _cull_band((13_000, FAST), (14_000, SLOW), (20_000, FAST), (50_000, FAST))
    pol = _policy(rows)
    assert pol["bands"]["clusters"][-2:] == ((14_000, "cull"), (None, "bvh"))
    assert pol["picks"]["r13000"] == "cull" and "no move" in pol["notes"]["r13000"]


def test_the_band_below_takes_the_lowest_rows():
    """K1 beats gated on the gated band's two lowest rows and not on the
    third: the K1 band's edge moves up to the second; a challenger that
    beats the incumbent on a whole band takes it (the edge moves down)."""
    rows = [_row("g1025", 1_025, {"gated": SLOW, "pallas": FAST}),
            _row("g1428", 1_428, {"gated": SLOW, "pallas": FAST}),
            _row("g4000", 4_000, {"gated": FAST, "pallas": SLOW})]
    pol = _policy(rows)
    assert pol["bands"]["clusters"] == ((1_428, "pallas"), (12_288, "gated"), (None, "cull"))
    rows = [_row("p512", 512, {"pallas": SLOW, "gated": FAST}),
            _row("p1024", 1_024, {"pallas": SLOW, "gated": FAST})]
    assert _policy(rows)["bands"]["clusters"] == ((12_288, "gated"), (None, "cull"))


def test_a_mode_not_measured_never_wins():
    """A skipped mode (no rounds) and a mode the row cannot serve beat
    nothing; the tree band's incumbent is the forest where the row has one."""
    rows = [_row("k1", 30_000, {"cull": SLOW, "pallas": []}),
            _row("f", 12_000, {"pallas_bvh_forest": SLOW, "bvh": FAST}, clusters=False,
                 forest=True)]
    pol = _policy(rows)
    assert pol["picks"] == {"k1": "cull", "f": "bvh"}
    assert pol["bands"]["plain"] == ((10_000, "pallas"), (None, "bvh"))


@functools.lru_cache(maxsize=None)
def _table() -> dict:
    with open(TABLE) as fh:
        return json.load(fh)


def test_the_table_is_the_cards_and_complete():
    """The committed table: an H100 with its power limit, at least 3
    interleaved rounds of every servable mode on every row (or the row's
    stated skip), and its recorded policy equal to ``band_policy`` now."""
    rec = _table()
    assert "H100" in rec["card"] and " W" in rec["card"] and rec["rounds"] >= 3
    tags = {r["tag"] for r in rec["rows"]}
    assert tags == {tag for tag, _, _ in bt.ROWS}
    for row in rec["rows"]:
        for mode, m in row["modes"].items():
            if mode in row["skipped"]:
                assert not m["rounds"]
                continue
            assert len(m["rounds"]) == rec["rounds"], (row["tag"], mode)
            assert len({r["order"] for r in m["rounds"]}) > 1, (row["tag"], mode)
        assert {"auto", "pallas", "bvh"} <= set(row["modes"]) or not row["bvh"]
    pol = bt.band_policy(rec["rows"], rec["incumbent"])
    assert rec["policy"]["picks"] == pol["picks"]
    assert {k: [list(b) for b in v] for k, v in pol["bands"].items()} == rec["policy"]["bands"]


def test_resolve_mode_runs_the_tables_policy():
    """``auto`` on every measured row, on the card and on the CPU, is the
    table's pick (K1 is the plain sweep on a CPU tensor); the constants of
    ``traverse.py`` are the policy's bands."""
    rec = _table()
    rows = rec["rows"]
    pol = bt.band_policy(rows, rec["incumbent"])
    assert {k: tuple(v) for k, v in tt.AUTO_BANDS.items()} == pol["bands"]
    for row in rows:
        for dev in (torch.device("cuda"), torch.device("cpu")):
            got = tt.resolve_mode("auto", dev, row["faces"], row["clusters"], row["bvh"],
                                  row["forest"])
            want = pol["picks"][row["tag"]]
            assert got == ("brute" if want == "pallas" and dev.type == "cpu" else want), row["tag"]
        # what auto ran when the row was measured: the incumbent bands' pick
        assert row["auto_resolves_to"] == tt.band_mode(
            rec["incumbent"][bt.row_class(row)], row["faces"], row["bvh"], row["forest"])


SIZE = 16
# bench.py's settings cut to 3 bounces, as tests/test_torch_bvh_render.py
# cuts them: the grey soup's diffuse paths end at depth 3 anyway.
FRAME = dict(width=SIZE, height=SIZE, samples=1, max_depth=3, max_added_depth=0,
             shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0))


def _within(a, b) -> float:
    return float((np.abs(a - b).max(axis=-1) <= 1e-3).mean())


# bench.py's soup on each side of each edge the table moved: K1's edge
# (1,024 -> 1,025 faces) and the band above the gated one (K4 -> K8).
@pytest.mark.parametrize("n_faces, pick", [(1_025, "brute"), (1_026, "gated"),
                                           (12_288, "gated"), (12_289, "bvh")])
def test_auto_frame_on_each_side_of_a_moved_edge(n_faces, pick, monkeypatch):
    """The port's CPU ``auto`` frame at 16² runs the table's pick and is
    within the frame gate (at least 99% of pixels within 1e-3) of its plain
    K1 frame (``brute``) and of the JAX package's CPU frame through the same
    mode (its NumPy backend; the gated kernel in interpret mode, as
    tests/test_torch_gated.py runs it on the CPU)."""
    obj = grey_soup(n_faces)
    js, _ = jax_scene_from_text(*obj, use_bvh=True)
    ps = bt.build_row("soup", n_faces)[0]
    cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    ts, ct = to_torch(ps, "cpu"), camera_to_torch(cam, "cpu")
    ids = torch.arange(SIZE * SIZE, dtype=torch.int32)
    assert tt.resolve_mode("auto", torch.device("cpu"), n_faces, True, True) == pick

    def port(mode):
        return trace_rays(ts, ct, RenderSettings(intersector=mode, **FRAME), ids, 3,
                          max_leaf=bvh_max_leaf(ps)).color.stack().numpy()

    got = port("auto")
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert np.array_equal(got, port(pick))
    assert _within(got, port("brute")) >= 0.99
    real = jax_pallas_gated.intersect_gated
    monkeypatch.setattr(jax_pallas_gated, "intersect_gated", lambda *a, **kw: real(
        *a, **{**kw, "interpret": True, "static_unroll": False}))
    with np.errstate(all="ignore"):
        ref = jax_integrator.trace_rays(np, js, cam, JaxSettings(intersector=pick, **FRAME),
                                        np.arange(SIZE * SIZE, dtype=np.int32), 3,
                                        max_leaf=jax_max_leaf(js))
    assert _within(got, np.stack(list(ref.color), axis=-1)) >= 0.99


@functools.lru_cache(maxsize=None)
def _big_soup():
    """soup:20001 through the default build: above 20,000 faces, so 64-face
    leaves (and clusters: ``auto`` is K8)."""
    return bt.build_row("soup", 20_001)[0]


def test_auto_above_20000_faces_walks_every_face_of_a_leaf():
    """``auto`` on a default build above 20,000 faces runs K8 over 64-face
    leaves; ``trace_rays`` given no ``max_leaf`` takes the tree's own
    bound, so its 16² CPU frame is the one with that bound passed, and
    within the frame gate of the plain K1 (``brute``) frame. A bound below
    the tree's largest leaf raises instead of skipping faces."""
    ps = _big_soup()
    ts = to_torch(ps, "cpu")
    assert ts.bvh.leaf_max == bvh_max_leaf(ps) > 2
    assert tt.resolve_mode("auto", torch.device("cpu"), ps.tris.count, True, True) == "bvh"
    ct = camera_to_torch(make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0)),
                         "cpu")
    ids = torch.arange(SIZE * SIZE, dtype=torch.int32)

    def frame(mode, **kw):
        return trace_rays(ts, ct, RenderSettings(intersector=mode, **FRAME), ids, 3,
                          **kw).color.stack().numpy()

    got = frame("auto")
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert np.array_equal(got, frame("bvh", max_leaf=bvh_max_leaf(ps)))
    assert _within(got, frame("brute")) >= 0.99
    with pytest.raises(ValueError, match="largest leaf"):
        frame("auto", max_leaf=2)


@pytest.mark.parametrize("given, want", [(None, 64), (64, 64), (100, 100), (63, None)])
def test_leaf_bound(given, want):
    """``leaf_bound``: None takes the tables' own bound, a bound at or above
    it is kept, one below it raises; tables without ``leaf_max`` (built by
    hand) take theirs from the leaf counts."""
    bvh = to_torch(_big_soup(), "cpu").bvh
    for tables in (bvh, bvh._replace(leaf_max=None)):
        if want is None and tables.leaf_max is not None:
            with pytest.raises(ValueError, match="largest leaf"):
                tt.leaf_bound(tables, given)
        else:
            assert tt.leaf_bound(tables, given) == (want or given)
