"""The Phong dispatch's band (``pbr_tpu_torch/ops/phongtess.py::
CLUSTER_MIN_RAYS``) and the card's record it comes from
(``docs/PHONG_BANDS_H100.json``, written by
``pbr_tpu_torch/tools/phong_bands.py`` on an H100):

- ``phong_policy`` on synthetic records: K10 keeps a pass size only where
  it wins every round of every pass row at that size and the "K10" choice
  wins every round on every frame metric; the threshold is the least size
  from which it keeps every larger one, None where it keeps none;
- ``CLUSTER_MIN_RAYS`` is ``phong_policy`` of the committed record, the
  same constant on the CPU and on the card (the dispatch reads nothing
  else), and the record holds what the tool promises: every scene, ray
  set and pass size, both searches, both choices, in every round;
- K9's launch order and the card's record it comes from
  (``docs/K9_ORDER_H100.json``, written by
  ``pbr_tpu_torch/tools/k9_walk.py``): ``order_policy`` would sort a pass
  kind only where the sort wins every round on every scene; on the
  committed record, whose rows hold every scene, kind and order in every
  round, it sorts none, which is why K9's wrappers launch the rays as
  given.
"""

import json
import os

import pytest

from pbr_tpu_torch.ops import phongtess
from pbr_tpu_torch.tools import k9_walk as kw
from pbr_tpu_torch.tools import phong_bands as pb

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
RECORD = os.path.join(DOCS, "PHONG_BANDS_H100.json")
ORDER_RECORD = os.path.join(DOCS, "K9_ORDER_H100.json")


def _record(k10_ms, k9_ms, frames_k10=(1.0, 1.0, 1.0), frames_k9=(2.0, 2.0, 2.0), rounds=3):
    """A record whose pass rows take ``k10_ms[size]`` / ``k9_ms[size]`` (a
    number, or a list a round) on every scene and ray set, and whose frames
    take ``frames_k10`` / ``frames_k9`` (the three metrics) on every scene
    in every round."""
    per_round = lambda v, i: v[i] if isinstance(v, list) else v  # noqa: E731
    passes = [{"scene": sc, "rays": ry, "size": s,
               "rounds": [{"K10": per_round(k10_ms[s], i), "K9": per_round(k9_ms[s], i)}
                          for i in range(rounds)]}
              for sc in pb.SCENES for ry in pb.RAYS for s in pb.SIZES]
    frame = lambda m: {"rounds": [dict(zip(pb.METRICS, m))] * rounds}  # noqa: E731
    return {"rounds": rounds, "sizes": list(pb.SIZES), "passes": passes,
            "frames": {sc: {"K10": frame(frames_k10), "K9": frame(frames_k9)}
                       for sc in pb.SCENES}}


_SLOW, _FAST = dict.fromkeys(pb.SIZES, 2.0), dict.fromkeys(pb.SIZES, 1.0)


@pytest.mark.parametrize("k10, k9, frames_k10, want", [
    (_FAST, _SLOW, (1.0, 1.0, 1.0), 4096),  # K10 wins everything: the JAX package's edge
    (_SLOW, _FAST, (1.0, 1.0, 1.0), None),  # K9 wins every pass
    ({**_SLOW, 262144: 1.0, 1048576: 1.0}, _SLOW, (1.0, 1.0, 1.0), 262144),  # big passes
    ({**_FAST, 65536: 2.0}, _SLOW, (1.0, 1.0, 1.0), 262144),  # a loss below: edge above it
    ({**_FAST, 1048576: 2.0}, _SLOW, (1.0, 1.0, 1.0), None),  # loses the largest: none
    (_FAST, _SLOW, (1.0, 3.0, 1.0), None),  # the frames' device ms loses: none
    ({**_FAST, 4096: [1.0, 3.0, 1.0]}, _SLOW, (1.0, 1.0, 1.0), 65536),  # a split round
])
def test_policy_moves_only_on_wins_in_every_round(k10, k9, frames_k10, want):
    got = pb.phong_policy(_record(k10, k9, frames_k10=frames_k10))
    assert got["cluster_min_rays"] == want


def test_policy_needs_every_round():
    """A record with a round missing on one row moves nothing there."""
    rec = _record(_FAST, _SLOW)
    rec["passes"][0]["rounds"].pop()
    assert pb.phong_policy(rec)["cluster_min_rays"] == 65536
    rec = _record(_FAST, _SLOW)
    rec["frames"]["sphere"]["K9"]["rounds"] = rec["frames"]["sphere"]["K9"]["rounds"][:2]
    assert pb.phong_policy(rec)["cluster_min_rays"] is None


def test_threshold_is_the_cards_record():
    """``CLUSTER_MIN_RAYS`` is what ``phong_policy`` reads from the card's
    record, which holds 3 interleaved rounds of every row the tool
    measures and names the card."""
    with open(RECORD) as f:
        rec = json.load(f)
    assert "H100" in rec["device"] and rec["rounds"] == 3
    assert sorted(rec["sizes"]) == list(pb.SIZES)
    rows = {(r["scene"], r["rays"], r["size"]) for r in rec["passes"]}
    assert rows == {(sc, ry, s) for sc in pb.SCENES for ry in pb.RAYS for s in pb.SIZES}
    assert all(len(r["rounds"]) == 3 and set(r["rounds"][0]) == {"K10", "K9"}
               for r in rec["passes"])
    assert set(rec["frames"]) == set(pb.SCENES)
    assert all(set(v) == set(pb.CHOICES) and all(len(c["rounds"]) == 3 for c in v.values())
               for v in rec["frames"].values())
    policy = pb.phong_policy(rec)
    assert rec["policy"] == policy
    assert phongtess.CLUSTER_MIN_RAYS == policy["cluster_min_rays"]


def _order_record(ms, rounds=3):
    """A K9 order record whose (scene, kind) rows take ``ms[kind]``: a dict
    {order: ms, or a list a round}."""
    per_round = lambda v, i: v[i] if isinstance(v, list) else v  # noqa: E731
    return {"rounds": rounds, "passes": [
        {"scene": sc, "kind": k, "passes": 1, "rays": 1,
         "rounds": [{o: per_round(ms[k][o], i) for o in kw.ORDERS} for i in range(rounds)]}
        for sc in kw.SCENES for k in kw.KINDS]}


_LANE = {"lane": 1.0, "sort": 2.0, "octant": 1.5, "live": 1.2}
_SORT = {"lane": 2.0, "sort": 1.0, "octant": 1.5, "live": 2.5}


@pytest.mark.parametrize("ms, want", [
    ({k: _SORT for k in kw.KINDS}, ["bounce", "camera", "shadow"]),
    ({k: _LANE for k in kw.KINDS}, []),
    ({"camera": _LANE, "bounce": _SORT, "shadow": _SORT}, ["bounce", "shadow"]),
    ({"camera": _LANE, "bounce": {**_SORT, "sort": [1.0, 2.5, 1.0]},
      "shadow": _SORT}, ["shadow"]),  # a split round keeps the rays as given
    ({k: {**_LANE, "live": 0.5, "octant": 0.5} for k in kw.KINDS},
     []),  # the cheaper orders are measured, and decide nothing
])
def test_k9_order_policy_sorts_only_on_wins_in_every_round(ms, want):
    assert kw.order_policy(_order_record(ms))["sort"] == want


def test_k9_order_policy_needs_every_round_and_scene():
    rec = _order_record({k: _SORT for k in kw.KINDS})
    rec["passes"][0]["rounds"].pop()  # the sphere's camera row
    assert kw.order_policy(rec)["sort"] == ["bounce", "shadow"]
    rec = _order_record({k: _SORT for k in kw.KINDS})
    rec["passes"] = [r for r in rec["passes"] if r["scene"] == "sphere" or r["kind"] != "shadow"]
    assert kw.order_policy(rec)["sort"] == ["bounce", "camera"]


def test_k9_sort_passes_are_the_cards_record():
    """The card's record, which holds 3 interleaved rounds of every scene,
    pass kind and order and names the card, sorts no pass kind: the
    wrappers' launch of the rays as given is its policy."""
    with open(ORDER_RECORD) as f:
        rec = json.load(f)
    assert "H100" in rec["device"] and rec["rounds"] == 3
    assert {(r["scene"], r["kind"]) for r in rec["passes"]} == {
        (sc, k) for sc in kw.SCENES for k in kw.KINDS}
    assert all(len(r["rounds"]) == 3 and set(r["rounds"][0]) == set(kw.ORDERS)
               for r in rec["passes"])
    policy = kw.order_policy(rec)
    assert rec["policy"] == policy
    assert policy["sort"] == [] and not any(policy["wins"].values())
