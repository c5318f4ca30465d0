"""The port's diagnostic tools (``pbr_tpu_torch/tools/``), on the CPU: the
source patch of ``k4_tiles`` finds every hook it needs in
``csrc/cull_intersect.cu`` as it stands, and its block statistics give the
span, tail and balance of a known record. The tools themselves run only on
a card."""

import numpy as np
import pytest

from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.tools import k4_tiles

SOURCE = (ci.CSRC / "cull_intersect.cu").read_text()


def test_source_as_built_is_the_unpatched_copy():
    """The copy at the source's own threads a ray and without the record is
    the source, byte for byte: the tool times the kernel as built."""
    k = k4_tiles.built_threads(SOURCE)
    assert k == 2
    assert k4_tiles.patched_source(SOURCE, k, record=False) == SOURCE


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_patched_source_finds_every_hook(threads):
    """At each threads-a-ray count: the constant is replaced once, the
    record's declaration and setter are added, slotted_kernel starts and
    ends with its clock reads, and sweep_list counts the slots it sweeps
    before each sweep_cluster call and writes the count."""
    src = k4_tiles.patched_source(SOURCE, threads, record=True)
    assert k4_tiles.built_threads(src) == threads
    assert src.count("constexpr int kThreadsPerRay") == 1
    assert src.count(k4_tiles._DECL) == 1 and src.endswith(k4_tiles._SETTER)
    lo, hi = k4_tiles._body(src, "slotted_kernel")
    assert src[lo:hi].startswith(k4_tiles._START) and src[lo:hi].endswith(k4_tiles._END)
    lo, hi = k4_tiles._body(src, "sweep_list")
    body = src[lo:hi]
    assert body.startswith(" int diag_slots = 0;") and body.endswith(k4_tiles._COUNT_END)
    assert body.count(k4_tiles._COUNT + "sweep_cluster<S, ANY_HIT, K>(") == 1


def test_patched_source_raises_on_a_missing_hook():
    with pytest.raises(ValueError, match="kThreadsPerRay"):
        k4_tiles.patched_source(SOURCE.replace("kThreadsPerRay = 2", "kRays = 2"), 1, False)
    with pytest.raises(ValueError, match="sweep_cluster"):
        k4_tiles.patched_source(SOURCE.replace("sweep_cluster<S, ANY_HIT, K>(",
                                               "sweep_one<S, ANY_HIT, K>("), 2, True)


def test_block_stats_of_a_known_record():
    """Four blocks on two SMs: starts 0, 0, 10, 20 ns, ends 10, 30, 20, 25
    ns, slots 1, 3, 1, 2. Two blocks are resident at once; their 55 ns of
    durations balance to 27.5 ns on two places; the median block ends at
    22.5 ns, the last at 30."""
    rec = np.array([[100, 110, 0, 1], [100, 130, 1, 3], [110, 120, 0, 1], [120, 125, 0, 2]])
    st = k4_tiles.block_stats(rec)
    assert st["blocks"] == 4 and st["sms"] == 2 and st["max_resident"] == 2
    np.testing.assert_allclose(
        [st["span_ms"], st["median_end_ms"], st["last_after_median_ms"], st["balanced_ms"],
         st["longest_block_ms"], st["schedule_launch_order_ms"],
         st["schedule_heaviest_first_ms"]],
        np.array([30, 22.5, 7.5, 27.5, 30, 30, 30]) / 1e6)
    assert st["longest_block_slots"] == 3 and st["slots_max"] == 3
    assert st["slots_mean"] == 1.75 and st["slots_top1pct_share"] == 3 / 7
