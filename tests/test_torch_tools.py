"""The port's diagnostic tools (``pbr_tpu_torch/tools/``), on the CPU: the
source patches of ``k4_tiles``, ``k8_walk``, ``k5_rows``, ``k7_walk`` and
``k6_walk`` find every hook they need in ``csrc/cull_intersect.cu``,
``csrc/bvh_walk.cu``, ``csrc/row_sweep.cu`` and ``csrc/bvh_packet.cu`` as
they stand, and their
statistics give the span, tail, balance, SIMD efficiency, rows a staged
slot and staging share of known records. The tools themselves run only on
a card."""

import re

import numpy as np
import pytest

from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.tools import k4_tiles, k5_rows, k6_walk, k7_walk, k8_walk

SOURCE = (ci.CSRC / "cull_intersect.cu").read_text()
K8_SOURCE = (ci.CSRC / "bvh_walk.cu").read_text()
K5_SOURCE = (ci.CSRC / "row_sweep.cu").read_text()
K7_SOURCE = (ci.CSRC / "bvh_packet.cu").read_text()


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


def test_k8_patched_source_finds_every_hook():
    """The record's declaration and setter are added once; walk_kernel
    starts and ends with its clock reads and tallies each node step and
    each face test once; the rest of the source is unchanged."""
    src = k8_walk.patched_source(K8_SOURCE)
    assert src.count(k8_walk._DECL) == 1 and src.endswith(k8_walk._SETTER)
    lo, hi = k8_walk._body(src, "walk_kernel")
    body = src[lo:hi]
    assert body.startswith(k8_walk._START) and body.endswith(k8_walk._END)
    assert body.count(k8_walk._NODE + k8_walk._NODE_ANCHOR) == 1
    assert body.count(k8_walk._LEAF_ANCHOR + " " + k8_walk._LEAF) == 1
    for hook in (k8_walk._DECL, k8_walk._SETTER, k8_walk._START, k8_walk._END,
                 k8_walk._NODE, " " + k8_walk._LEAF):
        src = src.replace(hook, "", 1)
    assert src == K8_SOURCE


def test_k8_kernel_has_no_early_return():
    """walk_kernel returns only at its end, where the patch reads each
    warp's clock: a lane that returned early would leave its warp's
    __syncwarp and record."""
    lo, hi = k8_walk._body(K8_SOURCE, "walk_kernel")
    code = re.sub(r"//[^\n]*", "", K8_SOURCE[lo:hi])
    assert re.search(r"\breturn\b", code) is None


@pytest.mark.parametrize("old, new, match", [
    ("#include <cuda_runtime.h>\n", "#include <cuda.h>\n", "cuda_runtime"),
    ("walk_kernel(const Params p)", "walk_rays(const Params p)", "walk_kernel"),
    ("++visits;", "visits += 1;", "visits"),
    ("for (int k = 0; k < cnt; ++k) {", "for (int k = 0; k != cnt; ++k) {", "cnt"),
])
def test_k8_patched_source_raises_on_a_missing_hook(old, new, match):
    """The include the declaration follows, the kernel's name and its two
    loops' anchors: the patch fails where one goes missing."""
    assert K8_SOURCE.count(old) == 1
    with pytest.raises(ValueError, match=match):
        k8_walk.patched_source(K8_SOURCE.replace(old, new))


def test_warp_stats_of_a_known_record():
    """Three warps that ran (and one row that never did): starts 0, 0, 10
    ns, ends 10, 40, 20 ns; node iterations 2, 4, 2 with 64, 32, 32 lanes;
    leaf iterations 1, 1, 0 with 32, 16, 0 lanes. Two run at once; the
    median warp ends at 20 ns, the last at 40; a warp lasts 20 ns on
    average; SIMD 128 / 256 and 48 / 64."""
    rec = np.array([[100, 110, 2, 64, 1, 32], [100, 140, 4, 32, 1, 16],
                    [110, 120, 2, 32, 0, 0], [0, 0, 0, 0, 0, 0]])
    st = k8_walk.warp_stats(rec)
    assert st["warps"] == 3 and st["resident_warps"] == 2
    np.testing.assert_allclose(
        [st["span_ms"], st["median_end_ms"], st["last_after_median_ms"], st["mean_warp_ms"],
         st["longest_warp_ms"]], np.array([40, 20, 20, 20, 40]) / 1e6)
    assert st["node_simd"] == 0.5 and st["leaf_simd"] == 0.75
    assert st["node_iterations_per_warp"] == 8 / 3 and st["leaf_iterations_per_warp"] == 2 / 3


def test_k5_patched_source_finds_every_hook():
    """The record's declaration and setter are added once; each of
    slotted_rows_kernel and masked_rows_kernel starts and ends with its
    clock reads and its tile, times the staging of each lin cluster's table
    once and counts each staged table's rows once; the rest of the source
    is unchanged."""
    src = k5_rows.patched_source(K5_SOURCE)
    assert src.count(k5_rows._DECL) == 1 and src.endswith(k5_rows._SETTER)
    end = k5_rows._END
    wait, pair = k5_rows._WAIT, k5_rows._PAIR
    for kernel in k5_rows.KERNELS:
        lo, hi = k5_rows._body(src, kernel, "row_sweep.cu")
        body = src[lo:hi]
        assert body.startswith(k5_rows._START) and body.endswith(end)
        assert len(re.findall(re.escape(wait[1]) + wait[0] + re.escape(wait[2]), body)) == 1
        assert len(re.findall(pair[0] + re.escape(pair[2]), body)) == 1
    for hook in (k5_rows._DECL, k5_rows._SETTER):
        src = src.replace(hook, "", 1)
    for hook in (k5_rows._START, end, wait[1], wait[2], pair[2]):
        src = src.replace(hook, "", 2)
    assert src == K5_SOURCE


def test_k5_kernel_has_no_early_return():
    """slotted_rows_kernel returns only at its end, where the patch waits
    for every thread and writes the block's record."""
    lo, hi = k5_rows._body(K5_SOURCE, "slotted_rows_kernel", "row_sweep.cu")
    assert re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", K5_SOURCE[lo:hi])) is None


def test_k5m_kernel_has_no_early_return():
    """masked_rows_kernel too (it skips a lin cluster no row gates in with
    a continue, uniform over the block)."""
    lo, hi = k5_rows._body(K5_SOURCE, "masked_rows_kernel", "row_sweep.cu")
    assert re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", K5_SOURCE[lo:hi])) is None
    bad = K5_SOURCE[:hi] + " if (tile < 0) return;" + K5_SOURCE[hi:]
    with pytest.raises(ValueError, match="masked_rows_kernel returns early"):
        k5_rows.patched_source(bad)


@pytest.mark.parametrize("old, new, match", [
    ("#include <cuda_runtime.h>\n", "#include <cuda.h>\n", "cuda_runtime"),
    ("    slotted_rows_kernel(Rays r,", "    slotted_kernel(Rays r,", "slotted_rows_kernel"),
    ("stage(lin4, cid, buf);", "stage(lin4, entry & 0xFFFF, buf);", "stage"),
    ("const unsigned act = ", "const unsigned rows_run = ", "act"),
])
def test_k5_patched_source_raises_on_a_missing_hook(old, new, match):
    """The include the declaration follows, the kernel's name, the staging
    of a lin cluster's table and its active rows (in both kernels): the
    patch fails where one goes missing."""
    assert old in K5_SOURCE
    with pytest.raises(ValueError, match=match):
        k5_rows.patched_source(K5_SOURCE.replace(old, new))


@pytest.mark.parametrize("old, new, match", [
    ("    masked_rows_kernel(Rays r,", "    masked_kernel(Rays r,", "masked_rows_kernel"),
    ("stage(lin4, cid, buf);", "stage(lin4, cid + 0, buf);", "masked_rows_kernel has 0"),
    ("const unsigned act = ", "const unsigned rows_in = ", "masked_rows_kernel has 0"),
])
def test_k5m_patched_source_raises_on_a_missing_hook(old, new, match):
    """The same hooks in masked_rows_kernel alone: the patch names the
    kernel that lost one."""
    lo, hi = k5_rows._body(K5_SOURCE, "masked_rows_kernel", "row_sweep.cu")
    start = K5_SOURCE.rfind("template", 0, lo)
    head, tail = K5_SOURCE[:start], K5_SOURCE[start:]
    assert tail.count(old) == 1
    with pytest.raises(ValueError, match=match):
        k5_rows.patched_source(head + tail.replace(old, new))


def test_k5_row_stats_of_a_known_record():
    """Three blocks: starts 0, 0, 10 ns, ends 10, 30, 20 ns; staged slots 2,
    4, 1 with 6, 8, 2 executed pairs (16 of 7: 2.286 rows a staged slot);
    wait clocks 10, 30, 0 of block clocks 100, 300, 100 (40 / 500 = 8%);
    two blocks at once balance their 50 ns to 25."""
    rec = np.array([[100, 110, 0, 2, 6, 10, 100, 3], [100, 130, 1, 4, 8, 30, 300, 0],
                    [110, 120, 0, 1, 2, 0, 100, 1]])
    st = k5_rows.row_stats(rec)
    assert st["blocks"] == 3 and st["max_resident"] == 2
    assert st["staged"] == 7 and st["pairs"] == 16 and st["pairs_max"] == 8
    assert st["rows_per_staged_slot"] == 16 / 7 and st["staging_share"] == 40 / 500
    np.testing.assert_allclose([st["span_ms"], st["last_after_median_ms"], st["balanced_ms"]],
                               np.array([30, 10, 25]) / 1e6)


def test_k7_patched_source_finds_every_hook():
    """The record's declarations and setter are added once; slab_kernel
    starts and ends with its clock reads and times each leg once; slab_walk
    counts each node step and each leaf visit once and times the staging
    once; the rest of the source is unchanged."""
    base = K7_SOURCE
    src = k7_walk.patched_source(base)
    assert src.count(k7_walk._DECL) == 1 and src.endswith(k7_walk._SETTER)
    lo, hi = k7_walk._body(src, "slab_kernel", k7_walk.FILE)
    assert src[lo:hi].startswith(k7_walk._START) and src[lo:hi].endswith(k7_walk._END)
    for func, pattern, before, after in k7_walk._HOOKS:
        lo, hi = k7_walk._body(src, func, k7_walk.FILE)
        m = re.search(pattern, base, re.S)
        assert src[lo:hi].count(m.expand(before) + m.group(0) + m.expand(after)) == 1
        src = src[:lo] + src[lo:hi].replace(m.expand(before), "", 1).replace(
            m.expand(after), "", 1) + src[hi:]
    for hook in (k7_walk._DECL, k7_walk._SETTER, k7_walk._START, k7_walk._END):
        src = src.replace(hook, "", 1)
    assert src == base


def test_k7_kernel_has_no_early_return():
    """slab_kernel returns only at its end, where the patch reads each
    warp's clock; the patch refuses a kernel that returns early."""
    lo, hi = k7_walk._body(K7_SOURCE, "slab_kernel", k7_walk.FILE)
    assert re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", K7_SOURCE[lo:hi])) is None
    bad = K7_SOURCE[:hi] + " if (!in) return;" + K7_SOURCE[hi:]
    with pytest.raises(ValueError, match="returns early"):
        k7_walk.patched_source(bad)


@pytest.mark.parametrize("old, new, match", [
    ("#include <cuda_runtime.h>\n", "#include <cuda.h>\n", "cuda_runtime"),
    ("slab_kernel(const SlabParams p)", "slab_walk_kernel(const SlabParams p)", "slab_kernel"),
    ("    float t_near;\n    bool hit = pbr::box_hit(lo.x", "    float tn;\n    bool hit = "
     "pbr::box_hit(lo.x", "t_near"),
    ("    if (lf >= 0) {\n      const int first = lf >> kCountBits;\n      const int cnt = min(",
     "    if (lf > -1) {\n      const int first = lf >> kCountBits;\n      const int cnt = min(",
     "lf >= 0"),
    ("__syncwarp();  // every lane is done with the previous slab",
     "__syncwarp();  // the previous slab is free", "previous slab"),
    ("slab_walk<true>(p, s, casts,", "slab_walk<true>(p, s, live && t_best < INFINITY,",
     "slab_walk<true>"),
])
def test_k7_patched_source_raises_on_a_missing_hook(old, new, match):
    """The include the declaration follows, the kernel's name, the node
    step, the leaf visit, the staging and the shadow leg's lanes: the patch
    fails where one goes missing."""
    assert K7_SOURCE.count(old) == 1
    with pytest.raises(ValueError, match=match):
        k7_walk.patched_source(K7_SOURCE.replace(old, new))


def test_k7_warp_stats_of_a_known_record():
    """Three warps that ran (and one row that never did): starts 0, 0, 10
    ns, ends 10, 40, 20 ns; node steps 10, 20, 6; leaf visits 2, 4, 0 with
    40, 24, 0 hitting lanes (64 of 6 x 32: SIMD 1/3, 10.67 a visit);
    staging 30 of 600 + 200 clocks, shadow 200 (25%); 50 shadow lanes, 5
    of them missed."""
    rec = np.array([[100, 110, 10, 2, 40, 10, 300, 100, 32, 5],
                    [100, 140, 20, 4, 24, 20, 300, 100, 18, 0],
                    [110, 120, 6, 0, 0, 0, 0, 0, 0, 0], [0] * 10])
    st = k7_walk.warp_stats(rec)
    assert st["warps"] == 3
    np.testing.assert_allclose(
        [st["span_ms"], st["median_end_ms"], st["last_after_median_ms"], st["mean_warp_ms"],
         st["longest_warp_ms"]], np.array([40, 20, 20, 20, 40]) / 1e6)
    assert st["node_steps_per_warp"] == 12 and st["leaf_visits_per_warp"] == 2
    assert st["leaf_simd"] == 64 / 192 and st["hitting_lanes_per_visit"] == 64 / 6
    assert st["staging_share"] == 30 / 800 and st["shadow_share"] == 200 / 800
    assert st["shadow_lanes"] == 50 and st["missed_shadow_lanes"] == 5


def test_k6_patched_source_finds_every_hook():
    """The record's declarations and setter are added once; packet_kernel
    starts and ends with its clock reads; ray_walk tallies each node step
    and each leaf face test once; the rest of the source is unchanged."""
    src = k6_walk.patched_source(K7_SOURCE)
    assert src.count(k6_walk._DECL) == 1 and src.endswith(k6_walk._SETTER)
    lo, hi = k6_walk._body(src, k6_walk.KERNEL, k6_walk.FILE)
    assert src[lo:hi].startswith(k6_walk._START) and src[lo:hi].endswith(k6_walk._END)
    lo, hi = k6_walk._body(src, k6_walk.WALK, k6_walk.FILE)
    body = src[lo:hi]
    assert body.count(k6_walk._NODE + k6_walk._NODE_ANCHOR) == 1
    assert body.count(k6_walk._LEAF_ANCHOR + " " + k6_walk._LEAF) == 1
    for hook in (k6_walk._DECL, k6_walk._SETTER, k6_walk._START, k6_walk._END, k6_walk._NODE,
                 " " + k6_walk._LEAF):
        src = src.replace(hook, "", 1)
    assert src == K7_SOURCE


def test_k6_kernel_has_no_early_return():
    """packet_kernel returns only at its end, where the patch reads each
    warp's clock and adds each lane's counters; the patch refuses a kernel
    that returns early."""
    lo, hi = k6_walk._body(K7_SOURCE, k6_walk.KERNEL, k6_walk.FILE)
    assert re.search(r"\breturn\b", re.sub(r"//[^\n]*", "", K7_SOURCE[lo:hi])) is None
    bad = K7_SOURCE[:hi] + " if (!in) return;" + K7_SOURCE[hi:]
    with pytest.raises(ValueError, match="returns early"):
        k6_walk.patched_source(bad)


@pytest.mark.parametrize("old, new, match", [
    ("#include <cuda_runtime.h>\n", "#include <cuda.h>\n", "cuda_runtime"),
    ("packet_kernel(const Params p)", "ray_kernel(const Params p)", "packet_kernel"),
    ("      float t_near;\n      const bool hit", "      float tn;\n      const bool hit",
     "t_near"),
    ("      for (int k = 0; k < cnt; ++k) {\n        const float4* g = p.faces",
     "      for (int k = 0; k != cnt; ++k) {\n        const float4* g = p.faces", "cnt"),
])
def test_k6_patched_source_raises_on_a_missing_hook(old, new, match):
    """The include the declaration follows, the kernel's name, the node
    step and the leaf loop of ray_walk: the patch fails where one goes
    missing."""
    assert K7_SOURCE.count(old) == 1
    with pytest.raises(ValueError, match=match):
        k6_walk.patched_source(K7_SOURCE.replace(old, new))


def test_k6_warp_stats_of_a_known_record():
    """Two warps that ran (and one row that never did): starts 0, 10 ns,
    ends 30, 20 ns; node iterations 10, 6 with 200 + 40 and 100 + 20 lanes
    (nearest + shadow: 360 of 16 x 32); leaf iterations 4, 2 with 64 + 16
    and 32 + 0 lanes. A mismatch with the plain walk's steps raises."""
    rec = np.array([[100, 130, 10, 200, 40, 4, 64, 16], [110, 120, 6, 100, 20, 2, 32, 0],
                    [0] * 8])
    st = k6_walk.warp_stats(rec, {"nearest": 300, "shadow": 60})
    assert st["warps"] == 2
    np.testing.assert_allclose([st["span_ms"], st["last_after_median_ms"], st["mean_warp_ms"]],
                               np.array([30, 5, 20]) / 1e6)
    assert st["node_iterations_per_warp"] == 8 and st["node_simd"] == 360 / 512
    assert st["shadow_node_lane_share"] == 60 / 360
    assert st["leaf_iterations_per_warp"] == 3 and st["leaf_simd"] == 112 / 192
    with pytest.raises(AssertionError, match="plain walk"):
        k6_walk.warp_stats(rec, {"nearest": 301})
