"""The step-0 tools of K1/K2, K3, K4m and K6 (``pbr_tpu_torch/tools/
k1_sweep.py``, ``k3_tiles.py``, ``k4_tiles.py --masked``, ``k6_chain.py``,
``k6_walk.py``), on the CPU:
their argument parsing, their clock patch against ``csrc/`` as it stands,
and their plain-side counts against sweeps and walks written out here.
The tools' kernel runs need a card."""

import numpy as np
import pytest
import torch

from pbr_tpu_torch.accel.forest import build_forest
from pbr_tpu_torch.ops import cuda_bvh as cb
from pbr_tpu_torch.ops import cuda_cull as cc
from pbr_tpu_torch.ops import cuda_gated as cg
from pbr_tpu_torch.ops import cuda_intersect as ci
from pbr_tpu_torch.ops.intersect import EPS5
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.device import to_torch
from pbr_tpu_torch.scene.procedural import multi_room, random_soup
from pbr_tpu_torch.tools import k1_sweep, k3_tiles, k4_tiles, k6_chain, k6_walk

torch.set_num_threads(1)

K3_SOURCE = (ci.CSRC / "gated_intersect.cu").read_text()
K6_SOURCE = (ci.CSRC / "bvh_packet.cu").read_text()
K4_SOURCE = (ci.CSRC / "cull_intersect.cu").read_text()
K1_SOURCE = (ci.CSRC / "brute_intersect.cu").read_text()


@pytest.mark.parametrize("source, kernel, tag", [
    (K3_SOURCE, "gated_kernel", "first"),
    (K6_SOURCE, "chain_kernel", "blockIdx.x"),
    (K4_SOURCE, "masked_kernel", "i"),
])
def test_clock_patch_finds_each_kernel(source, kernel, tag):
    """The record's declaration follows the include once, the setter ends
    the file, the kernel starts with its clock read and ends with the
    record of ``tag``; the rest is the source. A kernel that returns early
    is refused."""
    src = k3_tiles.clock_patch(source, "x.cu", kernel, tag)
    assert src.count(k3_tiles._DECL) == 1 and src.endswith(k3_tiles._SETTER)
    lo, hi = k3_tiles._body(src, kernel)
    end = k3_tiles._END.replace("@TAG@", tag)
    assert src[lo:hi].startswith(k3_tiles._START) and src[lo:hi].endswith(end)
    for hook in (k3_tiles._DECL, k3_tiles._SETTER, k3_tiles._START, end):
        src = src.replace(hook, "", 1)
    assert src == source
    lo, hi = k3_tiles._body(source, kernel)
    with pytest.raises(ValueError, match="returns early"):
        k3_tiles.clock_patch(source[:lo] + " return; " + source[lo:], "x.cu", kernel, tag)


@pytest.mark.parametrize("tool", [k3_tiles, k6_chain, k4_tiles, k6_walk, k1_sweep],
                         ids=["k3_tiles", "k6_chain", "k4_tiles", "k6_walk", "k1_sweep"])
def test_tool_parses_its_arguments_and_needs_a_card(tool, tmp_path):
    """Each tool refuses an option it does not have, and without a card it
    stops before it builds or writes anything."""
    with pytest.raises(SystemExit) as err:
        tool.main(["--steps", "a"])
    assert err.value.code == 2  # argparse's usage error
    out = tmp_path / "x.json"
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--out", str(out)])
    assert not out.exists()


def _gated_passes(n=512, seed=3):
    """Multiroom's two K3 passes (plain) on rays inside the rooms, two
    lanes of three alive, light 0: their recorded arguments."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    ts = to_torch(scene, "cpu")
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2.8, 2.8, n), rng.uniform(0.1, 1.9, n),
                  rng.uniform(-4.8, 0.8, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    passes = []
    cg._gated(lambda *a: passes.append(a) or cg._sweep_plain(*a),
              Vec3(*map(torch.tensor, o)), Vec3(*map(torch.tensor, d)), ts.tris, ts.clusters,
              Vec3(*(torch.tensor(v) for v in (0.0, 1.75, 0.0))),
              torch.tensor(np.arange(n) % 3 != 0), 2, False)
    real = cg.real_faces(int(ts.tris.mtl.shape[0]), ts.clusters.count, "cpu")
    return passes, real


def _sweep_in_order(args, real):
    """The counts of ``pass_counts`` from a sweep written face by face:
    gated-in real-face tests, the tests whose t can change the result, and
    for nearest those whose t beats the running best."""
    o, d, tab, verdict, tile, seed_t, _, t_limit = args
    out = cg._sweep_plain(*args)
    best = seed_t.clone()
    c_all = ci.cross_od(o, d)
    gate = verdict.repeat_interleave(tile, dim=0)  # (rays, C)
    tests = uv = running = 0
    for f in range(tab.shape[1]):
        c = f // cg.GATE_CLUSTER
        on = gate[:, c] & (f % cg.GATE_CLUSTER < real[c])
        t, valid = ci.mt_lin(o, d, c_all, tab[:, f, None].expand(16, o.x.shape[0]))
        ok = on & (t >= EPS5)
        tests += int(on.sum())
        if t_limit is None:
            uv += int((ok & (t <= out[0])).sum())
            running += int((ok & (t < best)).sum())
            best = torch.where(on & valid & (t < best), t, best)
        else:
            n = int((ok & (t < t_limit) & (best == 0)).sum())
            uv, running = uv + n, running + n
            best = torch.where(on & valid & (t < t_limit), 1.0, best)
    return tests, uv, running


def test_k3_pass_counts_match_a_sweep_in_order():
    """``pass_counts`` (one cluster at a time, cumulative minima) against a
    sweep written face by face, on both passes; the test count is the
    ``n_tests`` counter's; dead lanes (nearest) and occluded or seeded-1
    lanes (any-hit) are closed at every section they meet."""
    passes, real = _gated_passes()
    for args in passes:
        counts = k3_tiles.pass_counts(args, real)
        tests, uv, running = _sweep_in_order(args, real)
        assert (counts["tests"], counts["uv_tests"], counts["uv_running"]) == (tests, uv, running)
        assert 0 < counts["uv_tests"] <= counts["uv_running"] < counts["tests"]
        verdict, tile = args[3], args[4]
        assert counts["tests"] == int((verdict.to(torch.int64) * real).sum()) * tile
        assert counts["sections"] == int(verdict.sum()) and counts["tiles"] == verdict.shape[0]
        closed0 = ~(args[5] > EPS5) if args[7] is None else args[5] > 0
        at_entry = int((verdict.to(torch.int64)
                        * closed0.reshape(-1, tile).sum(dim=1, keepdim=True)).sum())
        assert counts["closed_lanes"] >= at_entry > 0
        if args[7] is None:  # nearest: lanes never close during the sweep
            assert counts["closed_lanes"] == at_entry
        assert 0 <= counts["closed_warps"] <= counts["warps"]


@pytest.mark.parametrize("alive", [False, True], ids=["all-live", "alive-mask"])
def test_k6_chain_counts_match_the_plain_chain(alive):
    """Node steps and face tests a ray over sub-trees 1..K-1 equal the
    plain chain's counters; any-hit: the warps entering each sub-tree fully
    occluded or dead, from the occlusion after the sub-trees before it."""
    ps, _ = scene_from_text(random_soup(700, seed=0), use_bvh=True)
    ts = to_torch(ps._replace(forest=build_forest(ps.tris, chunk=256)), "cpu")
    fo = ts.forest
    n = 1000
    rng = np.random.default_rng(7)
    o = Vec3(*map(torch.tensor, rng.uniform(-1.2, 1.2, (3, n)).astype(np.float32)))
    dd = rng.normal(size=(3, n))
    d = Vec3(*map(torch.tensor, (dd / np.linalg.norm(dd, axis=0)).astype(np.float32)))
    al = torch.tensor(np.arange(n) % 4 != 0) if alive else None
    lim = torch.tensor(rng.uniform(0.0, 1.5, n).astype(np.float32))
    for t_limit in (None, lim):
        counts = k6_chain.chain_counts(fo, o, d, al, None, 4, t_limit)
        first = cb.walk_plain(o, d, fo.tree(0), fo.faces[:, :256], 4, al, t_limit=t_limit)
        rest = fo.subtrees(1, fo.count)
        work = []
        w = cb.Walk("K6 seeded" if t_limit is None else "K6 seeded any-hit", o, d, rest,
                    rest.faces, 4, al, face_base=256, t_seed=first[0], f_seed=first[1],
                    t_limit=t_limit, occ_seed=None if t_limit is None else first[2])
        cb._run_plain(w, work)
        assert counts["subtrees"] == fo.count - 1 == len(work)
        assert counts["node_steps_per_ray"] == sum(int(v.sum()) for _, v in work) / n
        assert counts["face_tests_per_ray"] == sum(int(t.sum()) for t, _ in work) / n
        if t_limit is None:
            assert "warps_entering_occluded" not in counts
            continue
        entering = counts["warps_entering_occluded"]
        assert len(entering) == fo.count - 1 and entering == sorted(entering)
        done = first[2] if al is None else first[2] | ~al
        done = torch.cat([done, done.new_ones((-n) % 32)]).reshape(-1, 32)
        assert entering[0] == int(done.all(dim=1).sum())


def _masked_passes(n=1024, seed=3):
    """Multiroom's two K4m passes (plain) on rays inside the rooms, two
    lanes of three alive, light 0: their recorded arguments."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=True)
    ts = to_torch(scene, "cpu")
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2.8, 2.8, n), rng.uniform(0.1, 1.9, n),
                  rng.uniform(-4.8, 0.8, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    passes = []
    cc._cull(cc._slotted_plain, lambda *a: passes.append(a) or cc._masked_plain(*a),
             Vec3(*map(torch.tensor, o)), Vec3(*map(torch.tensor, d)), ts.clusters,
             Vec3(*(torch.tensor(v) for v in (0.0, 1.75, 0.0))),
             torch.tensor(np.arange(n) % 3 != 0), "highest")
    return passes


@pytest.mark.parametrize("pass_i", [0, 1], ids=["nearest", "any-hit"])
def test_k4m_pass_counts_match_a_sweep_in_order(pass_i):
    """``k4_tiles.pass_counts`` (one cluster at a time for the tiles that
    gate it in) against a sweep written face by face over the gated-in
    clusters in ascending order: real-face tests, and the tests whose t can
    change the result (the bound's u-v tests: nearest ``1e-5 <= t <=`` the
    final t; any-hit below t_limit on a ray not occluded yet); the plain
    result is the pass's."""
    args = _masked_passes()[pass_i]
    out, counts, slots = k4_tiles.pass_counts("K4m", args)
    feats, table, mask, seed_t, seed_f, any_hit = args
    ref = cc._masked_plain(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(a, b)
    f = torch.stack(list(feats)).reshape(cc.FEATURE_ROWS, 1, -1)
    gate = mask.repeat_interleave(cc.TILE, dim=0)
    real = (table[:, :, 0:3] != 0).any(dim=2)
    best = seed_t.clone()
    tests = uv = 0
    for c in range(table.shape[0]):
        for j in range(table.shape[1]):
            on = gate[:, c] & real[c, j]
            t, valid = (x[0, :, 0] for x in cc._face_test(table[c:c + 1, j:j + 1], f))
            tests += int(on.sum())
            if any_hit:
                uv += int((on & (t >= EPS5) & (t < f[10, 0]) & (best == 0.0)).sum())
                best = torch.where(on & valid & (t < f[10, 0]), 1.0, best)
            else:
                uv += int((on & (t >= EPS5) & (t <= ref[0])).sum())
    assert (counts["tests"], counts["uv_tests"]) == (tests, uv)
    assert 0 < counts["uv_tests"] < counts["tests"]
    assert counts["sections"] == int(mask.sum()) == int(slots.sum())
    assert counts["warps"] == counts["sections"] * cc.TILE // 32
    assert 0 <= counts["closed_warps"] <= counts["warps"]
    assert counts["closed_lanes"] >= int((gate.sum(dim=1) * (
        (seed_t > 0) if any_hit else ~(seed_t >= EPS5))).sum()) > 0


@pytest.mark.parametrize("early_return", [False, True], ids=["as-built", "early-return"])
def test_k1_record_patch_finds_the_kernel(early_return):
    """The record's declaration follows the include once, the setter ends
    the file, the kernel starts with its clock read and ends with the
    record, which also comes before each ``return`` (an earlier tree's
    kernel returned early without NEE); the rest is the source."""
    source = K1_SOURCE
    if early_return:
        lo, _ = k1_sweep._body(source, k1_sweep.KERNEL, k1_sweep.FILE)
        source = source[:lo] + " if (!NEE) return; " + source[lo:]
    src = k1_sweep.record_patch(source)
    assert src.count(k3_tiles._DECL) == 1 and src.endswith(k3_tiles._SETTER)
    end = k3_tiles._END.replace("@TAG@", "blockIdx.x")
    lo, hi = k1_sweep._body(src, k1_sweep.KERNEL, k1_sweep.FILE)
    assert src[lo:hi].startswith(k3_tiles._START) and src[lo:hi].endswith(end)
    assert src[lo:hi].count(end) == (2 if early_return else 1)
    src = src.replace("{" + end + "return; }", "return;")
    for hook in (k3_tiles._DECL, k3_tiles._SETTER, k3_tiles._START, end):
        src = src.replace(hook, "", 1)
    assert src == source


def test_sass_loops_reads_a_listing():
    """Two kernels of a cuobjdump listing: the loop between a backward
    branch and its target, with its instructions, shared loads, float32
    arithmetic and MUFU; a forward branch is no loop."""
    listing = """
        Function : _Z1aPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   LDS.128 R4, [R2] ;       /* 0x0 */
        /*0020*/                   FMUL R5, R4, R6 ;        /* 0x0 */
        /*0030*/                   FSETP.GT.AND P0, PT, R5, RZ, PT ;
        /*0040*/              @!P0 BRA 0x70 ;
        /*0050*/                   MUFU.RCP R7, R5 ;
        /*0060*/                   FADD R8, R7, R7 ;
        /*0070*/               @P1 BRA 0x10 ;
        /*0080*/                   EXIT ;
        Function : _Z1bPf
        /*0000*/                   EXIT ;
"""
    out = k1_sweep.sass_loops(listing)
    assert out["_Z1aPf"] == {"instructions": 9, "loops": [
        {"start": "0x10", "end": "0x70", "instructions": 7, "lds": 1, "fp32": 3, "mufu": 1}]}
    assert out["_Z1bPf"] == {"instructions": 1, "loops": []}


def _brute_in_order(o, d, table, light):
    """``sweep_counts`` written face by face: the nearest sweep's tests and
    those whose t can change the result or whose division can be skipped;
    the shadow sweep's up to each ray's first occluder."""
    lin = table.shape[0] == 16
    n, nf = o.x.shape[0], table.shape[1]
    t_fin, _ = ci.intersect_fused_plain(o, d, table)
    hit_p, s_dir, t_light = ci._shadow_ray(o, d, t_fin, light)
    res = dict.fromkeys(("tests", "uv_tests", "skip_tests", "shadow_tests", "shadow_uv_tests",
                         "shadow_skip_tests"), 0)
    occ = torch.zeros(n, dtype=torch.bool)
    for f in range(nf):
        col = table[:, f, None].expand(table.shape[0], n)
        for leg, (oo, dd) in (("", (o, d)), ("shadow_", (hit_p, s_dir))):
            det, tnum = k1_sweep._det_tnum(oo, dd, col)
            t, valid = k1_sweep._test(oo, dd, col)
            skip = ~((torch.fmin(det, tnum) > 0.0) | (torch.fmax(det, tnum) < 0.0))
            on = ~occ if leg else torch.ones(n, dtype=torch.bool)
            bound = t_fin if not leg else t_light
            below = (t >= EPS5) & ((t <= bound) if not leg else (t < bound))
            res[leg + "tests"] += int(on.sum())
            res[leg + "uv_tests"] += int((on & below).sum())
            res[leg + "skip_tests"] += int((on & skip).sum())
            if leg:
                occ |= on & valid & (t < t_light)
    return res, occ


@pytest.mark.parametrize("form", ["mt", "lin"])
def test_k1_sweep_counts_match_a_sweep_in_order(form):
    """``sweep_counts`` (rays a chunk at a time, the first occluder by a
    minimum) against a sweep written face by face, on multiroom's faces
    and rays inside its rooms (a ragged last warp); the occluded rays are
    the plain version's."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=False)
    tris = to_torch(scene, "cpu").tris
    table = ci.lin_table(tris) if form == "lin" else ci.face_table(tris)
    rng = np.random.default_rng(5)
    n = 100
    o = np.stack([rng.uniform(-2.8, 2.8, n), rng.uniform(0.1, 1.9, n),
                  rng.uniform(-4.8, 0.8, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o, d = Vec3(*map(torch.tensor, o)), Vec3(*map(torch.tensor, d))
    light = torch.tensor([0.0, 1.75, 0.0])
    got = k1_sweep.sweep_counts(o, d, table, light)
    want, occ = _brute_in_order(o, d, table, light)
    assert {k: got[k] for k in want} == want
    assert torch.equal(occ, ci.intersect_fused_plain(o, d, table, light)[2])
    assert got["occluded"] == int(occ.sum()) and got["warps"] == 4
    pad = torch.cat([occ, torch.ones(28, dtype=torch.bool)])
    assert got["occluded_warps"] == int(pad.reshape(-1, 32).all(dim=1).sum())
    assert 0 < got["skip_tests"] < got["tests"] and 0 < got["uv_tests"] < got["tests"]


@pytest.mark.parametrize("form", ["mt", "lin"])
def test_k1_sweep_counts_do_not_depend_on_the_chunk(form, monkeypatch):
    """``sweep_counts`` in chunks of 32 rays (three whole warps and a
    ragged last chunk of 4) gives the counts of one chunk of all rays."""
    scene, _ = scene_from_text(*multi_room(), use_bvh=False)
    tris = to_torch(scene, "cpu").tris
    table = ci.lin_table(tris) if form == "lin" else ci.face_table(tris)
    rng = np.random.default_rng(6)
    n = 100
    o = np.stack([rng.uniform(-2.8, 2.8, n), rng.uniform(0.1, 1.9, n),
                  rng.uniform(-4.8, 0.8, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o, d = Vec3(*map(torch.tensor, o)), Vec3(*map(torch.tensor, d))
    light = torch.tensor([0.0, 1.75, 0.0])
    whole = k1_sweep.sweep_counts(o, d, table, light)
    monkeypatch.setattr(k1_sweep, "SWEEP_ELEMS", 32 * table.shape[1])
    assert k1_sweep.sweep_counts(o, d, table, light) == whole
