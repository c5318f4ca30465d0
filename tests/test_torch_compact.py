"""Live-path compaction (``pbr_tpu_torch/ops/cuda_compact.py``: the plain
versions of kernels K13, K13 bwd, K14 and K14 bwd, and the autograd
Functions that run them) on the CPU.

- ``take_rows`` and ``fold`` against the integrator's gathers before the
  kernels (advanced indexing; its backward, autograd's index_put with
  accumulate), on random fields over plans with padding slots (live rows
  fewer than the capacity), over-capacity rows (dropped) and clamped fold
  slots: the forward bitwise, the backward equal as numbers (the
  scatter-add turns a -0.0 gradient into +0.0) where the padding lanes'
  upstream gradient is 0, which the next test holds on whole frames.
- On 24² Cornell and multiroom frames with a three-entry schedule, under
  autograd: the upstream gradient of every padding lane that K13 bwd's
  plain version receives is exactly 0, and every gradient of the frame
  equals, as numbers, that of the same frame through the old gathers.
- The port's gradients through a compaction schedule against ``jax.grad``
  of the JAX package's ``trace_rays`` with the same schedule (Cornell and
  multiroom at 16², ``compact_block`` 16), with tests/test_torch_grad.py's
  tolerances. JAX is imported inside that test alone: the card tests
  (tests/test_torch_compact_card.py, a file without JAX) take their
  plans from ``random_case`` here.
"""

import numpy as np
import pytest
import torch

from pbr_tpu_torch import camera_to_torch, to_torch, trace_rays
from pbr_tpu_torch.models import integrator
from pbr_tpu_torch.ops import cuda_compact
from pbr_tpu_torch.ops.cuda_compact import Plan, fold, take_rows
from pbr_tpu_torch.parallel.mesh import leaf_camera, render_params
from pbr_tpu_torch.scene.build import derive_static_flags, scene_from_text
from pbr_tpu_torch.scene.camera import make_camera_state
from pbr_tpu_torch.scene.procedural import cornell_box, multi_room
from pbr_tpu_torch.utils.config import RenderSettings

torch.set_num_threads(1)

# (rows, block, cap, live rows' share): padding slots; over capacity; a
# block of 6 (the kernels' one-lane-a-thread path); everything live.
CASES = {
    "padding": (64, 16, 48, 0.55),
    "over capacity": (64, 16, 20, 0.6),
    "block 6": (50, 6, 37, 0.5),
    "all live": (32, 8, 32, 1.0),
}


def random_case(rows: int, block: int, cap: int, live: float, seed: int = 0, dev="cpu"):
    """A plan from ``_compact_rows`` over random liveness (a ``live`` share
    of rows with 30% of their lanes alive, one lane at least) and the
    stage's fields, from a numpy seed: ``(plan, floats, ints, alive)``:
    nine float32 fields (5% of them -0.0), an int32 and an int64 field."""
    r = np.random.default_rng(seed)
    lanes = r.random((rows, block)) < 0.3
    lanes[np.arange(rows), r.integers(0, block, rows)] = True
    lanes[r.random(rows) >= live] = False
    alive = torch.as_tensor(lanes.reshape(-1), device=dev)
    src, slot, n_ok, _ = integrator._compact_rows(alive, block, cap)
    n = rows * block

    def f32():
        x = r.standard_normal(n).astype(np.float32)
        x[r.random(n) < 0.05] = -0.0
        return torch.as_tensor(x, device=dev)

    ints = [torch.as_tensor(r.integers(-5, 9, n).astype(np.int32), device=dev),
            torch.as_tensor(r.integers(0, 2**32, n).astype(np.int64), device=dev)]
    return Plan(src, slot, n_ok, cap, block), [f32() for _ in range(9)], ints, alive


def old_take(plan: Plan, v):
    """The integrator's stage gather before K13."""
    return v.reshape(-1, plan.block)[plan.src].reshape(-1)


def old_fold(plan: Plan, prev, cur):
    """The integrator's fold before K14, op for op."""
    ok_row = plan.slot < plan.cap
    sc = plan.slot.clamp_max(plan.cap - 1)
    ok_lane = ok_row[:, None].expand(ok_row.shape[0], plan.block).reshape(-1)
    return prev + torch.where(ok_lane, cur.reshape(-1, plan.block)[sc].reshape(-1),
                              torch.zeros_like(prev))


def _padding(plan: Plan):
    """(cap*block,) bool: the lanes of the slots past the live count."""
    return ~(torch.arange(plan.cap, dtype=torch.int32) < plan.n_ok)[:, None].expand(
        plan.cap, plan.block).reshape(-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_take_rows_is_the_old_gather_and_its_backward_the_scatter_add(case):
    plan, floats, ints, alive = random_case(*CASES[case], seed=1)
    assert case != "padding" or int(plan.n_ok) < plan.cap
    assert case != "over capacity" or int((plan.slot == plan.cap).sum()) > int(
        (alive.reshape(-1, plan.block).any(1) == 0).sum())
    leaves = [x.clone().requires_grad_() for x in floats]
    got, got_alive = take_rows(plan, [*leaves, *ints], alive)
    valid = ~_padding(plan)
    for a, x in zip(got, [*floats, *ints]):
        assert torch.equal(a, old_take(plan, x)) and a.dtype == x.dtype
    assert torch.equal(got_alive, old_take(plan, alive) & valid)
    assert not got_alive.requires_grad and not got[9].requires_grad
    r = np.random.default_rng(2)
    ups = [torch.as_tensor(r.standard_normal(a.shape[0]).astype(np.float32)) * valid
           for a in got[:9]]
    mine = torch.autograd.grad(got[:9], leaves, ups)
    ref_leaves = [x.clone().requires_grad_() for x in floats]
    ref = torch.autograd.grad([old_take(plan, x) for x in ref_leaves], ref_leaves, ups)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_is_the_old_fold_and_its_backward_the_scatter_add(case):
    plan, outer, ints, _ = random_case(*CASES[case], seed=3)
    rows, block, cap = plan.slot.shape[0], plan.block, plan.cap
    r = np.random.default_rng(4)
    inner = [torch.as_tensor(r.standard_normal(cap * block).astype(np.float32))
             for _ in range(3)]
    inner_ints = [torch.as_tensor(r.integers(0, 7, cap * block).astype(np.int32))
                  for _ in range(4)]
    outer_ints = [ints[0]] + [torch.as_tensor(r.integers(0, 7, rows * block).astype(np.int32))
                              for _ in range(3)]
    prev = [x.clone().requires_grad_() for x in outer[:3]]
    cur = [x.clone().requires_grad_() for x in inner]
    got = fold(plan, [*prev, *outer_ints], [*cur, *inner_ints])
    for a, p, c in zip(got, [*outer[:3], *outer_ints], [*inner, *inner_ints]):
        assert torch.equal(a, old_fold(plan, p, c)) and a.dtype == p.dtype
    assert [a.requires_grad for a in got] == [True] * 3 + [False] * 4
    ups = [torch.as_tensor(r.standard_normal(rows * block).astype(np.float32)) for _ in range(3)]
    mine = torch.autograd.grad(got[:3], [*prev, *cur], ups)
    rp = [x.clone().requires_grad_() for x in outer[:3]]
    rc = [x.clone().requires_grad_() for x in inner]
    ref = torch.autograd.grad([old_fold(plan, p, c) for p, c in zip(rp, rc)], [*rp, *rc], ups)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_the_plain_backward_reads_the_inverse_maps():
    """K13 bwd's and K14 bwd's plain versions on a hand-made plan: rows 1
    and 3 live of 4, capacity 3 (slot 2 pads with row 0)."""
    plan = Plan(torch.tensor([1, 3, 0], dtype=torch.int32),
                torch.tensor([3, 0, 3, 1], dtype=torch.int32),
                torch.tensor(2, dtype=torch.int32), 3, 2)
    g = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    (g_in,) = cuda_compact.take_rows_bwd_plain(plan, [g])
    assert g_in.tolist() == [0.0, 0.0, 1.0, 2.0, 0.0, 0.0, 3.0, 4.0]
    (g_cur,) = cuda_compact.fold_bwd_plain(plan, [torch.arange(1.0, 9.0)])
    assert g_cur.tolist() == [3.0, 4.0, 7.0, 8.0, 0.0, 0.0]


# ------------------------------------------------------------ whole frames --

SCHEDULE = ((1, 0.9), (3, 0.7), (5, 0.4))


def _frame_case(name: str, size: int, block: int, schedule):
    cam = make_camera_state(eye=(0.0, 1.0, 3.2 if name == "cornell" else 3.0),
                            center_dir=(0.0, 0.0, 1.0))
    scene, _ = scene_from_text(*(cornell_box() if name == "cornell" else multi_room()),
                               use_bvh=name != "cornell")
    settings = derive_static_flags(scene, RenderSettings(
        width=size, height=size, samples=1, max_depth=3, max_added_depth=5, shadow_rays=1,
        anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0), compact_block=block,
        compact_schedule=schedule))
    return to_torch(scene, "cpu"), camera_to_torch(cam, "cpu"), settings


def _frame_grads(ts, tc, settings) -> list:
    """Every parameter's gradient of the frame's colour sum (bench.py's
    loss), the scene's and the camera's."""
    ts.requires_grad_()
    try:
        cam = leaf_camera(tc)
        params = list(render_params(ts, cam).values())
        ids = torch.arange(settings.width * settings.height, dtype=torch.int32)
        c = trace_rays(ts, cam, settings, ids, 5).color
        got = torch.autograd.grad(c.x.sum() + c.y.sum() + c.z.sum(), params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]
    finally:
        ts.requires_grad_(False)


@pytest.mark.parametrize("name", ["cornell", "multiroom"])
def test_padding_lanes_get_no_gradient_and_the_frame_the_old_gradients(name, monkeypatch):
    """Every K13 bwd call of a 24² frame's backward (three schedule
    entries, blocks of 16 lanes) gets an upstream gradient of exactly 0 on
    the lanes of its padding slots, and some of them have padding; the
    frame's gradients equal, as numbers, those of the same frame through
    the old gathers and fold."""
    ts, tc, settings = _frame_case(name, 24, 16, SCHEDULE)
    seen = []
    real = cuda_compact.take_rows_bwd_plain

    def spy(plan, grads):
        pad = _padding(plan)
        seen.append((int(pad.sum()), max(float(g[pad].abs().max()) if pad.any() else 0.0
                                         for g in grads),
                     max(float(g.abs().max()) for g in grads)))
        return real(plan, grads)

    monkeypatch.setattr(cuda_compact, "take_rows_bwd_plain", spy)
    got = _frame_grads(ts, tc, settings)
    assert len(seen) == len(SCHEDULE), seen
    assert any(n for n, _, _ in seen), f"no stage of the frame has a padding slot: {seen}"
    assert all(pad == 0.0 for _, pad, _ in seen), seen
    assert any(top > 0.0 for _, _, top in seen), seen
    monkeypatch.undo()

    def take_old(plan, fields, alive):
        valid = ~_padding(plan)
        return [old_take(plan, v) for v in fields], old_take(plan, alive) & valid

    def fold_old(plan, prev, cur):
        return [old_fold(plan, p, c) for p, c in zip(prev, cur)]

    monkeypatch.setattr(integrator, "take_rows", take_old)
    monkeypatch.setattr(integrator, "fold", fold_old)
    ref = _frame_grads(ts, tc, settings)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert max(float(g.abs().max()) for g in got) > 0.0


@pytest.mark.parametrize("name, squared", [("cornell", True), ("multiroom", False)])
def test_grads_through_a_schedule_match_jax_grad(name, squared):
    """tests/test_torch_grad.py's comparison (the pixels whose colours
    agree within 1e-3; rtol 1e-4 plus 1e-5 of the largest magnitude; the
    losses within 1e-5) on its Cornell and multiroom setups at 16² with
    ``compact_block`` 16 and the schedule ((1, 0.73), (2, 0.3)) on both
    sides: the port's stages run K13 / K14's plain versions and their
    backward, the JAX package's XLA's gathers and scatter-adds."""
    import test_torch_grad as tg

    key = f"{name}, compacted"
    if key not in tg.SETUPS:
        base = tg.SETUPS[name]

        def setup():
            scene, cam, settings = base()
            return scene, cam, settings.replace(compact_block=16,
                                                compact_schedule=((1, 0.73), (2, 0.3)))

        tg.SETUPS[key] = setup
    scene, _, settings = tg.SETUPS[key]()
    block, schedule = integrator.stage_plan(settings, settings.width * settings.height)
    assert block == 16 and [c for _, c in schedule] == [12, 5]
    (loss, got), (ref_loss, ref) = tg._matched_grads(key, squared)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert set(got) == set(ref)
    for p in ref:
        assert np.isfinite(got[p]).all(), p
        tg._close(got[p], ref[p])
    assert np.abs(got["mat_kd"]).max() > 1e-4 and np.abs(got["light_rgb"]).max() > 1e-4
