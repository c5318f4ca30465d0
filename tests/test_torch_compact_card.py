"""Kernels K13 and K14 and their backward, K13 bwd and K14 bwd
(``pbr_tpu_torch/ops/cuda_compact.py``), on the card; skipped without one
(the kernels have no CPU mode). A file without JAX: the CPU tests of the
plain versions are tests/test_torch_compact.py, whose ``random_case``
makes the plans here.

- Each instance bitwise its plain version on random plans (padding slots,
  over-capacity rows, a block of 6 lanes, every row live, and a 1024²
  stage: 8,192 rows of 128), with fields that hold -0.0, once with the
  4-lane loads and once from pointers off their alignment (one lane a
  thread); each launch counted once.
- A 64² frame and its gradients through the kernels bitwise the same frame
  and gradients through the plain versions.
- The graphed 1024² Cornell forward+backward step of the bench: its kernel
  nodes hold no ``indexing_backward_kernel`` (the sort of the old
  gathers' backward) and K13, K13 bwd, K14 and K14 bwd once a stage of the
  probed schedule each.
- The wrappers refuse a CUDA input of the wrong dtype, shape or device
  before any launch.

Run on the card: ``python -m pytest tests/test_torch_compact_card.py -m cuda``.
"""

import pytest
import torch

from pbr_tpu_torch import bench
from pbr_tpu_torch.models import integrator
from pbr_tpu_torch.ops import counts, cuda_compact, kernel_counts, zero_counts
from pbr_tpu_torch.ops.cuda_compact import Plan
from pbr_tpu_torch.parallel.mesh import render_params
from test_torch_compact import CASES, random_case

CARD_CASES = {**CASES, "1024² stage": (8192, 128, 6144, 0.7)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K13 and K14 have no CPU mode")
    return torch.device("cuda")


def _bits(a, b) -> bool:
    """Equal as stored, -0.0 apart from +0.0."""
    if a.dtype == torch.float32:
        return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def _shifted(xs: list) -> list:
    """Copies of ``xs`` that start one element past an aligned address."""
    out = []
    for x in xs:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:].copy_(x)
        out.append(buf[1:])
    return out


def _launched(name: str, fn):
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    assert {k: v for k, v in counts().items() if v} == {name: 1}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_each_instance_is_bitwise_its_plain_version(case, shift):
    dev = _card()
    plan, floats, ints, alive = random_case(*CARD_CASES[case], seed=7, dev=dev)
    move = _shifted if shift else list
    rows, block, cap = plan.slot.shape[0], plan.block, plan.cap
    ins = move([*floats, *ints, alive])
    got = _launched("K13", lambda: cuda_compact.compact_launch("K13", plan, ins, live=True))
    ref, ref_alive = cuda_compact.take_rows_plain(plan, ins[:-1], ins[-1])
    assert all(_bits(a, b) for a, b in zip(got, [*ref, ref_alive]))

    gen = torch.Generator(device=dev).manual_seed(11)
    g_out = move([torch.randn(cap * block, device=dev, generator=gen) for _ in range(9)])
    got = _launched("K13 bwd", lambda: cuda_compact.compact_launch("K13 bwd", plan, g_out))
    assert all(_bits(a, b) for a, b in zip(got, cuda_compact.take_rows_bwd_plain(plan, g_out)))

    cur = move([*g_out[:3], *(torch.randint(0, 9, (cap * block,), device=dev, generator=gen,
                                            dtype=dt) for dt in (torch.int32, torch.int64))])
    prev = move([*floats[:3], *ints])
    got = _launched("K14", lambda: cuda_compact.compact_launch("K14", plan, cur, prevs=prev))
    assert all(_bits(a, b) for a, b in zip(got, cuda_compact.fold_plain(plan, prev, cur)))

    g = move(floats[3:6])
    got = _launched("K14 bwd", lambda: cuda_compact.compact_launch("K14 bwd", plan, g))
    assert all(_bits(a, b) for a, b in zip(got, cuda_compact.fold_bwd_plain(plan, g)))
    assert rows * block == floats[0].shape[0]


@pytest.mark.cuda
def test_a_frame_and_its_gradients_through_the_kernels_are_the_plain_versions(monkeypatch):
    dev = _card()
    b = bench.differentiable(bench.bench_scene("cornell", 64, dev))
    stages = len(integrator.stage_plan(b.settings, 64 * 64)[1])
    assert stages > 0

    def run():
        params = list(render_params(b.scene, b.cam).values())
        res = integrator.trace_rays(b.scene, b.cam, b.settings, b.pixel_ids, 3)
        loss = res.color.x.sum() + res.color.y.sum() + res.color.z.sum()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        return [res.color.x.detach(), res.color.y.detach(), res.color.z.detach(),
                *(g for g in grads if g is not None)]

    zero_counts()
    got = run()
    launched = counts()
    assert [launched[k] for k in ("K13", "K13 bwd", "K14", "K14 bwd")] == [stages] * 4
    monkeypatch.setattr(cuda_compact, "compact_launch", cuda_compact.plain_launch)
    zero_counts()
    ref = run()
    assert not any(counts()[k] for k in ("K13", "K13 bwd", "K14", "K14 bwd"))
    assert len(got) == len(ref) and all(_bits(a, r) for a, r in zip(got, ref))


@pytest.mark.cuda
def test_the_graphed_backward_step_gathers_through_the_kernels_and_sorts_nothing():
    dev = _card()
    b = bench.differentiable(bench.bench_scene("cornell", 1024, dev))
    stages = len(integrator.stage_plan(b.settings, 1024 * 1024)[1])
    assert stages > 0, b.settings.compact_schedule
    fs = bench.FrameStep(b)
    fs(1, 1)
    names = fs.graph.kernels
    assert not [n for n in names if "indexing_backward_kernel" in n]
    per = kernel_counts(names)
    assert [per.get(k, 0) for k in ("K13", "K13 bwd", "K14", "K14 bwd")] == [stages] * 4, per


@pytest.mark.cuda
def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    plan, floats, ints, alive = random_case(*CASES["padding"], seed=1, dev=dev)
    bad = [
        ("K13", [floats[0].double()], None, False),  # float64
        ("K13", [floats[0][:-1]], None, False),  # short
        ("K13", [floats[0].cpu()], None, False),  # on the CPU
        ("K13", [torch.stack([floats[0], floats[0]], 1)[:, 0]], None, False),  # strided
        ("K13 bwd", [ints[0][:plan.cap * plan.block]], None, False),  # gradients are float32
        ("K14", [floats[0][:plan.cap * plan.block]], None, False),  # no prev
        ("K14", [floats[0][:plan.cap * plan.block]], [ints[0]], False),  # prev of another dtype
        ("K13", [floats[0]], None, True),  # the live field is not bool
        ("K13", [floats[0]] * 17, None, False),  # too many fields
    ]
    zero_counts()
    for name, ins, prevs, live in bad:
        with pytest.raises(ValueError):
            cuda_compact.compact_launch(name, plan, ins, prevs=prevs, live=live)
    with pytest.raises(ValueError):
        cuda_compact.compact_launch("K13", plan._replace(n_ok=plan.n_ok.long()), [floats[0]])
    with pytest.raises(ValueError):
        cuda_compact.compact_launch("K13", Plan(plan.src.cpu(), plan.slot, plan.n_ok, plan.cap,
                                                plan.block), [floats[0]])
    assert not any(counts().values())
