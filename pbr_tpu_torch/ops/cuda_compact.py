"""Kernels K13 and K14: live-path compaction's row gathers and the fold back,
CUDA for Hopper, and their backward, K13 bwd and K14 bwd; with their plain
PyTorch versions.

The JAX package compacts the live lanes between the stages of a frame's
bounce loop with XLA's gathers, and ``jax.grad`` turns each into a
scatter-add (``pbr_tpu/models/integrator.py::_take_rows`` :243-245, the
stage gathers :863-876, the fold :899-911). These kernels are the port's
counterpart (``csrc/compact.cu``, whose header says what bounds them and
how the design answers it); they replace no Pallas kernel:

- **K13** (``take_rows``): one launch a schedule stage gathers every field
  that the next stage takes through the plan's ``src`` (o, d, colour, the
  depth budget, the pixel x, the RNG key, and ``alive`` masked dead past
  the live count ``n_ok``);
- **K14** (``fold``): one launch a folded stage adds the deeper stage's
  rows back into the outer stage's lanes through ``slot`` (the colour, the
  secondary count, and with ``with_stats`` the counters);
- **K13 bwd** and **K14 bwd**: their adjoints, gathers through the inverse
  map (``slot`` for K13, ``src`` for K14), run by the autograd Functions
  ``_TakeRowsFn`` and ``_FoldFn``. The rows a stage gathers are unique by
  construction, so neither sorts, neither needs atomics.

A slot past ``n_ok`` repeats row 0 and adds nothing to row 0's gradient:
autograd's scatter-add of the plain gather gives the same numbers wherever
the padding lanes' upstream gradient is 0 (``tests/test_torch_compact.py``
holds it on whole frames), up to the sign of a zero (the scatter-add adds
a gradient of -0.0 to +0.0).

Dispatch: a CPU tensor runs the plain version, a CUDA tensor the kernel,
which raises when it does not build or launch. Where
``torch.is_grad_enabled()`` and a field requires grad, the call runs inside
its Function, on either device. ``launches`` counts kernel launches; a
launch under capture counts at its graph's replays (``ops.counts``).
Nothing is built or imported for CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pbr_tpu_torch.ops import count_launch
from pbr_tpu_torch.ops.cuda_intersect import load
from pbr_tpu_torch.ops.cuda_shade import _wants_grad

launches = {"K13": 0, "K13 bwd": 0, "K14": 0, "K14 bwd": 0}

_MODES = {"K13": 0, "K13 bwd": 1, "K14": 2, "K14 bwd": 3}
# A field's element type (csrc/compact.cu's kinds); K13's alive field is
# _LIVE: masked dead past the live count.
_KINDS = {torch.float32: 0, torch.int32: 1, torch.int64: 2, torch.bool: 3}
_LIVE = 4
_MAX_FIELDS = 16
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]


class Plan(NamedTuple):
    """A stage's compaction plan (``models/integrator.py::_compact_rows``):
    lanes in rows of ``block``; ``src`` (cap,) int32 each compact slot's
    row, 0 past the live count; ``slot`` (R,) int32 each row's slot, ``cap``
    where it has none; ``n_ok`` () int32 the slots that hold a live row."""

    src: torch.Tensor
    slot: torch.Tensor
    n_ok: torch.Tensor
    cap: int
    block: int


def _rows(v, block: int):
    return v.reshape(-1, block)


def _live_rows(plan: Plan):
    """(cap, 1) bool: the compact slots that hold a live row."""
    return (torch.arange(plan.cap, dtype=torch.int32, device=plan.src.device)
            < plan.n_ok)[:, None]


def take_rows_plain(plan: Plan, fields: list, alive) -> tuple:
    """K13's function in torch ops: each of ``fields`` (R*block,) gathered
    by rows through ``src`` into (cap*block,), and ``alive`` too, masked
    dead in the slots past ``n_ok`` (which repeat row 0). Returns
    ``(fields, alive)``."""
    tr = lambda v: _rows(v, plan.block)[plan.src].reshape(-1)  # noqa: E731
    return [tr(v) for v in fields], (_rows(tr(alive), plan.block) & _live_rows(plan)).reshape(-1)


def take_rows_bwd_plain(plan: Plan, grads: list) -> list:
    """K13 bwd's function: each (cap*block,) gradient gathered back through
    the inverse map, ``g_in[r] = slot[r] < n_ok ? g[slot[r]] : 0`` a row,
    (R*block,)."""
    ok = (plan.slot < plan.n_ok)[:, None]
    sc = plan.slot.clamp_max(plan.cap - 1)
    return [torch.where(ok, _rows(g, plan.block)[sc], 0.0).reshape(-1) for g in grads]


def fold_plain(plan: Plan, prev: list, cur: list) -> list:
    """K14's function: ``prev[r] + (slot[r] < cap ? cur[slot[r]] : 0)`` a
    row, for each pair of the outer stage's (R*block,) and the deeper
    stage's (cap*block,) fields, the add on every lane (the integrator's
    fold before K14, op for op)."""
    ok = (plan.slot < plan.cap)[:, None]
    sc = plan.slot.clamp_max(plan.cap - 1)
    return [p + torch.where(ok, _rows(c, plan.block)[sc], 0).reshape(-1)
            for p, c in zip(prev, cur)]


def fold_bwd_plain(plan: Plan, grads: list) -> list:
    """K14 bwd's function, the deeper stage's side (the outer stage's is
    the upstream gradient itself): ``g_cur[j] = j < n_ok ? g[src[j]] : 0``
    a row, (cap*block,)."""
    ok = _live_rows(plan)
    return [torch.where(ok, _rows(g, plan.block)[plan.src], 0.0).reshape(-1) for g in grads]


def plain_launch(name: str, plan: Plan, ins: list, prevs=None, live: bool = False) -> list:
    """``compact_launch``'s contract by the plain versions (torch ops, on
    either device; K13's last field is ``alive``)."""
    if name == "K13":
        out, alive = take_rows_plain(plan, ins[:-1], ins[-1])
        return [*out, alive]
    if name == "K14":
        return fold_plain(plan, prevs, ins)
    return (take_rows_bwd_plain if name == "K13 bwd" else fold_bwd_plain)(plan, ins)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _check(name: str, what: str, x, dev, n: int, dtype=None) -> None:
    ok = (isinstance(x, torch.Tensor) and x.device == dev and x.is_contiguous()
          and x.dim() == 1 and x.shape[0] == n and x.dtype in _KINDS
          and (dtype is None or x.dtype == dtype))
    if not ok:
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        want = "float32, int32, int64 or bool" if dtype is None else str(dtype)
        raise ValueError(f"{name}: {what} must be a ({n},) contiguous {want} tensor on {dev}, "
                         f"got {got}")


def compact_launch(name: str, plan: Plan, ins: list, prevs=None, live: bool = False) -> list:
    """One launch of instance ``name`` ("K13", "K13 bwd", "K14", "K14 bwd")
    over checked CUDA fields, all in one launch: K13 and K14 bwd gather
    through ``src`` ((R*block,) in, (cap*block,) out), K13 bwd and K14
    through ``slot`` ((cap*block,) in, (R*block,) out); K14 adds each of
    ``prevs``; with ``live`` (K13) the last field is ``alive``, masked dead
    past ``n_ok``. Returns the outputs in the order of ``ins``. Reads
    ``n_ok`` on the device: nothing is read on the host."""
    dev = plan.slot.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, not {dev}")
    block, cap = int(plan.block), int(plan.cap)
    r = plan.slot.shape[0] if plan.slot.dim() == 1 else -1
    if block < 1 or not 1 <= cap <= max(r, 1):
        raise ValueError(f"{name}: block {block} and cap {cap} over {r} rows")
    for what, x, n in (("src", plan.src, cap), ("slot", plan.slot, r)):
        _check(name, what, x, dev, n, torch.int32)
    if not (isinstance(plan.n_ok, torch.Tensor) and plan.n_ok.device == dev
            and plan.n_ok.dtype == torch.int32 and plan.n_ok.numel() == 1):
        raise ValueError(f"{name}: n_ok must be one int32 on {dev}")
    by_src = name in ("K13", "K14 bwd")
    rows_in, rows_out = (r, cap) if by_src else (cap, r)
    if not 1 <= len(ins) <= _MAX_FIELDS or (prevs is not None and len(prevs) != len(ins)):
        raise ValueError(f"{name}: {len(ins)} fields, at most {_MAX_FIELDS}")
    if (name == "K14") != (prevs is not None) or (live and name != "K13"):
        raise ValueError(f"{name}: prevs only for K14, the live mask only for K13")
    for x in ins:
        _check(name, "a field", x, dev, rows_in * block,
               torch.float32 if name.endswith("bwd") else None)
    for p, x in zip(prevs or (), ins):
        _check(name, "an outer stage's field", p, dev, rows_out * block, x.dtype)
    if live and ins[-1].dtype != torch.bool:
        raise ValueError(f"{name}: the live field must be bool")
    outs = [torch.empty((rows_out * block,), dtype=x.dtype, device=dev) for x in ins]
    ptrs, kinds, vec = [], [], 4 if block % 4 == 0 else 1
    for k, (x, o) in enumerate(zip(ins, outs)):
        p = prevs[k] if prevs is not None else None
        ptrs += [x.data_ptr(), None if p is None else p.data_ptr(), o.data_ptr()]
        kinds.append(_LIVE if live and k == len(ins) - 1 else _KINDS[x.dtype])
        if any(t.data_ptr() % (4 * t.element_size()) for t in (x, o, p) if t is not None):
            vec = 1  # a pointer off the 4-element alignment: one lane a thread
    lib = load("compact", "pbr_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_compact(_MODES[name], (ctypes.c_void_p * len(ptrs))(*ptrs),
                              (ctypes.c_int * len(kinds))(*kinds), len(ins),
                              (plan.src if by_src else plan.slot).data_ptr(),
                              plan.n_ok.data_ptr(), rows_out, block, cap, vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    count_launch(launches, name)
    return outs


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _run(name: str, plan: Plan, ins: list, prevs=None) -> list:
    """Instance ``name`` on ``ins``: the kernel on CUDA tensors, the plain
    version on the CPU."""
    run = plain_launch if plan.slot.device.type == "cpu" else compact_launch
    return run(name, plan, ins, prevs=prevs, live=name == "K13")


def take_rows(plan: Plan, fields: list, alive) -> tuple:
    """A stage's row gather (``take_rows_plain``'s contract): on CUDA
    tensors one launch of K13, on the CPU the plain version; where autograd
    records a field that requires grad, either through ``_TakeRowsFn``,
    whose backward is K13 bwd on the card and ``take_rows_bwd_plain`` on
    the CPU. Returns ``(fields, alive)``."""
    if _wants_grad(fields):
        out = _TakeRowsFn.apply(plan.cap, plan.block, plan.src, plan.slot, plan.n_ok,
                                *fields, alive)
    else:
        out = _run("K13", plan, [*fields, alive])
    return list(out[:-1]), out[-1]


def fold(plan: Plan, prev: list, cur: list) -> list:
    """A stage's fold back (``fold_plain``'s contract): on CUDA tensors one
    launch of K14, on the CPU the plain version; where autograd records a
    field that requires grad, either through ``_FoldFn``, whose backward
    passes the outer stage's gradient on and gathers the deeper stage's by
    K14 bwd on the card, ``fold_bwd_plain`` on the CPU."""
    if _wants_grad((*prev, *cur)):
        return list(_FoldFn.apply(plan.cap, plan.block, plan.src, plan.slot, plan.n_ok,
                                  len(prev), *prev, *cur))
    return _run("K14", plan, cur, prevs=prev)


def _plan(ctx) -> Plan:
    return Plan(*ctx.saved_tensors, ctx.cap, ctx.block)


class _TakeRowsFn(torch.autograd.Function):
    """A stage's row gather where autograd records it (``take_rows``):
    forward K13 on the card, ``take_rows_plain`` on the CPU; backward K13
    bwd on the card, ``take_rows_bwd_plain`` on the CPU, one launch over
    the gradients of the fields that require grad. It saves the plan's
    tensors alone."""

    @staticmethod
    def forward(ctx, cap, block, src, slot, n_ok, *fields):
        *out, alive = _run("K13", Plan(src, slot, n_ok, cap, block), list(fields))
        ctx.save_for_backward(src, slot, n_ok)
        ctx.cap, ctx.block = cap, block
        ctx.diff = [k for k, x in enumerate(fields[:-1]) if x.requires_grad]
        ctx.mark_non_differentiable(alive, *(o for k, o in enumerate(out)
                                             if k not in ctx.diff))
        ctx.set_materialize_grads(False)
        return (*out, alive)

    @staticmethod
    def backward(ctx, *gs):
        plan = _plan(ctx)
        n = plan.cap * plan.block
        grads = [gs[k] if gs[k] is not None else
                 torch.zeros((n,), dtype=torch.float32, device=plan.slot.device)
                 for k in ctx.diff]
        got = iter(_run("K13 bwd", plan, [g.contiguous() for g in grads]) if grads else ())
        return (None,) * 5 + tuple(next(got) if k in ctx.diff else None
                                   for k in range(len(gs)))


class _FoldFn(torch.autograd.Function):
    """A stage's fold back where autograd records it (``fold``): forward
    K14 on the card, ``fold_plain`` on the CPU; backward the upstream
    gradient for the outer stage's fields and, for the deeper stage's, K14
    bwd on the card, ``fold_bwd_plain`` on the CPU. It saves the plan's
    tensors alone."""

    @staticmethod
    def forward(ctx, cap, block, src, slot, n_ok, n_prev, *fields):
        prev, cur = list(fields[:n_prev]), list(fields[n_prev:])
        out = _run("K14", Plan(src, slot, n_ok, cap, block), cur, prevs=prev)
        ctx.save_for_backward(src, slot, n_ok)
        ctx.cap, ctx.block = cap, block
        ctx.prev_diff = [x.requires_grad for x in prev]
        ctx.cur_diff = [k for k, x in enumerate(cur) if x.requires_grad]
        ctx.mark_non_differentiable(*(o for k, o in enumerate(out) if not (
            prev[k].requires_grad or cur[k].requires_grad)))
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        plan = _plan(ctx)
        n = plan.slot.shape[0] * plan.block
        g_of = lambda k: gs[k] if gs[k] is not None else torch.zeros(  # noqa: E731
            (n,), dtype=torch.float32, device=plan.slot.device)
        grads = [g_of(k).contiguous() for k in ctx.cur_diff]
        got = iter(_run("K14 bwd", plan, grads) if grads else ())
        g_cur = tuple(next(got) if k in ctx.cur_diff else None for k in range(len(gs)))
        g_prev = tuple(g_of(k) if d else None for k, d in enumerate(ctx.prev_diff))
        return (None,) * 6 + g_prev + g_cur
