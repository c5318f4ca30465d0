"""Per-stage timing: the headless counterpart of the reference's kernel-time
window (``InfoWindow`` polling per-kernel GPU times via OpenCL event
profiling, CL.cpp:480-488, InfoWindow.cpp:85-121).

The counterpart of ``pbr_tpu/utils/profiling.py``: ``StageTimer`` records
named spans (host wall-clock around device work, synchronised with the
device when asked, since CUDA work is asynchronous) and renders a table;
``trace_to_file`` wraps ``torch.profiler`` for traces viewable in
Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch


def synchronize(sync) -> None:
    """Wait for the device that ``sync`` names (a ``torch.device``, a device
    string or a tensor on it) to finish its queued work; nothing for the
    CPU or None."""
    if sync is None:
        return
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates (count, total seconds) per named stage."""

    def __init__(self) -> None:
        self._acc: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])

    @contextlib.contextmanager
    def span(self, name: str, sync=None) -> Iterator[None]:
        """Time a block. ``sync``: a device (or a tensor on it) to
        synchronise before stopping the clock, so that the span holds the
        device work queued in it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(sync)
            rec = self._acc[name]
            rec[0] += 1
            rec[1] += time.perf_counter() - t0

    def add(self, name: str, seconds: float) -> None:
        rec = self._acc[name]
        rec[0] += 1
        rec[1] += seconds

    def rows(self) -> List[Tuple[str, int, float, float]]:
        """(name, count, total_ms, mean_ms), insertion order."""
        return [
            (name, int(c), tot * 1e3, (tot / c) * 1e3 if c else 0.0)
            for name, (c, tot) in self._acc.items()
        ]

    def table(self) -> str:
        """The InfoWindow table, as text."""
        rows = self.rows()
        if not rows:
            return "(no stages timed)"
        w = max(len(r[0]) for r in rows)
        lines = [f"{'stage':<{w}}  {'count':>6}  {'total ms':>10}  {'mean ms':>9}"]
        for name, c, tot, mean in rows:
            lines.append(f"{name:<{w}}  {c:>6}  {tot:>10.2f}  {mean:>9.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._acc.clear()


@contextlib.contextmanager
def trace_to_file(logdir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written to ``logdir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
