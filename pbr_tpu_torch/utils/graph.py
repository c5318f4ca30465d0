"""Steps captured as CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles each entry point's step once per (shapes,
settings) and dispatches it whole: ``PathTracer``'s frame step, bench.py's
timed step and ``fit``'s value-and-grad. Here such a step is captured once
as a CUDA graph and replayed. A graph reads and writes fixed addresses, so
the step is a function over static input tensors: a caller writes new
inputs into them (``copy_``, ``fill_``) and reads the step's static
outputs after each replay.

``CapturedStep(fn, *static, name=...)`` on the card:

- its first call (or ``capture()``) runs ``fn(*static)`` eagerly on a side
  stream, with ``torch.cuda.set_sync_debug_mode("error")``: a kernel builds
  at its first launch, so nvcc runs there and never under capture, and an
  op that reads the device from the host fails there with torch's own
  message. That run is the call's result;
- then captures ``fn`` with ``torch.cuda.graph`` into a private memory pool
  and instantiates it;
- every later call replays the graph and returns the static outputs.

A replay launches every kernel node of its graph. After the instantiation
the graph's kernel nodes are read back from the driver and counted by
their functions' names (``kernels``), and each replay adds those counts to
``replayed_kernels()``, which ``pbr_tpu_torch.ops.counts`` adds by kernel
instance to the wrappers' eager launches. Under capture a wrapper launches
nothing and counts nothing: its kernel becomes a node of the graph.

There is no fallback: a capture or replay that fails on the card raises,
naming the step and the line of the op that broke it. On a CPU tensor every call runs
``fn(*static)`` directly: the CPU has no graphs, and it is the tests'
device.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import time
import traceback
import warnings

import torch

__all__ = ["CapturedStep", "replayed_kernels", "zero_replayed"]

# Kernel nodes run by the replays since ``zero_replayed``, by function name.
_replayed: collections.Counter = collections.Counter()


def replayed_kernels() -> dict:
    """{kernel function name (demangled): launches} over every graph replay
    since ``zero_replayed``: each replay's graph's kernel nodes."""
    return dict(_replayed)


def zero_replayed() -> None:
    _replayed.clear()


def _failed_at(e: BaseException) -> str:
    """Where the op that broke a capture was called: the innermost frame
    outside torch of the first exception in ``e``'s chain (a failed
    capture's own error comes last, when its context manager exits)."""
    while e.__context__ is not None:
        e = e.__context__
    frames = [f for f in traceback.extract_tb(e.__traceback__) if "/torch/" not in f.filename]
    if not frames:
        return "an op of torch"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of cuda.h."""
    _fields_ = [("func", ctypes.c_void_p), *((f, ctypes.c_uint) for f in (
        "gridDimX", "gridDimY", "gridDimZ", "blockDimX", "blockDimY", "blockDimZ",
        "sharedMemBytes")), ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_CU_GRAPH_NODE_TYPE_KERNEL = 0


def _demangle(name: bytes) -> str:
    """A C++ symbol's demangled name (``__cxa_demangle``); ``name`` itself
    where it is not a mangled name."""
    abi = ctypes.CDLL("libstdc++.so.6")
    abi.__cxa_demangle.restype = ctypes.c_void_p
    status = ctypes.c_int(0)
    out = abi.__cxa_demangle(name, None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return name.decode()
    try:
        return ctypes.string_at(out).decode()
    finally:
        ctypes.CDLL(None).free(ctypes.c_void_p(out))


def _graph_kernels(graph: torch.cuda.CUDAGraph) -> tuple:
    """(nodes, {kernel function name: kernel nodes}) of a captured graph,
    read from the driver (libcuda: ``cuGraphGetNodes``,
    ``cuGraphNodeGetType``, ``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName`` or ``cuKernelGetName``)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, params = ctypes.c_int(0), _KernelNodeParams()
    by_func: collections.Counter = collections.Counter()
    for node in nodes:
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value == _CU_GRAPH_NODE_TYPE_KERNEL:
            ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
            # A node made from a library kernel may hold a CUkernel instead.
            by_func[(params.func, None) if params.func else (None, params.kern)] += 1
    kernels: collections.Counter = collections.Counter()
    name = ctypes.c_char_p()
    for (func, kern), k in by_func.items():
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)), "cuKernelGetName")
        kernels[_demangle(name.value)] += k
    return int(n.value), dict(kernels)


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CapturedStep:
    """``fn`` over the static tensors ``static``, captured once as a CUDA
    graph on the card and replayed (module docstring); ``name`` names it
    in errors.

    ``step(*inputs)`` first copies each input that is not None into its
    static tensor (``copy_``), then runs the step: the warm-up run and the
    capture at the first call on the card, a replay after that, ``fn``
    itself on the CPU. It returns ``fn``'s outputs: on the card after the
    first call the graph's static outputs, which the next replay
    overwrites.

    After the capture: ``capture_s`` (the warm-up run, capture and
    instantiation), ``nodes`` (the graph's nodes), ``kernels`` (its
    kernel nodes by function name, read back from the graph: the launches
    of one replay), ``pool_bytes`` (the device memory the capture reserved
    for its private pool) and ``replays``."""

    def __init__(self, fn, *static: torch.Tensor, name: str = "step"):
        if not static:
            raise ValueError("a captured step needs at least one static tensor")
        self.fn, self.static, self.name = fn, static, name
        self.device = static[0].device
        self.graph = None
        self.out = None
        self.capture_s = self.nodes = self.pool_bytes = None
        self.kernels: dict = {}
        self.replays = 0

    def __call__(self, *inputs):
        if inputs and len(inputs) != len(self.static):
            raise ValueError(f"{self.name} takes {len(self.static)} inputs, not {len(inputs)}")
        for s, x in zip(self.static, inputs):
            if x is not None and x is not s:
                s.copy_(x)
        if self.device.type != "cuda":
            return self.fn(*self.static)
        if self.graph is None:
            return self.capture()
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replay of the CUDA graph of {self.name} failed: {e}") from e
        _replayed.update(self.kernels)
        self.replays += 1
        return self.out

    def capture(self):
        """Run the step once eagerly on a side stream, then capture it;
        returns the eager run's outputs. Raises off the card."""
        if self.device.type != "cuda":
            raise ValueError(f"{self.name}: CUDA graphs capture steps on a card, not "
                             f"{self.device}")
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # torch's capture stream (one for every capture) is the side stream
        # of the warm-up too: what a warm-up caches there, the next reuses.
        capturing = torch.cuda.graph(graph)
        side = capturing.capture_stream
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side), warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Synchronization debug mode")
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.fn(*self.static)
            except RuntimeError as e:
                raise RuntimeError(f"the eager run before the capture of {self.name} failed "
                                   f"at {_failed_at(e)}: {e}") from e
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        # torch.cuda.graph empties the allocator's cache as it starts; empty
        # it first, so that what the capture reserves is its pool alone.
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        # No collection under capture: a graph that is garbage (a tracer's,
        # freed with it) would be destroyed there, which no capture allows.
        # torch.cuda.graph collects before it begins.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capturing:
                self.out = self.fn(*self.static)
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed at "
                               f"{_failed_at(e)}: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.nodes, self.kernels = _graph_kernels(graph)
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        return out

    def stats(self) -> dict:
        """The capture's figures (class docstring) as a dict."""
        return {"capture_s": self.capture_s, "nodes": self.nodes,
                "pool_bytes": self.pool_bytes, "replays": self.replays}
