"""ctypes binding for the native C++ BVH builder
(pbr_tpu_torch/csrc/bvh_builder.cpp, the port's copy of the JAX package's).

The shared library is compiled on demand with g++ (no pybind11 in the
environment; plain C ABI + ctypes) into ``build/pbr_tpu_torch/`` of the
checkout. The native builder is semantics-identical to the NumPy one —
``tests/test_torch_host.py`` asserts byte-equal scenes — and exists for
large scenes where Python-side recursion and sorting dominate load time
(the reference's BVH build was its biggest host cost, BVH.cpp:560-576).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import LinearBVH
from pbr_tpu_torch.utils.config import BVHConfig
from pbr_tpu_torch.utils.log import Logger, Timer

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pbr_tpu_torch")
_LIB = os.path.join(_BUILD_DIR, "libpbr_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _Result(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("n_faces", ctypes.c_int64),
        ("bb_min", ctypes.POINTER(ctypes.c_float)),
        ("bb_max", ctypes.POINTER(ctypes.c_float)),
        ("leaf_first", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_count", ctypes.POINTER(ctypes.c_int32)),
        ("exit_idx", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_order", ctypes.POINTER(ctypes.c_int64)),
    ]


def _compile() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    t = Timer()
    # Into a temporary file, then renamed: processes that build at once
    # each load a whole library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    Logger.info(f"[native] Compiled {os.path.basename(_LIB)} in {t.s():.2f} s.")


def load_library(rebuild: bool = False) -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None on failure."""
    global _lib
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        try:
            if rebuild or not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            ):
                _compile()
            lib = ctypes.CDLL(_LIB)
            lib.pbr_build_bvh.restype = ctypes.c_int
            lib.pbr_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_double,
                ctypes.POINTER(_Result),
            ]
            lib.pbr_free_bvh.argtypes = [ctypes.POINTER(_Result)]
            _lib = lib
            return _lib
        except (OSError, subprocess.CalledProcessError) as e:
            Logger.warning(f"[native] BVH builder unavailable ({e}); using NumPy builder.")
            return None


def available() -> bool:
    return load_library() is not None


def build_bvh_native(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, cfg: BVHConfig = BVHConfig()
):
    """Native build. Same return contract as ``accel.bvh.build_bvh``
    (minus stats): ``(LinearBVH, leaf_order)``. Raises RuntimeError if the
    native library cannot be used."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native BVH builder unavailable")
    v0 = np.ascontiguousarray(v0, dtype=np.float32)
    v1 = np.ascontiguousarray(v1, dtype=np.float32)
    v2 = np.ascontiguousarray(v2, dtype=np.float32)
    nf = v0.shape[0]
    res = _Result()
    t = Timer()
    rc = lib.pbr_build_bvh(
        v0.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v1.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nf,
        int(cfg.max_faces),
        int(cfg.sah_faces_limit),
        float(cfg.skip_ahead_compare) if cfg.skip_ahead else -1.0,
        ctypes.byref(res),
    )
    if rc != 0:
        raise RuntimeError(f"pbr_build_bvh failed (rc={rc})")
    try:
        n = int(res.n_nodes)
        bb_min = np.ctypeslib.as_array(res.bb_min, shape=(n, 3)).copy()
        bb_max = np.ctypeslib.as_array(res.bb_max, shape=(n, 3)).copy()
        leaf_first = np.ctypeslib.as_array(res.leaf_first, shape=(n,)).copy()
        leaf_count = np.ctypeslib.as_array(res.leaf_count, shape=(n,)).copy()
        exit_idx = np.ctypeslib.as_array(res.exit_idx, shape=(n,)).copy()
        leaf_order = np.ctypeslib.as_array(res.leaf_order, shape=(nf,)).copy()
    finally:
        lib.pbr_free_bvh(ctypes.byref(res))
    Logger.debug(f"[native] Built BVH: {n} nodes in {t.ms():.1f} ms.")
    lin = LinearBVH(
        bb_min=Vec3.from_array(bb_min),
        bb_max=Vec3.from_array(bb_max),
        leaf_first=leaf_first,
        leaf_count=leaf_count,
        exit=exit_idx,
    )
    return lin, leaf_order
