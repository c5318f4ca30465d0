"""Kernel K1: fused brute-force intersection, CUDA for Hopper, and its plain
PyTorch version.

K1 replaces ``pbr_tpu/ops/pallas_intersect.py::_kernel_nee`` (nearest hit +
NEE shadow any-hit) and ``::_kernel`` (nearest hit only); the source is
``pbr_tpu_torch/csrc/brute_intersect.cu``, whose header says what bounds it
on the card and how its design answers that.

- ``intersect_fused(o, d, tris, light_pos=None)`` is the wrapper: for CUDA
  tensors it launches the kernel (or raises); for CPU tensors — and only
  for them — it runs ``intersect_fused_plain``. ``launches`` counts kernel
  launches.
- ``intersect_fused_plain`` is the same function in torch ops: the face loop
  of ``_sweep`` (run over chunks of faces at once, each element computing
  exactly the per-face expression) plus the guarded NEE math. It follows
  the kernel's operation order, so on the card the two agree bitwise.
- ``build()`` compiles the source with ``nvcc`` into ``build/pbr_tpu_torch/``
  of the checkout at first use, keyed by a hash of the source and the
  flags, and loads it with ``ctypes``. Nothing is compiled or imported for
  CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from pbr_tpu_torch.ops.intersect import INF, moller_trumbore
from pbr_tpu_torch.ops.vec import Vec3, safe_div, safe_sqrt

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "brute_intersect.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pbr_tpu_torch"

# --fmad=false and no --use_fast_math: the kernel then rounds every
# operation as the unfused plain version does (see the source's header).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# Plain version: faces swept per step are capped so that a (rays, faces)
# temporary holds at most this many elements.
_PLAIN_ELEMS = 1 << 24

launches = 0  # kernel launches by intersect_fused (CPU calls do not count)
_lib = None


def _nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda). Raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"nvcc not found (not on PATH, not under CUDA_HOME={home}): kernel "
        f"K1 ({SOURCE.name}) is compiled at first use and needs the CUDA "
        f"toolkit"
    )


def build() -> Path:
    """Compile K1 into a shared library (once per source and flag set) and
    return its path."""
    nvcc = _nvcc()
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"brute_intersect_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.pbr_brute_intersect
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 7 + [i32, ptr, i32, ptr, ptr, ptr, ptr]
        fn.restype = i32
        _lib = lib
    return _lib


def face_table(tris) -> torch.Tensor:
    """(9, F) float32 table, rows v0, e1, e2 (pallas_intersect.py:332-339)."""
    return torch.stack(
        [tris.v0.x, tris.v0.y, tris.v0.z,
         tris.e1.x, tris.e1.y, tris.e1.z,
         tris.e2.x, tris.e2.y, tris.e2.z]
    ).contiguous()


def _check(o: Vec3, d: Vec3, table: torch.Tensor, light) -> None:
    rays = (*o, *d)
    dev = rays[0].device
    n = rays[0].shape
    for a in rays:
        if a.device != dev or a.dtype != torch.float32 or a.dim() != 1 \
                or a.shape != n or not a.is_contiguous():
            raise ValueError(
                "intersect_fused takes six contiguous 1-D float32 ray "
                f"arrays of one shape on one device; got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}"
            )
    if table.device != dev or table.dtype != torch.float32 or table.dim() != 2 \
            or table.shape[0] != 9:
        raise ValueError(f"face table must be (9, F) float32 on {dev}")
    if light is not None and (light.device != dev or light.dtype != torch.float32
                              or tuple(light.shape) != (3,)):
        raise ValueError(f"light position must be (3,) float32 on {dev}")
    if n[0] >= 2**31 or table.shape[1] >= 2**31:
        raise ValueError("ray and face counts must fit in int32")


def _sweep_plain(o: Vec3, d: Vec3, table: torch.Tensor, t_limit=None):
    """All-faces Möller-Trumbore, in ascending face order.

    ``t_limit`` None: nearest hit — returns ``(t_best, f_best)``, strict-<
    so the first face in memory order wins ties. Otherwise any-hit with
    ``t < t_limit`` — returns a bool mask. Faces are swept a chunk at a
    time by broadcasting; each element runs the per-face expression."""
    n, nf = o.x.shape[0], table.shape[1]
    t_best = torch.full((n,), INF, dtype=torch.float32, device=o.x.device)
    f_best = torch.full((n,), -1, dtype=torch.int32, device=o.x.device)
    occ = torch.zeros((n,), dtype=torch.bool, device=o.x.device)
    step = max(1, _PLAIN_ELEMS // max(n, 1))
    ob = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
    for lo in range(0, nf, step):
        c = table[:, lo:lo + step]
        t, valid = moller_trumbore(ob, db, Vec3(c[0], c[1], c[2]),
                                   Vec3(c[3], c[4], c[5]), Vec3(c[6], c[7], c[8]))
        if t_limit is not None:
            occ = occ | (valid & (t < t_limit[:, None])).any(dim=1)
            continue
        t = torch.where(valid, t, INF)
        t_min = t.amin(dim=1)
        fidx = torch.arange(lo, lo + c.shape[1], dtype=torch.int32, device=t.device)
        first = torch.where(t == t_min[:, None], fidx, nf).amin(dim=1)
        better = t_min < t_best
        t_best = torch.where(better, t_min, t_best)
        f_best = torch.where(better, first, f_best)
    return occ if t_limit is not None else (t_best, f_best)


def _shadow_ray(o: Vec3, d: Vec3, t_best, light: torch.Tensor):
    """Hit point, unit direction to the light and its distance, with the
    integrator's guarded math (t_safe = 1 on a miss; safe_sqrt/safe_div)."""
    ts = torch.where(t_best < INF, t_best, 1.0)
    hit_p = o + d * ts
    l_vec = Vec3(light[0] - hit_p.x, light[1] - hit_p.y, light[2] - hit_p.z)
    t_light = safe_sqrt(l_vec.length2())
    return hit_p, l_vec * safe_div(1.0, t_light), t_light


def intersect_fused_plain(o: Vec3, d: Vec3, table: torch.Tensor, light=None):
    """K1's plain version. Returns ``(t, face)``, or ``(t, face, occluded)``
    with ``light`` a (3,) tensor."""
    t, face = _sweep_plain(o, d, table)
    if light is None:
        return t, face
    hit_p, s_dir, t_light = _shadow_ray(o, d, t, light)
    return t, face, _sweep_plain(hit_p, s_dir, table, t_limit=t_light)


def intersect_fused(o: Vec3, d: Vec3, tris, light_pos=None):
    """Nearest hit over all triangles of ``tris`` (a TrianglesSoA of
    tensors) for the (B,) rays ``o``, ``d``; with ``light_pos`` (a Vec3 of
    0-d tensors, light 0) also the NEE shadow any-hit from the hit point.

    Returns ``(t, face)`` or ``(t, face, occluded)`` (occluded bool). A CUDA
    tensor launches kernel K1 or raises; a CPU tensor runs the plain
    version. Not differentiable: callers re-evaluate the winner."""
    global launches
    table = face_table(tris)
    light = None
    if light_pos is not None:
        light = torch.stack([light_pos.x, light_pos.y, light_pos.z]).to(torch.float32)
    _check(o, d, table, light)
    dev = o.x.device
    if dev.type == "cpu":
        return intersect_fused_plain(o, d, table, light)
    if dev.type != "cuda":
        raise ValueError(f"intersect_fused runs on CUDA or CPU tensors, not {dev}")
    lib = _load()
    n, nf = o.x.shape[0], table.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    face = torch.empty((n,), dtype=torch.int32, device=dev)
    occ = torch.empty((n,) if light is not None else (0,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_brute_intersect(
            *(a.data_ptr() for a in (*o, *d)), table.data_ptr(), nf,
            light.data_ptr() if light is not None else None, n,
            t.data_ptr(), face.data_ptr(), occ.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    launches += 1
    if light is None:
        return t, face
    return t, face, occ != 0
