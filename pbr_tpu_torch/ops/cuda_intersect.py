"""Kernels K1 and K2: fused brute-force intersection, CUDA for Hopper, and
their plain PyTorch versions; and the nvcc build every kernel of the port
shares.

K1 replaces ``pbr_tpu/ops/pallas_intersect.py::_kernel_nee`` (nearest hit +
NEE shadow any-hit) and ``::_kernel`` (nearest hit only) around ``_sweep``;
K2 is the same pair with ``variant='lin'``, around ``_sweep_lin`` and its
(16, F) table ``_lin_table``. Both are instances of one template in
``pbr_tpu_torch/csrc/brute_intersect.cu``, whose header says what bounds
them on the card and how the design answers that: issue bounds them, so a
test computes t first, against the ray's running bound, and u and v only
where t can change the result; the shadow leg stops at a ray's first
occluder and a block once all its rays are occluded.

- ``intersect_fused(o, d, tris, light_pos=None, variant='mt')`` is the
  wrapper: for CUDA tensors it launches the kernel (or raises); for CPU
  tensors — and only for them — it runs ``intersect_fused_plain``. The
  kernel reads the faces face-major, a face's record as float4s: K1 the
  (F, 12) ``face_records`` of the (9, F) table, K2 the (16, F) table
  transposed; the wrapper builds them each call, as it builds the tables.
  ``launches`` counts kernel launches per instance.
- ``intersect_fused_plain`` is the same function in torch ops: the face
  loop of ``_sweep`` (``variant='mt'``, (9, F) table) or ``_sweep_lin``
  (``'lin'``, (16, F) table), run over chunks of faces at once, each
  element computing exactly the per-face expression, plus the guarded NEE
  math. It follows the kernel's operation order, so on the card the two
  agree bitwise.
- ``build(name)`` compiles ``csrc/<name>.cu`` with ``nvcc`` into
  ``build/pbr_tpu_torch/`` of the checkout at first use, keyed by a hash of
  the sources and the flags. Nothing is compiled or imported for CUDA when
  this module is imported.
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

from pbr_tpu_torch.ops import count_launch
from pbr_tpu_torch.ops.intersect import EPS5, INF, moller_trumbore
from pbr_tpu_torch.ops.vec import Vec3, safe_div, safe_sqrt

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pbr_tpu_torch"

# --fmad=false and no --use_fast_math: a kernel then rounds every operation
# as the unfused plain version does (see the sources' headers).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# Plain version: faces swept per step are capped so that a (rays, faces)
# temporary holds at most this many elements.
_PLAIN_ELEMS = 1 << 24

# Kernel launches by intersect_fused, per instance: K1 (NEE), K1' (nearest
# only), K2 and K2' (the linear form). CPU calls and launches under
# capture do not count (``ops.counts`` adds a CUDA graph's at its replays).
launches = {"K1": 0, "K1'": 0, "K2": 0, "K2'": 0}
_libs: dict = {}


def _nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda). Raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"nvcc not found (not on PATH, not under CUDA_HOME={home}): the port's "
        f"kernels (pbr_tpu_torch/csrc/*.cu) are compiled at first use and need "
        f"the CUDA toolkit"
    )


def build(name: str = "brute_intersect") -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library (once per source,
    headers and flag set) and return its path. Safe to call from several
    threads at once: each build writes a temporary file and renames it."""
    nvcc = _nvcc()
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(name: str, symbol: str, argtypes) -> ctypes.CDLL:
    """The built library ``name`` with ``symbol``'s ctypes signature set
    (int return: the launch's cudaError). A library may hold several
    symbols, so the signature is set on every call, not only on the first
    load."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    fn = getattr(_libs[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return _libs[name]


def face_table(tris) -> torch.Tensor:
    """(9, F) float32 table, rows v0, e1, e2 (pallas_intersect.py:332-339)."""
    return torch.stack(
        [tris.v0.x, tris.v0.y, tris.v0.z,
         tris.e1.x, tris.e1.y, tris.e1.z,
         tris.e2.x, tris.e2.y, tris.e2.z]
    ).contiguous()


def face_records(faces: torch.Tensor) -> torch.Tensor:
    """The (F, 12) float32 face records of a (9, F) face table, 48 bytes a
    face read as three float4, ``{v0, 0}``, ``{e1, 0}``, ``{e2, 0}``: K1's
    and the tree walks' layout."""
    nf = faces.shape[1]
    rec = faces.new_zeros((nf, 3, 4))
    rec[:, :, :3] = faces.T.reshape(nf, 3, 3)
    return rec.reshape(nf, 12)


def lin_table(tris) -> torch.Tensor:
    """(16, F) float32 linear-form table (pallas_intersect.py::_lin_table):
    rows m = e2×e1, km = v0·m, w = e2×v0, q = v0×e1, e1, e2."""
    v0, e1, e2 = tris.v0, tris.e1, tris.e2
    m = e2.cross(e1)
    w = e2.cross(v0)
    q = v0.cross(e1)
    km = v0.dot(m)
    return torch.stack([m.x, m.y, m.z, km, w.x, w.y, w.z, q.x, q.y, q.z,
                        e1.x, e1.y, e1.z, e2.x, e2.y, e2.z]).contiguous()


def check_rays(who: str, o: Vec3, d: Vec3) -> None:
    """Six contiguous 1-D float32 ray arrays of one shape on one device,
    with a count that fits in int32; raises otherwise."""
    rays = (*o, *d)
    dev, n = rays[0].device, rays[0].shape
    for a in rays:
        if a.device != dev or a.dtype != torch.float32 or a.dim() != 1 \
                or a.shape != n or not a.is_contiguous():
            raise ValueError(
                f"{who} takes six contiguous 1-D float32 ray arrays of one "
                f"shape on one device; got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    if n[0] >= 2**31:
        raise ValueError("ray counts must fit in int32")


def _check(o: Vec3, d: Vec3, table: torch.Tensor, rows: int, light) -> None:
    check_rays("intersect_fused", o, d)
    dev = o.x.device
    if table.device != dev or table.dtype != torch.float32 or table.dim() != 2 \
            or table.shape[0] != rows:
        raise ValueError(f"face table must be ({rows}, F) float32 on {dev}")
    if light is not None and (light.device != dev or light.dtype != torch.float32
                              or tuple(light.shape) != (3,)):
        raise ValueError(f"light position must be (3,) float32 on {dev}")
    if table.shape[1] >= 2**31:
        raise ValueError("face counts must fit in int32")


def cross_od(o: Vec3, d: Vec3) -> Vec3:
    """c = o × d, the one cross product per ray of the linear form."""
    return Vec3(o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z, o.x * d.y - o.y * d.x)


def mt_lin(o: Vec3, d: Vec3, c: Vec3, tab: torch.Tensor):
    """Linear-form Möller-Trumbore of rays (broadcast against the face
    axis) and the faces of a (16, k) table, in the operation order of
    ``pallas_gated.py::_mt_lin_update`` and ``csrc/mt_lin.cuh``. Returns
    ``(t, valid)``."""
    m0, m1, m2, km, w0, w1, w2, q0, q1, q2, e1x, e1y, e1z, e2x, e2y, e2z = tab
    det = d.x * m0 + d.y * m1 + d.z * m2
    inv = 1.0 / det
    t = (km - (o.x * m0 + o.y * m1 + o.z * m2)) * inv
    u = ((e2x * c.x + e2y * c.y + e2z * c.z) - (d.x * w0 + d.y * w1 + d.z * w2)) * inv
    v = (-(e1x * c.x + e1y * c.y + e1z * c.z) - (d.x * q0 + d.y * q1 + d.z * q2)) * inv
    valid = (t >= EPS5) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


def first_min(t, valid, lo: int, big: int):
    """Per row, the least valid t of a (rays, faces) block and the first
    face (offset ``lo``) that attains it: the strict-< sweep in ascending
    face order. Invalid faces count as +inf; ``big`` marks no face."""
    t = torch.where(valid, t, INF)
    t_min = t.amin(dim=1)
    fidx = torch.arange(lo, lo + t.shape[1], dtype=torch.int32, device=t.device)
    first = torch.where(t == t_min[:, None], fidx, big).amin(dim=1)
    return t_min, first


def _sweep_plain(o: Vec3, d: Vec3, table: torch.Tensor, t_limit=None):
    """All-faces Möller-Trumbore, in ascending face order, classic form
    ((9, F) table) or linear form ((16, F) table).

    ``t_limit`` None: nearest hit — returns ``(t_best, f_best)``, strict-<
    so the first face in memory order wins ties. Otherwise any-hit with
    ``t < t_limit`` — returns a bool mask. Faces are swept a chunk at a
    time by broadcasting; each element runs the per-face expression."""
    n, nf = o.x.shape[0], table.shape[1]
    lin = table.shape[0] == 16
    t_best = torch.full((n,), INF, dtype=torch.float32, device=o.x.device)
    f_best = torch.full((n,), -1, dtype=torch.int32, device=o.x.device)
    occ = torch.zeros((n,), dtype=torch.bool, device=o.x.device)
    step = max(1, _PLAIN_ELEMS // max(n, 1))
    ob = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
    cb = cross_od(ob, db) if lin else None
    for lo in range(0, nf, step):
        c = table[:, lo:lo + step]
        if lin:
            t, valid = mt_lin(ob, db, cb, c)
        else:
            t, valid = moller_trumbore(ob, db, Vec3(c[0], c[1], c[2]),
                                       Vec3(c[3], c[4], c[5]), Vec3(c[6], c[7], c[8]))
        if t_limit is not None:
            occ = occ | (valid & (t < t_limit[:, None])).any(dim=1)
            continue
        t_min, first = first_min(t, valid, lo, nf)
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
    """K1's plain version with a (9, F) table, K2's with a (16, F) one.
    Returns ``(t, face)``, or ``(t, face, occluded)`` with ``light`` a (3,)
    tensor."""
    t, face = _sweep_plain(o, d, table)
    if light is None:
        return t, face
    hit_p, s_dir, t_light = _shadow_ray(o, d, t, light)
    return t, face, _sweep_plain(hit_p, s_dir, table, t_limit=t_light)


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_PTR] * 7 + [_I32, _I32, _PTR, _I32, _PTR, _PTR, _PTR, _PTR]


def intersect_fused(o: Vec3, d: Vec3, tris, light_pos=None, variant: str = "mt"):
    """Nearest hit over all triangles of ``tris`` (a TrianglesSoA of
    tensors) for the (B,) rays ``o``, ``d``; with ``light_pos`` (a Vec3 of
    0-d tensors, light 0) also the NEE shadow any-hit from the hit point.
    ``variant``: 'mt' (classic Möller-Trumbore, kernel K1, the default as
    in the JAX package) or 'lin' (the linear form, kernel K2).

    Returns ``(t, face)`` or ``(t, face, occluded)`` (occluded bool). A CUDA
    tensor launches the kernel or raises; a CPU tensor runs the plain
    version. Not differentiable: callers re-evaluate the winner."""
    if variant not in ("mt", "lin"):
        raise ValueError(f"variant must be 'mt' or 'lin', not {variant!r}")
    rows = 16 if variant == "lin" else 9
    table = lin_table(tris) if variant == "lin" else face_table(tris)
    light = None
    if light_pos is not None:
        light = torch.stack([light_pos.x, light_pos.y, light_pos.z]).to(torch.float32)
    _check(o, d, table, rows, light)
    dev = o.x.device
    if dev.type == "cpu":
        return intersect_fused_plain(o, d, table, light)
    if dev.type != "cuda":
        raise ValueError(f"intersect_fused runs on CUDA or CPU tensors, not {dev}")
    # face-major records (K1 (F, 12), K2 (F, 16)), 16-byte aligned
    rec = table.T.contiguous() if variant == "lin" else face_records(table)
    lib = load("brute_intersect", "pbr_brute_intersect", _ARGTYPES)
    n, nf = o.x.shape[0], table.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    face = torch.empty((n,), dtype=torch.int32, device=dev)
    occ = torch.empty((n,) if light is not None else (0,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pbr_brute_intersect(
            *(a.data_ptr() for a in (*o, *d)), rec.data_ptr(), nf, rec.shape[1],
            light.data_ptr() if light is not None else None, n,
            t.data_ptr(), face.data_ptr(), occ.data_ptr(), stream,
        )
    name = ("K2" if variant == "lin" else "K1") + ("" if light is not None else "'")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    count_launch(launches, name)
    if light is None:
        return t, face
    return t, face, occ != 0
