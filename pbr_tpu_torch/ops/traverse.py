"""Scene intersection: the brute-force sweep and its dispatch.

The counterpart of ``pbr_tpu/ops/traverse.py`` for the one intersector the
port has so far, the all-faces sweep:

- ``intersect_brute``: the plain sweep in torch ops (any device);
- ``intersect_scene``: the dispatch the integrator calls. ``auto`` picks
  kernel K1 (``ops/cuda_intersect.py``) for a CUDA tensor, whatever the face
  count, and the plain sweep for a CPU tensor; ``brute`` on a CUDA tensor
  raises rather than run the plain sweep on the card. The TPU's face-count
  thresholds do not carry over: the CUDA kernel stages faces through shared
  memory in chunks and takes any F.

The other modes of the JAX dispatch (BVH walks, cull tables, the GEMM form)
are not ported yet; asking for one raises ``NotImplementedError`` naming
its ROADMAP item. Nothing is substituted silently.
"""

from __future__ import annotations

from pbr_tpu_torch.ops import cuda_intersect
from pbr_tpu_torch.ops.intersect import INF, gather_vec3, moller_trumbore
from pbr_tpu_torch.ops.vec import Vec3

# JAX dispatch modes that have no port yet, with the ROADMAP item that
# ports each.
_NOT_PORTED = {
    "gemm": "queue 1 item 9, ops/gemm_intersect.py",
    "bvh": "queue 1 item 9 and queue 2 kernel K8, the per-ray BVH walk",
    "pallas_bvh": "queue 2 kernel K6, the packet BVH walk",
    "pallas_bvh_forest": "queue 2 kernel K6, the BVH forest walk",
    "pallas_bvh_hbm": "queue 2 kernel K7, the HBM-slab BVH walk",
    "gated": "queue 2 kernel K3, the gated brute sweep",
    "cull": "queue 2 kernel K4, the cull-and-sweep",
    "sweep": "queue 2 kernel K5, the row sweep",
}


def detach_tris(tris):
    """The triangle SoA with every tensor detached from autograd."""
    return type(tris)(*(f.detach() for f in tris))


def intersect_brute(o: Vec3, d: Vec3, tris):
    """Nearest hit over all triangles, in plain torch ops.

    Rays are (B,), triangles (F,). Returns ``(t, face)`` with t = +inf and
    face = -1 on a miss; the first face in memory order wins ties."""
    return cuda_intersect.intersect_fused_plain(o, d, cuda_intersect.face_table(tris))


def resolve_mode(mode: str, device) -> str:
    """What the ``RenderSettings.intersector`` value ``mode`` runs on
    ``device``: 'pallas' (kernel K1, the port of the TPU kernel of that
    name; on a CPU tensor its wrapper runs the plain version) or 'brute'
    (the plain sweep, CPU tensors only: on a card the sweep is K1).
    Raises for modes the port does not have."""
    if mode == "auto":
        return "pallas" if device.type == "cuda" else "brute"
    if mode == "brute" and device.type != "cpu":
        raise ValueError(
            f"intersector 'brute' is the plain sweep for CPU tensors; on a "
            f"{device.type} device use 'auto' or 'pallas' (kernel K1)"
        )
    if mode in ("brute", "pallas"):
        return mode
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"intersector mode {mode!r} is not ported to pbr_tpu_torch yet "
            f"(ROADMAP.md {_NOT_PORTED[mode]})"
        )
    raise ValueError(f"unknown intersector mode {mode!r}")


def intersect_scene(o: Vec3, d: Vec3, tris, mode: str = "auto",
                    light_pos=None, with_counts: bool = False):
    """Nearest-hit dispatch (``pbr_tpu.ops.traverse.intersect_scene``).

    The search for the nearest face runs detached; the winner's ``t`` is
    then re-evaluated with one Möller-Trumbore on live ``o``/``d`` and
    detached geometry, which is where gradients would flow.

    ``light_pos`` (a Vec3 of 0-d tensors, light 0) asks for the NEE shadow
    any-hit fused into the search. Returns ``(t, face, occluded)``, where
    ``occluded`` is None when the mode has no fused leg (the plain sweep):
    the caller then traces the shadow ray itself.

    ``with_counts``: also return ``tests`` last, the per-ray ray-face test
    counts (F, or 2F with the fused shadow leg). A sweep visits no BVH
    nodes, so unlike the JAX version there is no visit count.
    """
    mode = resolve_mode(mode, o.x.device)
    o_s, d_s, tris_s = o.detach(), d.detach(), detach_tris(tris)
    occ = None
    if mode == "pallas":
        if light_pos is not None:
            _, face, occ = cuda_intersect.intersect_fused(
                o_s, d_s, tris_s, light_pos=light_pos.detach()
            )
        else:
            _, face = cuda_intersect.intersect_fused(o_s, d_s, tris_s)
    else:
        _, face = intersect_brute(o_s, d_s, tris_s)

    safe = face.clamp_min(0)
    t_re, _ = moller_trumbore(
        o, d, gather_vec3(tris_s.v0, safe), gather_vec3(tris_s.e1, safe),
        gather_vec3(tris_s.e2, safe),
    )
    t = t_re.masked_fill(face < 0, INF)
    out = [t, face]
    if light_pos is not None:
        out.append(occ)
    if with_counts:
        nf = int(tris.mtl.shape[0]) * (2 if occ is not None else 1)
        out.append(face.new_full(face.shape, nf))
    return tuple(out)
