"""Scene intersection: the brute-force sweep, the gated sweep, the
cull-and-sweep, and their dispatch.

The counterpart of ``pbr_tpu/ops/traverse.py`` for the intersectors the
port has so far:

- ``intersect_brute``: the plain all-faces sweep in torch ops (any device);
- ``intersect_scene``: the dispatch the integrator calls, with the JAX
  version's contract (detached search, differentiable re-evaluation of the
  winner, fused NEE leg, ``alive`` mask, executed test counts). Modes:
  ``pallas`` is kernel K1 (``ops/cuda_intersect.py``); ``gated`` is kernel
  K3 (``ops/cuda_gated.py``) over the scene's cluster verdicts; ``cull`` is
  kernel K4 (more than 48 clusters) or K4m (``ops/cuda_cull.py``) over the
  scene's candidate lists; ``brute`` is the plain sweep for CPU tensors
  only (on a card the sweep is K1). On a CPU tensor every kernel's wrapper
  runs its plain version.
- ``auto`` mirrors the JAX package's TPU dispatch so that both packages run
  the same algorithm on the same scene: a scene with clusters and
  ``GATED_MIN_FACES`` < F <= ``GATED_MAX_FACES`` takes ``gated``, and one
  with clusters and F > ``GATED_MAX_FACES`` takes ``cull`` (on either
  device); any other scene takes K1 on a CUDA tensor and the plain sweep on
  a CPU tensor.

The other modes of the JAX dispatch (BVH walks, cull tables, the row sweep,
the GEMM form) are not ported yet; asking for one raises
``NotImplementedError`` naming its ROADMAP item. Nothing is substituted
silently.
"""

from __future__ import annotations

from pbr_tpu_torch.ops import cuda_cull, cuda_gated, cuda_intersect
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
    "sweep": "queue 2 kernel K5, the row sweep",
}

# The gated band of ``auto``, and ``cull`` above it: the bounds of the JAX
# package's TPU dispatch (pbr_tpu/ops/traverse.py:424-427, GATED_MAX_FACES
# of ops/pallas_gated.py),
# mirrored so that both packages run the same algorithm on the same scene.
# They are TPU measurements and a TPU SMEM budget, not H100 measurements:
# moving them is the work of a PR that measures the band on the card.
GATED_MIN_FACES = 1024  # exclusive
GATED_MAX_FACES = 12_288


def detach_tris(tris):
    """The triangle SoA with every tensor detached from autograd."""
    return type(tris)(*(f.detach() for f in tris))


def intersect_brute(o: Vec3, d: Vec3, tris):
    """Nearest hit over all triangles, in plain torch ops.

    Rays are (B,), triangles (F,). Returns ``(t, face)`` with t = +inf and
    face = -1 on a miss; the first face in memory order wins ties."""
    return cuda_intersect.intersect_fused_plain(o, d, cuda_intersect.face_table(tris))


def resolve_mode(mode: str, device, n_faces: int = 0, has_clusters: bool = False) -> str:
    """What the ``RenderSettings.intersector`` value ``mode`` runs on
    ``device`` for a scene of ``n_faces`` faces, with or without cluster
    tables: 'gated' (kernel K3), 'cull' (kernel K4 or K4m), 'pallas'
    (kernel K1, the port of the TPU kernel of that name) — on a CPU tensor
    their wrappers run the plain versions — or 'brute' (the plain sweep,
    CPU tensors only: on a card the sweep is K1). Raises for modes the port
    does not have."""
    if mode == "auto":
        if has_clusters and GATED_MIN_FACES < n_faces <= GATED_MAX_FACES:
            return "gated"
        if has_clusters and n_faces > GATED_MAX_FACES:
            return "cull"
        return "pallas" if device.type == "cuda" else "brute"
    if mode == "brute" and device.type != "cpu":
        raise ValueError(
            f"intersector 'brute' is the plain sweep for CPU tensors; on a "
            f"{device.type} device use 'auto' or 'pallas' (kernel K1)"
        )
    if mode in ("brute", "pallas", "gated", "cull"):
        return mode
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"intersector mode {mode!r} is not ported to pbr_tpu_torch yet "
            f"(ROADMAP.md {_NOT_PORTED[mode]})"
        )
    raise ValueError(f"unknown intersector mode {mode!r}")


def intersect_scene(o: Vec3, d: Vec3, tris, mode: str = "auto",
                    light_pos=None, alive=None, clusters=None,
                    with_counts: bool = False):
    """Nearest-hit dispatch (``pbr_tpu.ops.traverse.intersect_scene``).

    The search for the nearest face runs detached; the winner's ``t`` is
    then re-evaluated with one Möller-Trumbore on live ``o``/``d`` and
    detached geometry, which is where gradients flow.

    ``light_pos`` (a Vec3 of 0-d tensors, light 0) asks for the NEE shadow
    any-hit fused into the search. Returns ``(t, face, occluded)``, where
    ``occluded`` is None when the mode has no fused leg (the plain sweep):
    the caller then traces the shadow ray itself.

    ``alive``: optional (B,) bool liveness. The gated sweep and the
    cull-and-sweep close dead lanes out (they cost nothing and return
    face -1); the full sweeps ignore it. ``clusters``: the scene's
    ``scene.ClusterTables`` or None; 'gated' and 'cull' need them.

    ``with_counts``: also return ``tests`` last, the per-ray ray-face test
    counts: F, or 2F with the fused shadow leg, on the full sweeps; the
    exact executed real-face tests on 'gated'; None on 'cull', whose
    tile-dynamic early-out the wrapper does not count (as in the JAX
    package), so a frame that auto sends to 'cull' has no test counts. A
    sweep visits no BVH nodes, so unlike the JAX version there is no visit
    count.
    """
    mode = resolve_mode(mode, o.x.device, int(tris.mtl.shape[0]), clusters is not None)
    o_s, d_s, tris_s = o.detach(), d.detach(), detach_tris(tris)
    occ = counts = None
    if mode == "gated":
        if clusters is None:
            raise ValueError(
                "mode='gated' needs a scene with clusters (the fine AABBs are "
                "the gate targets); build the scene with use_bvh=True "
                "(scene/build.py attaches a ClusterSet above 256 faces)"
            )
        out = cuda_gated.intersect_gated(
            o_s, d_s, tris_s, clusters, alive=alive, with_counts=with_counts,
            light_pos=None if light_pos is None else light_pos.detach(),
        )
        face = out[1]
        if light_pos is not None:
            occ = out[2]
        if with_counts:
            counts = out[-1]
    elif mode == "cull":
        if clusters is None:
            raise ValueError(
                "mode='cull' needs a scene with clusters (the candidate lists and "
                "coefficient blocks); build the scene with use_bvh=True "
                "(scene/build.py attaches a ClusterSet above 256 faces)"
            )
        out = cuda_cull.intersect_cull(
            o_s, d_s, clusters, alive=alive,
            light_pos=None if light_pos is None else light_pos.detach(),
        )
        face = out[1]
        if light_pos is not None:
            occ = out[2]
    elif mode == "pallas":
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
        if mode in ("brute", "pallas"):  # the full sweeps test every face, twice with NEE
            counts = face.new_full(face.shape, int(tris.mtl.shape[0]) * (2 if occ is not None else 1))
        out.append(counts)
    return tuple(out)
