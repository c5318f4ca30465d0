"""Scene assembly: parsed model data → renderer-ready SoA pytrees.

The analog of the reference's device-buffer initialization
(``PathTracer::initOpenCLBuffers``, PathTracer.cpp:136-230): triangles are
reordered into BVH-leaf order (PathTracer.cpp:312-330), materials and lights
packed into SoA (PathTracer.cpp:387-428,448-518), and the scene-dependent
constants (sky color from the ``sky_light`` material, light count) surfaced
so the caller can fix them into ``RenderSettings`` — the jit-static
equivalent of the reference's ``#SKY_LIGHT#`` / ``#NUM_LIGHTS#``
substitutions (PathTracer.cpp:209-210,468-474,514-516).

The port's copy of ``pbr_tpu/scene/build.py``; its ``to_device`` is
``pbr_tpu_torch.scene.to_torch``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pbr_tpu_torch.accel.bvh import build_bvh
from pbr_tpu_torch.io.lights import lights_to_soa
from pbr_tpu_torch.io.obj import ObjData
from pbr_tpu_torch.scene.types import Scene, make_triangles, no_lights, permute_triangles
from pbr_tpu_torch.utils.config import ACCEL_BVH, BVHConfig, RenderSettings


def build_scene(
    obj: ObjData,
    bvh_cfg: Optional[BVHConfig] = None,
    use_bvh: bool = True,
    phong_tess_alpha: float = 0.0,
) -> Scene:
    """Assemble a Scene from parsed OBJ data (host-side, NumPy).

    ``phong_tess_alpha`` > 0 builds the BVH and the clusters over
    curved-patch-inflated face bounds (``ops/phongtess.py::
    phongtess_face_aabbs``), so that Phong-tessellated patches trace through
    them; pass the same alpha as ``RenderSettings.phong_tessellation``.
    """
    tris = make_triangles(
        obj.vertices,
        obj.faces_v,
        obj.normals if obj.normals.size else None,
        obj.faces_vn if obj.faces_vn.size else None,
        obj.faces_mtl,
    )
    bvh = None
    face_min = face_max = None  # per-face bounds: the flat triangles' unless Phong
    if use_bvh:
        v0 = tris.v0.stack(np)
        v1 = (tris.v0 + tris.e1).stack(np)
        v2 = (tris.v0 + tris.e2).stack(np)
        # Adaptive leaf size: big scenes build 64-face leaves (the JAX
        # package sized them for its HBM-slab packet kernel). Callers derive
        # the matching traversal bound via ``bvh_max_leaf(scene)``.
        if bvh_cfg is None and tris.count > 20_000:
            cfg = BVHConfig(max_faces=64)
        else:
            cfg = bvh_cfg or BVHConfig()
        if phong_tess_alpha > 0.0:
            from pbr_tpu_torch.ops.phongtess import phongtess_face_aabbs

            face_min, face_max = phongtess_face_aabbs(
                v0, v1, v2, tris.n0.stack(np), tris.n1.stack(np), tris.n2.stack(np),
                phong_tess_alpha,
            )
        # The native C++ builder is byte-identical to the NumPy one
        # (tests/test_torch_host.py); prefer it when the build is big
        # enough for Python overhead to matter. It takes no face bounds, so
        # a Phong build takes the NumPy build_bvh.
        bvh = None
        if tris.count >= 4096 and face_min is None:
            try:
                from pbr_tpu_torch.accel.native import build_bvh_native

                bvh, leaf_order = build_bvh_native(v0, v1, v2, cfg)
            except RuntimeError:
                bvh = None
        if bvh is None:
            bvh, leaf_order, _ = build_bvh(v0, v1, v2, cfg, face_min=face_min,
                                           face_max=face_max)
        tris = permute_triangles(tris, leaf_order)
        if face_min is not None:
            face_min, face_max = face_min[leaf_order], face_max[leaf_order]
    clusters = None
    if tris.count > 256 and use_bvh:
        # Cull-and-sweep intersector tables (accel/clusters.py): cheap to
        # build (~64 B/face). Triangles are already in BVH leaf order, so
        # contiguous cluster runs are spatially compact.
        from pbr_tpu_torch.accel.clusters import build_clusters

        # 64-face clusters, and 128 above 50,000 faces: the JAX package's
        # sizes (chosen from TPU measurements), kept so that both packages
        # build the same tables.
        # A Phong build's cluster bounds cover the curved patches too.
        clusters = build_clusters(tris, size=128 if tris.count > 50_000 else 64,
                                  face_min=face_min, face_max=face_max)
    forest = None
    if bvh is not None and phong_tess_alpha == 0.0 and clusters is None:
        from pbr_tpu_torch.accel.forest import build_forest
        from pbr_tpu_torch.ops.cuda_bvh import packet_fits

        # The forest is the big-scene fallback when no ClusterSet exists
        # (auto prefers the cull-and-sweep); building one next to clusters
        # would duplicate geometry that is never walked. Explicit builds go
        # through accel.forest.build_forest.
        if not packet_fits(bvh, tris):
            forest = build_forest(tris)
    materials = obj.mtl.to_soa()
    lights = lights_to_soa(obj.lights) if obj.lights else no_lights()
    return Scene(
        tris=tris, bvh=bvh, materials=materials, lights=lights, forest=forest,
        clusters=clusters,
    )


def bvh_max_leaf(scene: Scene) -> int:
    """The static per-leaf face bound a traversal must unroll for this
    scene's BVH (host-side: call before jit). 2 for BVH-less scenes (the
    reference's compile-time assumption, pt_bvh.cl:35-46)."""
    if scene.bvh is None:
        return 2
    return max(2, int(np.max(np.asarray(scene.bvh.leaf_count))))


def derive_static_flags(scene, settings: RenderSettings) -> RenderSettings:
    """Scene-derived static jit specializations (the reference's
    ``#PLACEHOLDER#`` bake, CL.cpp:626-705, applied at trace time):
    currently ``no_transparency`` when every material is opaque (d == 1 —
    the transmit branch is then statically dead; bitwise-identical
    output, measurably less per-bounce VPU work). Never *unsets* a flag
    the caller pinned."""
    import numpy as np

    if not settings.no_transparency:
        d = np.asarray(scene.materials.d)
        if d.size == 0 or bool((d >= 1.0).all()):
            settings = settings.replace(no_transparency=True)
    return settings


def apply_scene_constants(settings: RenderSettings, obj: ObjData) -> RenderSettings:
    """Fix scene-derived static settings: sky color from the ``sky_light``
    material (white fallback, PathTracer.cpp:514-516) and shadow-ray
    disabling when the scene has no lights (LightParser.cpp:116-121)."""
    sky = obj.mtl.sky_light()
    kw = {}
    if sky is not None:
        kw["sky_light"] = tuple(float(c) for c in sky)
    if not obj.lights and settings.shadow_rays:
        kw["shadow_rays"] = 0
    return settings.replace(**kw) if kw else settings


def scene_from_text(
    obj_text: str,
    mtl_text: str = "",
    lights_text: str = "",
    bvh_cfg: Optional[BVHConfig] = None,
    use_bvh: bool = True,
    phong_tess_alpha: float = 0.0,
) -> Tuple[Scene, ObjData]:
    """Build a scene directly from OBJ/MTL/.lights text (procedural scenes
    and tests)."""
    from pbr_tpu_torch.io.lights import parse_lights
    from pbr_tpu_torch.io.mtl import parse_mtl
    from pbr_tpu_torch.io.obj import parse_obj

    mtl = parse_mtl(mtl_text) if mtl_text else None
    lights = parse_lights(lights_text) if lights_text else []
    obj = parse_obj(obj_text, mtl=mtl, lights=lights)
    return (
        build_scene(
            obj, bvh_cfg=bvh_cfg, use_bvh=use_bvh, phong_tess_alpha=phong_tess_alpha
        ),
        obj,
    )
