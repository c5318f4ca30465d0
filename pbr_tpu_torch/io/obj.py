"""Wavefront OBJ parser (triangular faces, reference semantics).

Reference: ``source/ObjParser.{h,cpp}``. Supported records: ``o`` (objects,
ObjParser.cpp:159-166), ``v``/``vn``/``vt`` (:168-181), triangular ``f`` in
all four index formats — ``v``, ``v/vt``, ``v/vt/vn``, ``v//vn`` — including
negative (relative) indices (parseFace, :258-301), and ``usemtl`` mapping
each following face to a material index (-1 when unknown, :202-207). Per-OBJ
companion files are discovered by extension swap: ``.mtl`` always,
``.lights`` only when shadow rays are enabled (:228-245, :133-137).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pbr_tpu_torch.io.lights import LightDef, parse_lights_file
from pbr_tpu_torch.io.mtl import MtlLibrary, parse_mtl_file
from pbr_tpu_torch.utils.log import Logger, Timer


@dataclass
class Object3D:
    """A named sub-object: indices into the global face list
    (reference object3D, ObjParser.h:22-26)."""

    name: str
    face_indices: List[int] = field(default_factory=list)


@dataclass
class ObjData:
    vertices: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (Nn, 3) float32
    texcoords: np.ndarray  # (T, 3) float32
    faces_v: np.ndarray  # (F, 3) int32 vertex indices
    faces_vn: np.ndarray  # (F, 3) int32 normal indices (or empty)
    faces_vt: np.ndarray  # (F, 3) int32 texcoord indices (or empty)
    faces_mtl: np.ndarray  # (F,) int32 material index, -1 = none
    objects: List[Object3D]
    mtl: MtlLibrary
    lights: List[LightDef]

    @property
    def num_faces(self) -> int:
        return int(self.faces_v.shape[0])


def _parse_index(tok: str, count: int) -> int:
    """OBJ 1-based index → 0-based; negative indices are relative to the end
    of the list parsed so far (standard OBJ; the reference's variant at
    ObjParser.cpp:272-300 had a bug using the face count — we implement the
    spec behavior, which matches for the reference's own test scenes where
    negative indices never occur)."""
    i = int(tok)
    return count + i if i < 0 else i - 1


def parse_obj(
    text: str,
    mtl: Optional[MtlLibrary] = None,
    lights: Optional[List[LightDef]] = None,
) -> ObjData:
    mtl = mtl if mtl is not None else MtlLibrary()
    lights = lights if lights is not None else []
    names = mtl.names

    vertices: List[float] = []
    normals: List[float] = []
    texcoords: List[float] = []
    faces_v: List[int] = []
    faces_vn: List[int] = []
    faces_vt: List[int] = []
    faces_mtl: List[int] = []
    objects: List[Object3D] = []
    current_mtl = -1

    t = Timer()
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0]
        if key == "o" and len(parts) >= 2:
            objects.append(Object3D(name=parts[1]))
        elif key == "v":
            vertices.extend((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "vn":
            normals.extend((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "vt":
            w = float(parts[3]) if len(parts) >= 4 else 0.0
            texcoords.extend((float(parts[1]), float(parts[2]), w))
        elif key == "f":
            if len(parts) != 4:
                Logger.warning("[obj] Non-triangular face encountered; skipping "
                               "(the reference only supports triangles, ObjParser.cpp:252)")
                continue
            fidx = len(faces_mtl)
            for tok in parts[1:4]:
                if "//" in tok:
                    vs, ns = tok.split("//")
                    faces_v.append(_parse_index(vs, len(vertices) // 3))
                    faces_vn.append(_parse_index(ns, len(normals) // 3))
                else:
                    comps = tok.split("/")
                    faces_v.append(_parse_index(comps[0], len(vertices) // 3))
                    if len(comps) >= 2 and comps[1]:
                        faces_vt.append(_parse_index(comps[1], len(texcoords) // 3))
                    if len(comps) >= 3 and comps[2]:
                        faces_vn.append(_parse_index(comps[2], len(normals) // 3))
            faces_mtl.append(current_mtl)
            if objects:
                objects[-1].face_indices.append(fidx)
        elif key == "usemtl" and len(parts) >= 2:
            current_mtl = names.index(parts[1]) if parts[1] in names else -1

    data = ObjData(
        vertices=np.asarray(vertices, dtype=np.float32).reshape(-1, 3),
        normals=np.asarray(normals, dtype=np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, dtype=np.float32).reshape(-1, 3),
        faces_v=np.asarray(faces_v, dtype=np.int32).reshape(-1, 3),
        faces_vn=np.asarray(faces_vn, dtype=np.int32).reshape(-1, 3)
        if len(faces_vn) == len(faces_v)
        else np.zeros((0, 3), dtype=np.int32),
        faces_vt=np.asarray(faces_vt, dtype=np.int32).reshape(-1, 3)
        if len(faces_vt) == len(faces_v)
        else np.zeros((0, 3), dtype=np.int32),
        faces_mtl=np.asarray(faces_mtl, dtype=np.int32),
        objects=objects,
        mtl=mtl,
        lights=lights,
    )
    Logger.info(
        f"[obj] Loaded {data.vertices.shape[0]} vertices, {data.normals.shape[0]} normals,"
        f" and {data.num_faces} faces in {t.s():.3g} s."
    )
    return data


def parse_obj_file(path: str, load_lights: bool = True) -> ObjData:
    """Parse an OBJ file plus its ``.mtl`` / ``.lights`` companions
    (extension-swap discovery, ObjParser.cpp:228-245)."""
    base, _ = os.path.splitext(path)
    mtl = parse_mtl_file(base + ".mtl")
    lights = parse_lights_file(base + ".lights") if load_lights and os.path.exists(base + ".lights") else []
    with open(path) as fh:
        return parse_obj(fh.read(), mtl=mtl, lights=lights)
