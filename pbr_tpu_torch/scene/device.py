"""NumPy scene and camera -> the port's tensors.

The counterpart of ``pbr_tpu/scene/build.py::to_device``. Scenes are built
by the port's NumPy host layer (``pbr_tpu_torch.scene.build``,
``pbr_tpu_torch.scene.procedural``, ``pbr_tpu_torch.io``); this module only
moves the result onto a torch device:

- floats become float32 and indices int32;
- the fields a gradient may later target (materials, lights) live in an
  ``nn.Module``, ``SceneParams``, as parameters with ``requires_grad`` off —
  switching it on is all a gradient pass needs. Geometry is held as
  buffers: the renderer detaches it, as the JAX package does;
- ``camera_to_torch`` turns the camera into 0-d tensors.

Of a ``Scene``'s acceleration tables, what the kernels read is carried
over: for the gated sweep (kernel K3, ``ops/cuda_gated.py``) and the
cull-and-sweep (kernels K4 and K4m, ``ops/cuda_cull.py``) the fine cluster
AABBs, the compact table of the coefficient blocks
(``ops/cuda_cull.py::compact_table``, repacked here once a scene), the
supercluster AABBs, the scene bounds and the cluster size of its
``ClusterSet`` (``SceneParams.clusters``), and for K3 its face-major
linear-form table (``SceneParams.clu_gated_fm``, built here once a scene);
for the row sweep (kernels K5 and K5m, ``ops/cuda_sweep.py``) its lin
tables, stored face-major (``SceneParams.clu_lin_fm``, repacked here once
a scene), and the lin-cluster AABBs as well; for the tree walks (kernels
K6, K7 and K8, ``ops/cuda_bvh.py``) the ``LinearBVH``
(``SceneParams.bvh``, with K8's packed node and face records, built here
once a scene) and the ``BVHForest`` (``SceneParams.forest``, with the
packed records of its sub-trees and faces, built here once a scene); for
the Phong searches (kernels K9 and K10, ``ops/cuda_phong.py``) of a scene
with curved faces, their face table (``SceneParams.phong_records``, built
here once a scene).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from pbr_tpu_torch.ops.cuda_cull import compact_table
from pbr_tpu_torch.ops.cuda_gated import GATE_CLUSTER, gated_table
from pbr_tpu_torch.ops.cuda_intersect import face_records, face_table
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.types import (
    CameraState,
    LightsSoA,
    MaterialsSoA,
    Scene,
    TrianglesSoA,
)

_TRI_VEC = ("v0", "e1", "e2", "n0", "n1", "n2")
_MAT_SCALAR = ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd")
_MAT_VEC = ("kd", "ks")


# torch.tensor copies: the port never aliases the caller's NumPy arrays.
def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def _stack3(v, device) -> torch.Tensor:
    """(3, N) float32 tensor from a NumPy Vec3 of (N,) arrays."""
    return _f32(np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)]), device)


def _vec(t: torch.Tensor) -> Vec3:
    """Vec3 of row views of a (3, N) tensor (views keep autograd links)."""
    return Vec3(t[0], t[1], t[2])


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ClusterTables(NamedTuple):
    """The part of a ``ClusterSet`` that the gated sweep and the
    cull-and-sweep read. Cluster ``c`` holds faces ``[c * size, (c + 1) *
    size)``; C * size >= F, and C is a multiple of ``SUPER`` (16):

    - ``bb_min``/``bb_max``: fine cluster AABBs, Vec3s of (C,) (padding
      clusters are inverted boxes);
    - ``size``: faces per cluster, 64 or 128;
    - ``compact``: (C, size, 20) float32, the compact table that kernels
      K4 and K4m read: the entries of the ``ClusterSet``'s coefficient
      blocks (``accel/clusters.py``: ``[det | tnum | unum | vnum]`` against
      the ray features ``[o, d, o x d, 1, t_limit]``) that can be nonzero,
      19 a face (``ops/cuda_cull.py::compact_table``);
    - ``sup_min``/``sup_max``: supercluster AABBs, Vec3s of (C / 16,);
    - ``scene_min``/``scene_max``: Vec3s of 0-d tensors, the Morton bounds
      of the coherence sort;
    - ``lin``: the row sweep's (CL, 16, 128) float32 lin tables, lin
      cluster ``c`` holding faces ``[c * 128, (c + 1) * 128)`` (rows m, km,
      w, q, e1, e2 of the linear form; padding faces all zero), stored
      face-major: a transposed view of ``SceneParams.clu_lin_fm``, and
      ``lbb_min``/``lbb_max`` their AABBs, Vec3s of (CL,) (padding clusters
      inverted). A supercluster covers CL / (C / 16) consecutive lin
      clusters. None where the ``ClusterSet`` carries no lin tables;
    - ``gated``: the gated sweep's (C * 64, 16) float32 linear-form table,
      face-major (``ops/cuda_gated.py::gated_table`` transposed: a face's
      16 constants m, km, w, q, e1, e2 in 64 contiguous bytes), which
      kernel K3 and its plain version read. None unless ``size`` is 64."""

    bb_min: Vec3
    bb_max: Vec3
    size: int
    compact: torch.Tensor
    sup_min: Vec3
    sup_max: Vec3
    scene_min: Vec3
    scene_max: Vec3
    lin: Optional[torch.Tensor] = None
    lbb_min: Optional[Vec3] = None
    lbb_max: Optional[Vec3] = None
    gated: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return int(self.bb_min.x.shape[0])


class BVHTables(NamedTuple):
    """A ``LinearBVH`` on the device, as the tree walks read it:
    ``bb_min``/``bb_max`` (3, N) float32 node bounds (rows x, y, z) and
    ``leaf_first``/``leaf_count``/``exit`` (N,) int32 (the TPU kernels' f32
    packing of the indices was a Pallas workaround). ``node_records``
    (N, 8) and ``face_records`` (F, 12) float32 are the kernels' packed
    copies of the same values and of the faces the tree indexes
    (``ops/cuda_bvh.py::node_records``,
    ``ops/cuda_intersect.py::face_records``); ``to_torch`` builds them for
    a scene's tree, and a tree without them has None. ``leaf_max``: the
    faces of the tree's largest leaf, a Python int that ``to_torch`` sets
    (the walks' default leaf bound, ``ops/cuda_bvh.py::leaf_bound``), or
    None. A
    forest's ``ForestTables.trees`` has the first five fields with a
    leading (K,) axis; ``ForestTables.tree(i)`` gives sub-tree i with
    views of its records."""

    bb_min: torch.Tensor
    bb_max: torch.Tensor
    leaf_first: torch.Tensor
    leaf_count: torch.Tensor
    exit: torch.Tensor
    node_records: Optional[torch.Tensor] = None
    face_records: Optional[torch.Tensor] = None
    leaf_max: Optional[int] = None

    @property
    def count(self) -> int:
        return int(self.exit.shape[-1])

    @property
    def root(self) -> tuple:
        """The root's bounds, two Vec3s of 0-d tensors (the coherence sort's
        box)."""
        return _vec(self.bb_min[:, 0]), _vec(self.bb_max[:, 0])


_NODE_FIELDS = BVHTables._fields[:5]  # the (3, N) and (N,) tables


class ForestTables(NamedTuple):
    """A ``BVHForest`` on the device: ``trees``, the K sub-trees' node
    tables stacked (all padded to one node count, so (K, 3, N) and (K, N));
    ``faces``, the (9, K * chunk) float32 forest-order table, rows v0, e1,
    e2 (``ops/cuda_intersect.py::face_table``'s layout); ``face_ids``,
    (K * chunk,) int32 forest slot -> main-order face; ``node_records``
    (K, N, 8) and ``face_records`` (K * chunk, 12) float32, the packed
    records of the sub-trees and of ``faces`` (``ops/cuda_bvh.py::
    node_records``, ``face_records``) that the kernels read (the seeded
    chain all of them, sub-tree 0's walks their first rows); ``to_torch``
    builds them once a scene."""

    trees: BVHTables
    faces: torch.Tensor
    face_ids: torch.Tensor
    node_records: Optional[torch.Tensor] = None
    face_records: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return int(self.trees.exit.shape[0])

    @property
    def chunk(self) -> int:
        return int(self.faces.shape[1]) // self.count

    def tree(self, i: int) -> BVHTables:
        """Sub-tree ``i``'s node tables, with its packed records (views)
        where the forest has them."""
        c = self.chunk
        rec = None if self.node_records is None else (self.node_records[i],
                                                      self.face_records[i * c:(i + 1) * c])
        return BVHTables(*(getattr(self.trees, n)[i] for n in _NODE_FIELDS), *(rec or ()))

    def subtrees(self, lo: int, hi: int) -> "ForestTables":
        """Sub-trees ``lo .. hi - 1`` with their faces and records (views)."""
        c = self.chunk
        cut = lambda a, k: None if a is None else a[lo * k:hi * k]  # noqa: E731
        return ForestTables(BVHTables(*(getattr(self.trees, n)[lo:hi] for n in _NODE_FIELDS)),
                            self.faces[:, lo * c:hi * c], cut(self.face_ids, c),
                            cut(self.node_records, 1), cut(self.face_records, c))


def _bvh_tensors(bvhs, device) -> list:
    """A ``BVHTables``' fields from LinearBVHs, stacked on a new leading
    axis when there are several."""
    fields = [[_stack3(b.bb_min, device) for b in bvhs], [_stack3(b.bb_max, device) for b in bvhs],
              [_i32(b.leaf_first, device) for b in bvhs], [_i32(b.leaf_count, device) for b in bvhs],
              [_i32(b.exit, device) for b in bvhs]]
    return [torch.stack(f) if len(bvhs) > 1 else f[0] for f in fields]


class SceneParams(nn.Module):
    """A scene on one device.

    Parameters (``requires_grad`` off until a gradient pass turns it on):
    the material fields ``mat_<name>`` ((M,), and (3, M) for ``kd``/``ks``)
    and the light fields ``light_pos`` / ``light_rgb`` (3, L) and
    ``light_radius`` (L,). Buffers: the triangle table ``tri_<name>``
    (3, F), the integer fields ``tri_mtl``, ``mat_light``, ``light_type``
    and, when the scene has a ``ClusterSet``, its tables ``clu_bb_min`` /
    ``clu_bb_max`` (3, C), ``clu_compact`` (C, S, 20), ``clu_sup_min`` /
    ``clu_sup_max`` (3, C / 16) and ``clu_scene_min`` / ``clu_scene_max``
    (3,); when it has a BVH, ``bvh_bb_min`` / ``bvh_bb_max`` (3, N),
    ``bvh_leaf_first`` / ``bvh_leaf_count`` / ``bvh_exit`` (N,) and K8's
    ``bvh_node_records`` (N, 8) / ``bvh_face_records`` (F, 12), and the
    int ``bvh_leaf_max``, its largest leaf's faces; when it has
    a forest, ``forest_<field>`` for the K sub-trees' stacked node tables,
    ``forest_faces`` (9, K * chunk), ``forest_face_ids`` and the seeded
    chain's ``forest_node_records`` (K, N, 8) / ``forest_face_records``
    (K * chunk, 12); when some face is curved (its vertex normals differ),
    the Phong searches' face table ``phong_records`` (F', 20), F' the
    clusters' padded face count (``count * size``) or F without clusters,
    and None otherwise. The properties
    ``tris``, ``materials``, ``lights``, ``clusters``, ``bvh`` and ``forest``
    give the SoA NamedTuples of ``pbr_tpu_torch.scene.types`` (and
    ``ClusterTables``, ``BVHTables``, ``ForestTables``, or None) over views
    of these tensors, which is what the renderer consumes.

    For a gradient pass, ``requires_grad_()`` switches on every parameter.
    """

    def __init__(self, scene: Scene, device):
        super().__init__()
        t = scene.tris
        for name in _TRI_VEC:
            self.register_buffer(f"tri_{name}", _stack3(getattr(t, name), device))
        self.register_buffer("tri_mtl", _i32(t.mtl, device))
        m = scene.materials
        for name in _MAT_SCALAR:
            setattr(self, f"mat_{name}", _param(_f32(getattr(m, name), device)))
        for name in _MAT_VEC:
            setattr(self, f"mat_{name}", _param(_stack3(getattr(m, name), device)))
        self.register_buffer("mat_light", _i32(m.light, device))
        li = scene.lights
        self.light_pos = _param(_stack3(li.pos, device))
        self.light_rgb = _param(_stack3(li.rgb, device))
        self.light_radius = _param(_f32(li.radius, device))
        self.register_buffer("light_type", _i32(li.type, device))
        cs = scene.clusters
        self.cluster_size: Optional[int] = None if cs is None else cs.size
        if cs is not None:
            self.register_buffer("clu_bb_min", _stack3(cs.bb_min, device))
            self.register_buffer("clu_bb_max", _stack3(cs.bb_max, device))
            self.register_buffer("clu_compact", compact_table(_f32(cs.coeffs, "cpu")).to(device))
            self.register_buffer("clu_sup_min", _stack3(cs.sup_min, device))
            self.register_buffer("clu_sup_max", _stack3(cs.sup_max, device))
            self.register_buffer("clu_scene_min", _stack3(cs.scene_min, device))
            self.register_buffer("clu_scene_max", _stack3(cs.scene_max, device))
            if cs.size == GATE_CLUSTER:
                # Kernel K3's table, face-major, once a scene.
                self.register_buffer("clu_gated_fm", gated_table(
                    self.tris, cs.bb_min.x.shape[0]).t().contiguous())
        self.has_lin = cs is not None and cs.lin is not None
        if self.has_lin:
            # The row sweep's lin tables, face-major (CL, 128, 16): a lin
            # cluster's table is one straight 8 KB copy for kernels K5 and
            # K5m; ``clusters.lin`` is its (CL, 16, 128) transposed view.
            self.register_buffer("clu_lin_fm",
                                 _f32(np.ascontiguousarray(cs.lin.transpose(0, 2, 1)), device))
            self.register_buffer("clu_lbb_min", _stack3(cs.lbb_min, device))
            self.register_buffer("clu_lbb_max", _stack3(cs.lbb_max, device))
        # Imported here: ops/cuda_bvh.py imports accel/, which imports this
        # package.
        from pbr_tpu_torch.ops.cuda_bvh import node_records

        self.has_bvh = scene.bvh is not None
        if self.has_bvh:
            tree = BVHTables(*_bvh_tensors([scene.bvh], device))
            for name in _NODE_FIELDS:
                self.register_buffer(f"bvh_{name}", getattr(tree, name))
            self.register_buffer("bvh_node_records", node_records(tree))
            self.register_buffer("bvh_face_records", face_records(face_table(self.tris)))
            self.bvh_leaf_max = int(np.max(scene.bvh.leaf_count))
        fo = scene.forest
        self.has_forest = fo is not None
        if self.has_forest:
            k = len(fo.bvhs)
            trees = _bvh_tensors(fo.bvhs, device)
            for name, t in zip(_NODE_FIELDS, trees):
                self.register_buffer(f"forest_{name}", t if k > 1 else t[None])
            self.register_buffer("forest_faces", torch.cat(
                [_stack3(fo.v0, device), _stack3(fo.e1, device), _stack3(fo.e2, device)]))
            self.register_buffer("forest_face_ids", _i32(fo.face_ids, device))
            # The seeded chain's packed records, once a scene (the padding
            # nodes pack as inner nodes with their inverted boxes).
            tables = self.forest.trees
            self.register_buffer("forest_node_records", torch.stack([
                node_records(BVHTables(*(getattr(tables, n)[i] for n in _NODE_FIELDS)))
                for i in range(k)]))
            self.register_buffer("forest_face_records", face_records(self.forest_faces))
        # The Phong searches' face table, once a scene with curved faces.
        from pbr_tpu_torch.ops.phongtess import face_is_flat, phong_records

        curved = not bool(face_is_flat(self.tris).all())
        self.register_buffer("phong_records", phong_records(
            self.tris, None if cs is None else cs.bb_min.x.shape[0] * cs.size) if curved else None)

    @property
    def device(self) -> torch.device:
        return self.tri_mtl.device

    @property
    def tris(self) -> TrianglesSoA:
        vecs = {name: _vec(getattr(self, f"tri_{name}")) for name in _TRI_VEC}
        return TrianglesSoA(mtl=self.tri_mtl, **vecs)

    @property
    def materials(self) -> MaterialsSoA:
        fields = {name: getattr(self, f"mat_{name}") for name in _MAT_SCALAR}
        fields.update({name: _vec(getattr(self, f"mat_{name}")) for name in _MAT_VEC})
        return MaterialsSoA(light=self.mat_light, **fields)

    @property
    def clusters(self) -> Optional[ClusterTables]:
        if self.cluster_size is None:
            return None
        lin = (self.clu_lin_fm.transpose(1, 2), _vec(self.clu_lbb_min),
               _vec(self.clu_lbb_max)) if self.has_lin else ()
        return ClusterTables(
            _vec(self.clu_bb_min), _vec(self.clu_bb_max), self.cluster_size,
            self.clu_compact, _vec(self.clu_sup_min), _vec(self.clu_sup_max),
            _vec(self.clu_scene_min), _vec(self.clu_scene_max), *lin,
            gated=getattr(self, "clu_gated_fm", None),
        )

    @property
    def bvh(self) -> Optional[BVHTables]:
        if not self.has_bvh:
            return None
        return BVHTables(*(getattr(self, f"bvh_{n}") for n in BVHTables._fields))

    @property
    def forest(self) -> Optional[ForestTables]:
        if not self.has_forest:
            return None
        trees = BVHTables(*(getattr(self, f"forest_{n}") for n in _NODE_FIELDS))
        return ForestTables(trees, self.forest_faces, self.forest_face_ids,
                            getattr(self, "forest_node_records", None),
                            getattr(self, "forest_face_records", None))

    @property
    def lights(self) -> LightsSoA:
        return LightsSoA(
            pos=_vec(self.light_pos), rgb=_vec(self.light_rgb),
            radius=self.light_radius, type=self.light_type,
        )


def to_torch(scene: Scene, device="cuda") -> SceneParams:
    """Move a NumPy ``Scene`` onto ``device`` (the card unless the caller
    names another device)."""
    return SceneParams(scene, device)


def camera_to_torch(cam: CameraState, device="cuda") -> CameraState:
    """A NumPy ``CameraState`` as 0-d float32 tensors on ``device`` (the
    card unless the caller names another device)."""
    s = lambda a: _f32(a, device).reshape(())  # noqa: E731
    v = lambda a: Vec3(s(a.x), s(a.y), s(a.z))  # noqa: E731
    return CameraState(
        eye=v(cam.eye), w=v(cam.w), u=v(cam.u), v=v(cam.v),
        focal_length=s(cam.focal_length), aperture=s(cam.aperture),
        focus=s(cam.focus),
    )
