"""The port's own NumPy host layer (``pbr_tpu_torch.scene``, ``.io``,
``.accel``, ``.utils``) against the JAX package's, which it copies: every
array of every ``Scene`` built by both must be equal byte for byte (dtype,
shape and bytes), for scenes that reach each builder: no BVH, the NumPy BVH
builder, the native (g++) builder, and both cluster sizes (64 and 128
faces). The port's build never makes a BVH forest; neither does the JAX
package's for these scenes, since they all carry clusters or no BVH.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pbr_tpu.io.loader import load_model as jax_load_model
from pbr_tpu.scene import build as jax_build
from pbr_tpu.scene import camera as jax_camera
from pbr_tpu.scene import procedural as jax_procedural
from pbr_tpu.utils import config as jax_config
from pbr_tpu.utils import morton as jax_morton
from pbr_tpu_torch.accel import clusters as port_clusters
from pbr_tpu_torch.accel import native as port_native
from pbr_tpu_torch.io.loader import load_model as port_load_model
from pbr_tpu_torch.scene import build as port_build
from pbr_tpu_torch.scene import camera as port_camera
from pbr_tpu_torch.scene import procedural as port_procedural
from pbr_tpu_torch.scene import to_torch
from pbr_tpu_torch.utils import config as port_config
from pbr_tpu_torch.utils import morton as port_morton

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

# name: (procedural scene, its arguments, use_bvh, cluster size or None)
SCENES = {
    "cornell-brute": ("cornell_box", (), False, None),
    "cornell-bvh": ("cornell_box", (), True, None),
    "multiroom": ("multi_room", (), True, 64),
    "soup4000-numpy-bvh": ("random_soup", (4000,), True, 64),
    "soup20000-native-bvh": ("random_soup", (20000, 5), True, 64),
    "soup51000-native-128": ("random_soup", (51000, 11), True, 128),
}


def _assert_same(a, b, where: str) -> None:
    """Recursive byte-for-byte equality of two host structures."""
    if a is None or b is None:
        assert a is None and b is None, where
    elif isinstance(a, tuple):  # NamedTuples: Scene, SoAs, Vec3, ClusterSet
        assert type(a).__name__ == type(b).__name__, where
        assert getattr(a, "_fields", None) == getattr(b, "_fields", None), where
        assert len(a) == len(b), where
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            _assert_same(x, y, f"{where}.{name}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, \
            f"{where}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
        assert x.tobytes() == y.tobytes(), f"{where}: values differ"


def _texts(module, name, args):
    out = getattr(module, name)(*args)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_equals_the_jax_host_layer(name):
    fn, args, use_bvh, size = SCENES[name]
    texts = _texts(port_procedural, fn, args)
    assert texts == _texts(jax_procedural, fn, args)  # the OBJ/MTL/.lights text
    ref, _ = jax_build.scene_from_text(*texts, use_bvh=use_bvh)
    got, _ = port_build.scene_from_text(*texts, use_bvh=use_bvh)
    _assert_same(got, ref, name)
    assert got.forest is None and ref.forest is None
    if size is None:
        assert got.clusters is None
    else:
        assert got.clusters.coeffs.shape[2] == 4 * size
        c = got.clusters.coeffs.shape[0]
        assert to_torch(got, "cpu").clusters.compact.shape == (c, size, 20)


def test_native_builder_is_the_one_that_ran():
    """The 20,000-face soup goes through the port's native builder (g++),
    whose BVH equals the NumPy builder's byte for byte."""
    assert port_native.available()
    texts = _texts(port_procedural, "random_soup", (20000, 5))
    got, _ = port_build.scene_from_text(*texts, use_bvh=True)
    from pbr_tpu_torch.accel.bvh import build_bvh
    from pbr_tpu_torch.io.obj import parse_obj
    from pbr_tpu_torch.scene.types import make_triangles

    obj = parse_obj(texts[0])
    t = make_triangles(obj.vertices, obj.faces_v, None, None, obj.faces_mtl)
    v0, v1, v2 = t.v0.stack(np), (t.v0 + t.e1).stack(np), (t.v0 + t.e2).stack(np)
    cfg = port_config.BVHConfig()  # 20,000 faces: not above the 64-leaf threshold
    bvh_n, order_n = port_native.build_bvh_native(v0, v1, v2, cfg)
    bvh_p, order_p, _ = build_bvh(v0, v1, v2, cfg)
    _assert_same(bvh_n, bvh_p, "bvh")
    np.testing.assert_array_equal(order_n, order_p)
    _assert_same(got.bvh, bvh_n, "scene.bvh")


def test_build_clusters_128_on_a_small_soup():
    """``build_clusters(size=128)`` directly, on a soup the build would
    cut in 64-face clusters."""
    from pbr_tpu.accel import clusters as jax_clusters

    texts = _texts(port_procedural, "random_soup", (3000, 2))
    scene, _ = port_build.scene_from_text(*texts, use_bvh=True)
    jscene, _ = jax_build.scene_from_text(*texts, use_bvh=True)
    got = port_clusters.build_clusters(scene.tris, size=128)
    ref = jax_clusters.build_clusters(jscene.tris, size=128)
    _assert_same(got, ref, "clusters")
    assert got.coeffs.shape == (32, 16, 512)


def test_load_model_from_files(tmp_path):
    """The file path (OBJ with .mtl and .lights companions) loads the same
    scene and settings."""
    obj, mtl, li = jax_procedural.cornell_box()
    (tmp_path / "box.obj").write_text(obj)
    (tmp_path / "box.mtl").write_text(mtl)
    (tmp_path / "box.lights").write_text(li)
    path = str(tmp_path / "box.obj")
    ref_scene, ref_settings, _ = jax_load_model(path, jax_config.RenderSettings())
    got_scene, got_settings, _ = port_load_model(path, port_config.RenderSettings())
    _assert_same(got_scene, ref_scene, "load_model")
    assert dataclasses.asdict(got_settings) == dataclasses.asdict(ref_settings)


@pytest.mark.parametrize("kw", [
    dict(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0)),
    dict(eye=(0.3, -2.0, 5.0), center_dir=(0.2, 0.4, -1.0), up=(0.0, 0.0, 1.0),
         focal_length=0.05, aperture=2.8, focus=4.0),
])
def test_camera_state_and_pixel_dim(kw):
    _assert_same(port_camera.make_camera_state(**kw), jax_camera.make_camera_state(**kw),
                 "camera")
    for w, h, fov in ((1024, 1024, 60.0), (640, 360, 45.0), (7, 3, 90.0)):
        assert port_camera.pixel_dim(w, h, fov) == jax_camera.pixel_dim(w, h, fov)


@pytest.mark.parametrize("w, h", [(64, 64), (1024, 1024), (48, 40), (33, 17)])
def test_morton_pixel_ids(w, h):
    _assert_same(port_morton.morton_pixel_ids(w, h), jax_morton.morton_pixel_ids(w, h),
                 "morton")


def test_settings_defaults_and_constants():
    assert dataclasses.asdict(port_config.RenderSettings()) == \
        dataclasses.asdict(jax_config.RenderSettings())
    assert dataclasses.asdict(port_config.BVHConfig()) == \
        dataclasses.asdict(jax_config.BVHConfig())
    for name in ("EPSILON5", "NI_AIR", "BRDF_SCHLICK", "BRDF_SHIRLEY_ASHIKHMIN", "ACCEL_BVH"):
        assert getattr(port_config, name) == getattr(jax_config, name), name
    s = port_config.RenderSettings(width=8).replace(samples=3)
    assert (s.width, s.samples) == (8, 3)
