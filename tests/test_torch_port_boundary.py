"""The port never imports JAX, nor anything of the JAX package
(``pbr_tpu``), not even its NumPy host layer: the port has its own copy.
Checked in fresh interpreters, since this test process has both loaded
already, and in the sources."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> str:
    # One torch thread: the suite runs in parallel worker processes, and a
    # thread per core in each of them oversubscribes the machine.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("module", [
    "pbr_tpu_torch",
    "pbr_tpu_torch.ops.cuda_intersect",
    "pbr_tpu_torch.ops.cuda_gated",
    "pbr_tpu_torch.ops.cull",
    "pbr_tpu_torch.models.pathtracer",
    "pbr_tpu_torch.ops.cuda_cull",
    "pbr_tpu_torch.ops.cuda_sweep",
    "pbr_tpu_torch.scene.build",
    "pbr_tpu_torch.io",
    "pbr_tpu_torch.ops.cuda_bvh",
    "pbr_tpu_torch.ops.cuda_phong",
    "pbr_tpu_torch.accel.forest",
    "pbr_tpu_torch.tools.k4_tiles",
    "pbr_tpu_torch.tools.sweep_chunks",
    "pbr_tpu_torch.tools.k8_walk",
    "pbr_tpu_torch.tools.k5_rows",
    "pbr_tpu_torch.tools.k7_walk",
    "pbr_tpu_torch.tools.k3_tiles",
    "pbr_tpu_torch.tools.k6_chain",
    "pbr_tpu_torch.tools.k6_walk",
    "pbr_tpu_torch.tools.k1_sweep",
    "pbr_tpu_torch.app",
    "pbr_tpu_torch.viewer",
    "pbr_tpu_torch.ops.denoise",
    "pbr_tpu_torch.ops.gemm_intersect",
    "pbr_tpu_torch.utils.image",
    "pbr_tpu_torch.utils.checkpoint",
    "pbr_tpu_torch.utils.profiling",
    "pbr_tpu_torch.accel.visualize",
    "pbr_tpu_torch.tools.colormatrix",
    "pbr_tpu_torch.ops.phongtess",
    "pbr_tpu_torch.parallel",
    "pbr_tpu_torch.parallel.mesh",
    "pbr_tpu_torch.parallel.multihost",
    "pbr_tpu_torch.tools.phong_chunks",
    "pbr_tpu_torch.tools.band_table",
    "pbr_tpu_torch.bench",
    "pbr_tpu_torch.utils.graph",
    "pbr_tpu_torch.tools.graph_steps",
    "pbr_tpu_torch.tools.phong_bands",
    "pbr_tpu_torch.ops.cuda_shade",
    "pbr_tpu_torch.ops.cuda_compact",
])
def test_import_leaves_jax_out(module):
    out = _run(f"import sys, {module}; print('jax' in sys.modules, 'pbr_tpu' in sys.modules)")
    assert out.strip() == "False False"


PORT_FILES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(os.path.join(REPO, "pbr_tpu_torch"))
    for f in files if f.endswith(".py")
) + ["chip_smoke.py"]


def _imported_modules(path: str) -> list:
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_only_the_host_layer(path):
    """The port and chip_smoke.py import only the port's own host layer:
    nothing of the JAX package (``pbr_tpu``) and nothing of JAX."""
    for name in _imported_modules(path):
        assert name.split(".")[0] not in ("jax", "pbr_tpu"), f"{path} imports {name}"


def test_renders_with_jax_blocked():
    """With ``sys.modules['jax']`` and ``sys.modules['pbr_tpu']`` set to
    None any import of JAX or of the JAX package raises; an 8x8 Cornell
    frame, built with the port's host layer, still renders on the CPU,
    finite and not black."""
    out = _run(
        "import sys; sys.modules['jax'] = None; sys.modules['pbr_tpu'] = None\n"
        "import numpy as np\n"
        "from pbr_tpu_torch.scene.build import scene_from_text\n"
        "from pbr_tpu_torch.scene.camera import make_camera_state\n"
        "from pbr_tpu_torch.scene.procedural import cornell_box\n"
        "from pbr_tpu_torch.utils.config import RenderSettings\n"
        "from pbr_tpu_torch import PathTracer\n"
        "scene, _ = scene_from_text(*cornell_box(), use_bvh=False)\n"
        "cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))\n"
        "st = RenderSettings(width=8, height=8, max_depth=3, max_added_depth=5,\n"
        "                    shadow_rays=1, compact_schedule='auto')\n"
        "pt = PathTracer(scene, st, device='cpu')\n"
        "pt.render(cam, frame_seed=1)\n"
        "img = pt.image()\n"
        "print(img.shape, bool(np.isfinite(img).all()), float(img.mean()) > 0.0)\n"
    )
    assert out.strip().splitlines()[-1] == "(8, 8, 3) True True"


def test_multiroom_renders_with_jax_blocked():
    """The mid-band path without JAX or the JAX package: multiroom built
    with its clusters by the port's host layer (its BVH and cluster
    builders are NumPy), rendered at 8x8 through the gated sweep's plain
    version on the CPU."""
    out = _run(
        "import sys; sys.modules['jax'] = None; sys.modules['pbr_tpu'] = None\n"
        "import numpy as np\n"
        "from pbr_tpu_torch.scene.build import scene_from_text\n"
        "from pbr_tpu_torch.scene.camera import make_camera_state\n"
        "from pbr_tpu_torch.scene.procedural import multi_room\n"
        "from pbr_tpu_torch.utils.config import RenderSettings\n"
        "from pbr_tpu_torch import PathTracer\n"
        "from pbr_tpu_torch.ops import traverse\n"
        "scene, _ = scene_from_text(*multi_room(), use_bvh=True)\n"
        "cam = make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0))\n"
        "st = RenderSettings(width=8, height=8, max_depth=3, max_added_depth=5,\n"
        "                    shadow_rays=1, compact_schedule='auto')\n"
        "pt = PathTracer(scene, st, device='cpu')\n"
        "pt.render(cam, frame_seed=1)\n"
        "img = pt.image()\n"
        "mode = traverse.resolve_mode('auto', pt.device, scene.tris.count, True)\n"
        "print(mode, img.shape, bool(np.isfinite(img).all()), float(img.mean()) > 0.0)\n"
    )
    assert out.strip().splitlines()[-1] == "gated (8, 8, 3) True True"


def test_cli_runs_with_jax_blocked(tmp_path):
    """The port's CLI (``python -m pbr_tpu_torch.app``) without JAX or the
    JAX package: an 8x8 render, a 2-step fit and a 2-frame scripted view on
    ``--device cpu``."""
    out = tmp_path / "r.png"
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['pbr_tpu'] = None\n"
        "from pbr_tpu_torch import app\n"
        f"app.main(['render', '--size', '8', '--frames', '2', '--out', {str(out)!r},\n"
        "          '--device', 'cpu'])\n"
        "r = app.main(['fit', '--size', '8', '--steps', '2', '--device', 'cpu'])\n"
        "v = app.main(['view', '--size', '8', '--frames', '2', '--keys', 'w', '--no-draw',\n"
        "              '--device', 'cpu'])\n"
        "print(len(r['losses']), v.frame)\n"
    )
    assert _run(code).strip().splitlines()[-1] == "2 2"
    assert out.stat().st_size > 0
