"""pbr_tpu_torch — the PyTorch and CUDA port of ``pbr_tpu``.

The render path of the JAX package on torch tensors, forward and under
autograd, with its intersect kernels written in CUDA for Hopper (sm_90a):
the fused brute-force sweep (K1, and its linear form K2), the gated sweep
over per-tile cluster verdicts (K3) for scenes in the mid band, and the
cull-and-sweep over near-to-far candidate clusters (K4, and its masked
variant K4m) for big scenes.
It imports ``torch`` and NumPy, never JAX and nothing of ``pbr_tpu``:
scenes come from the port's own NumPy host layer (``scene/``, ``io/``,
``accel/``, ``utils/``), copies of the JAX package's.

Package layout (each module mirrors its ``pbr_tpu`` counterpart)
----------------------------------------------------------------
- ``app.py``   the command line (``python -m pbr_tpu_torch.app render|fit|view``)
- ``viewer.py`` the terminal viewer
- ``ops/``     SoA vec math, counter RNG, intersection math, BRDFs, the
               intersect dispatch, the cull verdicts and candidate lists,
               the kernels' wrappers and plain versions, the ``gemm`` mode,
               the denoiser and Phong tessellation (``phongtess.py``)
- ``parallel/`` pixel (dp) and sample (sp) sharding on ``torch.distributed``,
               one process a device
- ``csrc/``    kernel sources (CUDA C++), built with nvcc at first use, and
               the native BVH builder (C++, built with g++ at first use)
- ``models/``  the wavefront integrator and the progressive ``PathTracer``
- ``scene/``   scene types, OBJ assembly, procedural scenes, the camera,
               and ``device.py``: NumPy scene and camera -> tensors
- ``io/``      OBJ/MTL/.lights parsing and ``load_model``
- ``accel/``   BVH builders (NumPy and native), the cluster tables and the
               BVH/light overlays
- ``utils/``   settings, logging, Morton pixel order, PNG/PPM, npz
               checkpoints, the stage timer
"""

from pbr_tpu_torch.models.integrator import trace_rays  # noqa: F401
from pbr_tpu_torch.models.pathtracer import PathTracer  # noqa: F401
from pbr_tpu_torch.scene import SceneParams, camera_to_torch, to_torch  # noqa: F401
