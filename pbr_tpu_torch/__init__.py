"""pbr_tpu_torch — the PyTorch and CUDA port of ``pbr_tpu``.

The forward render path of the JAX package, on torch tensors, with the
fused brute-force intersect kernel written in CUDA for Hopper (sm_90a).
It imports ``torch`` and NumPy, never JAX; scenes come from the JAX
package's NumPy host layer (``pbr_tpu.scene``, ``pbr_tpu.io``,
``pbr_tpu.utils``), which imports no JAX either.

Package layout (each module mirrors its ``pbr_tpu`` counterpart)
----------------------------------------------------------------
- ``ops/``     SoA vec math, counter RNG, intersection math, BRDFs, the
               brute-force dispatch and kernel K1's wrapper
- ``csrc/``    kernel sources (CUDA C++), built with nvcc at first use
- ``models/``  the wavefront integrator and the progressive ``PathTracer``
- ``scene.py`` NumPy scene and camera -> tensors on a device
"""

from pbr_tpu_torch.models.integrator import trace_rays  # noqa: F401
from pbr_tpu_torch.models.pathtracer import PathTracer  # noqa: F401
from pbr_tpu_torch.scene import SceneParams, camera_to_torch, to_torch  # noqa: F401
