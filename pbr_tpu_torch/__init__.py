"""pbr_tpu_torch — the PyTorch and CUDA port of ``pbr_tpu``.

The render path of the JAX package on torch tensors, forward and under
autograd, with its intersect kernels written in CUDA for Hopper (sm_90a):
the fused brute-force sweep (K1, and its linear form K2) and the gated
sweep over per-tile cluster verdicts (K3) for scenes in the mid band.
It imports ``torch`` and NumPy, never JAX; scenes come from the JAX
package's NumPy host layer (``pbr_tpu.scene``, ``pbr_tpu.io``,
``pbr_tpu.utils``), which imports no JAX either.

Package layout (each module mirrors its ``pbr_tpu`` counterpart)
----------------------------------------------------------------
- ``ops/``     SoA vec math, counter RNG, intersection math, BRDFs, the
               intersect dispatch, the cull verdicts, and the kernels'
               wrappers and plain versions
- ``csrc/``    kernel sources (CUDA C++), built with nvcc at first use
- ``models/``  the wavefront integrator and the progressive ``PathTracer``
- ``scene.py`` NumPy scene and camera -> tensors on a device
"""

from pbr_tpu_torch.models.integrator import trace_rays  # noqa: F401
from pbr_tpu_torch.models.pathtracer import PathTracer  # noqa: F401
from pbr_tpu_torch.scene import SceneParams, camera_to_torch, to_torch  # noqa: F401
