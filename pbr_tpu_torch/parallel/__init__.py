"""Pixel and sample sharding over ``torch.distributed``: one process a
device (``mesh.py``, ``multihost.py``)."""

from pbr_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    sharded_render,
    sharded_train_step,
)
from pbr_tpu_torch.parallel.multihost import (  # noqa: F401
    global_mesh,
    host_local_pixel_ids,
    initialize,
    multihost_train_step,
    spawn_ranks,
)
