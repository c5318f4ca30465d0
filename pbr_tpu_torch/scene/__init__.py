from pbr_tpu_torch.scene.types import (  # noqa: F401
    CameraState,
    LightsSoA,
    LinearBVH,
    MaterialsSoA,
    Scene,
    TrianglesSoA,
)
from pbr_tpu_torch.scene.device import (  # noqa: F401
    BVHTables,
    ClusterTables,
    ForestTables,
    SceneParams,
    camera_to_torch,
    to_torch,
)
