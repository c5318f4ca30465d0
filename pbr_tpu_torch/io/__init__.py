from pbr_tpu_torch.io.lights import LightDef, parse_lights_file  # noqa: F401
from pbr_tpu_torch.io.mtl import MaterialDef, parse_mtl_file  # noqa: F401
from pbr_tpu_torch.io.obj import ObjData, parse_obj_file  # noqa: F401

# pbr_tpu_torch.io.loader (load_model) is imported lazily to avoid a cycle with
# pbr_tpu_torch.scene.build.


def load_model(*args, **kw):
    from pbr_tpu_torch.io.loader import load_model as _lm

    return _lm(*args, **kw)
