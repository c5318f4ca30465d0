from pbr_tpu_torch.utils.config import Config, load_config  # noqa: F401
from pbr_tpu_torch.utils.log import Logger  # noqa: F401
