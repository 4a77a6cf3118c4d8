from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RunConfig,
    SSMConfig,
)
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: F401
