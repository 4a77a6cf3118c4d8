from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    PREFILL_32K,
    RunConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    TRAIN_4K,
    valid_cells,
)
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: F401
