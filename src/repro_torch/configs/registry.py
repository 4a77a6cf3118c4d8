"""Architecture registry of the port: ``--arch <id>`` resolution, for
every architecture id the reference package serves, in its order.
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG
