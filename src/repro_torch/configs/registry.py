"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures whose model path has been ported are listed; the
reference package's other ids raise a "not ported yet" error that names
the ROADMAP queue holding them.
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}

# ids the reference package serves that the port does not carry yet
_NOT_PORTED = (
    "qwen2-vl-2b", "hubert-xlarge", "starcoder2-15b", "stablelm-1.6b",
    "yi-6b",
)

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP.md, "
            f"queue 1); ported: {sorted(_ARCH_MODULES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG

