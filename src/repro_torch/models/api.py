"""Unified model API of the port: init / loss / prefill / decode — the
twin of the JAX package's `models/api.py` for the dense and MoE
transformers (GQA or MLA attention), the SSM (Mamba2) and the hybrid
(Zamba2) families. Audio and VLM raise until their slice is ported
(ROADMAP.md, queue 1 item 9).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid, ssm_lm, transformer
from repro_torch.models import layers as L


def _module(cfg: ModelConfig):
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the {cfg.family!r} family (audio, VLM) is not ported to "
            "repro_torch yet (ROADMAP.md, queue 1 item 9)")
    return transformer


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
         device: DeviceLike = None):
    """Returns (param_values, param_axes) trees. Without a generator the
    weights are drawn from one seeded with 0 on ``device`` (the card
    unless ``device="cpu"``)."""
    mod = _module(cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    return L.split_params(mod.init_params(generator, cfg))


# ---------------------------------------------------------------------------
# losses / steps
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy plus the aux loss (the MoE layers'
    load-balancing loss; zero for the other families)."""
    logits, aux = _module(cfg).forward(params, cfg, batch["tokens"])
    return cross_entropy(logits, batch["labels"]) + aux


def forward(params, cfg: ModelConfig, *args, **kw):
    return _module(cfg).forward(params, cfg, *args, **kw)


def prefill(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Forward returning logits only (inference prefill)."""
    logits, _ = _module(cfg).forward(params, cfg, batch["tokens"])
    return logits


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = None):
    """Returns (state_values, state_axes) for the decode carrier (KV
    cache / SSM state / both). It is bf16 by default, whatever the
    model's dtype, as in the reference."""
    mod = _module(cfg)
    builder = (mod.init_cache if mod is transformer else mod.init_state)
    return L.split_params(builder(cfg, batch, max_len, dtype,
                                  resolve_device(device)))


def decode_step(params, cfg: ModelConfig, state, tokens, index):
    return _module(cfg).decode_step(params, cfg, state, tokens, index)
