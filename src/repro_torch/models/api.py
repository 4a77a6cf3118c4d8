"""Unified model API of the port: init / loss / prefill / decode — the
twin of the JAX package's `models/api.py` for every family: the dense,
MoE and VLM transformers (GQA or MLA attention; the VLM's M-RoPE
positions from ``batch["positions"]``), the SSM (Mamba2), the hybrid
(Zamba2) and the audio encoder (HuBERT, ``batch["features"]``, no
decode).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encoder, hybrid, ssm_lm, transformer
from repro_torch.models import layers as L


def _module(cfg: ModelConfig):
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "audio":
        return encoder
    return transformer  # dense | moe | vlm


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


def _logits_and_aux(params, cfg: ModelConfig,
                    batch: Dict[str, torch.Tensor]):
    """The forward on a batch: frame features for audio, tokens and
    their M-RoPE positions (when given) for the VLM, tokens otherwise."""
    mod = _module(cfg)
    if cfg.family == "audio":
        return mod.forward(params, cfg, batch["features"])
    if cfg.family == "vlm":
        return mod.forward(params, cfg, batch["tokens"],
                           positions=batch.get("positions"))
    return mod.forward(params, cfg, batch["tokens"])


def loss_fn(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean cross-entropy against ``batch["labels"]`` plus the aux loss
    (the MoE layers' load-balancing loss; zero for the other families)."""
    logits, aux = _logits_and_aux(params, cfg, batch)
    return cross_entropy(logits, batch["labels"]) + aux


def forward(params, cfg: ModelConfig, *args, **kw):
    return _module(cfg).forward(params, cfg, *args, **kw)


def prefill(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Forward returning logits only (inference prefill)."""
    return _logits_and_aux(params, cfg, batch)[0]


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = None):
    """Returns (state_values, state_axes) for the decode carrier (KV
    cache / SSM state / both). It is bf16 by default, whatever the
    model's dtype, as in the reference."""
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode state")
    mod = _module(cfg)
    builder = (mod.init_cache if mod is transformer else mod.init_state)
    return L.split_params(builder(cfg, batch, max_len, dtype,
                                  resolve_device(device)))


def decode_step(params, cfg: ModelConfig, state, tokens, index):
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode step")
    return _module(cfg).decode_step(params, cfg, state, tokens, index)
