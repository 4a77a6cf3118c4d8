"""Step factories of the port's inference path — the twins of the JAX
package's `launch/steps.py:make_prefill_step` and `make_serve_step`.

PyTorch runs eagerly, so a step is the plain function; there is nothing
to jit and no sharding to derive on one card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> logits (B,S,V). On the card every
    attention launches the flash-attention kernel and every norm the
    RMSNorm kernel."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode against the KV cache (updated in place)."""
    @torch.no_grad()
    def serve_step(params, state, tokens, index):
        logits, new_state = api.decode_step(params, cfg, state, tokens, index)
        return logits, new_state
    return serve_step
