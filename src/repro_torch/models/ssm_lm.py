"""Mamba2 LM: embedding + stacked Mamba2 blocks + head (attention-free) —
the twin of the JAX package's `models/ssm_lm.py`.

The layer weights are stacked on a leading ``layers`` axis, as in the
reference; a Python loop over that axis (`run_layers`, shared with
`models.hybrid`) takes the place of `scan_layers`. On the card every
block's scan launches the SSD kernel and every norm the RMSNorm kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import _head, _layers, remat


def init_layers(gen: torch.Generator, cfg: ModelConfig,
                n: int) -> Dict[str, Any]:
    """``n`` Mamba2 layers' params, each leaf with a leading ``layers``
    axis."""
    return {"ln": L.init_rmsnorm(cfg.d_model, gen.device, n),
            "mixer": S.init_mamba2(gen, cfg, n)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), scale=0.02),
        "layers": init_layers(gen, cfg, cfg.n_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
        "lm_head": L._dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab")),
    }


def run_layers(layers, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[Dict[str, torch.Tensor]] = None):
    """Apply the stacked layers ``x <- x + mamba2_block(rmsnorm(x))``.
    With a decode ``state`` (stacked ``conv`` and ``ssm`` leaves) each
    layer steps its own slice, and the new state comes back stacked;
    otherwise the second value is None, and each layer runs under the
    config's `remat` policy."""
    per_layer = _layers(layers)
    if state is None:
        def layer(x, lp):
            h, _ = S.mamba2_block(lp["mixer"], cfg,
                                  L.rmsnorm(lp["ln"], x, cfg.norm_eps))
            return x + h

        for lp in per_layer:
            x = remat(cfg, layer, x, lp)
        return x, None
    new = []
    for lp, st in zip(per_layer, zip(state["conv"].unbind(0),
                                     state["ssm"].unbind(0))):
        h, new_st = S.mamba2_block(lp["mixer"], cfg,
                                   L.rmsnorm(lp["ln"], x, cfg.norm_eps),
                                   state=st)
        x = x + h
        new.append(new_st)
    return x, {"conv": torch.stack([c for c, _ in new]),
               "ssm": torch.stack([s for _, s in new])}


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """tokens: (B,S) integer. Returns logits (B,S,V) and a zero aux
    loss; ``positions`` is accepted and unused, as in the reference."""
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    x, _ = run_layers(params["layers"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, cfg, x), aux


def state_leaves(cfg: ModelConfig, batch: int, lead, dtype,
                 device) -> Dict[str, L.Param]:
    """Zero ``conv`` and ``ssm`` decode-state leaves for the layers
    indexed by the ``lead`` dims (each named ``layers``)."""
    conv_shape, ssm_shape = S.mamba2_state_shape(cfg, batch)
    lead = tuple(lead)
    layer_axes = ("layers",) * len(lead)
    return {
        "conv": L.Param(torch.zeros(lead + conv_shape, dtype=dtype,
                                    device=device),
                        layer_axes + ("batch", None, "conv_dim")),
        "ssm": L.Param(torch.zeros(lead + ssm_shape, dtype=dtype,
                                   device=device),
                       layer_axes + ("batch", "ssm_heads", "ssm_state", None)),
    }


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """The decode carrier: each layer's conv window and SSM state (bf16 by
    default); ``max_len`` is unused, as in the reference."""
    return state_leaves(cfg, batch, (cfg.n_layers,), dtype, device)


def decode_step(params, cfg: ModelConfig, state, tokens: torch.Tensor,
                index: L.Index):
    """One token per row against the state. ``index`` is accepted and
    unused (the recurrence needs no position). Returns (logits (B,V), the
    new state); the conv leaves take the activation dtype, as in the
    reference."""
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))[:, None]
    x, new_state = run_layers(params["layers"], cfg, x, state)
    return _head(params, cfg, x)[:, 0], new_state
