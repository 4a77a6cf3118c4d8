"""HuBERT-style encoder-only transformer (`hubert-xlarge`) — the twin of
the JAX package's `models/encoder.py`.

The wav2vec2 conv feature stem is a stub, as in the reference: the input
is precomputed frame embeddings (B, T, frontend_dim). They are projected
to d_model, a 31-tap depthwise "same" convolution adds a positional
embedding, bidirectional layers follow (the decoder's `_layer_apply` with
``cfg.causal`` False, so on the card every attention runs the flash
kernel and every norm the RMSNorm kernel), then the final RMSNorm and a
head over the masked-prediction codebook (vocab 504).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_layer_apply, _layers,
                                            init_layers, remat)

_CONV_POS_K = 31


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "frontend_proj": L._dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                       (None, "embed")),
        "pos_conv": L._dense_init(gen, (_CONV_POS_K, cfg.d_model),
                                  (None, "embed"),
                                  scale=1.0 / math.sqrt(_CONV_POS_K)),
        "layers": init_layers(gen, cfg, cfg.n_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
        "head": L._dense_init(gen, (cfg.d_model, cfg.vocab_size),
                              ("embed", "vocab")),
    }


def forward(params, cfg: ModelConfig, features: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """features: (B, T, frontend_dim) frame embeddings. Returns logits
    (B, T, V) and a zero aux loss."""
    dtype = torch_dtype(cfg.dtype)
    x = features.to(dtype) @ params["frontend_proj"].to(dtype)
    B, T, _ = x.shape
    # depthwise "same" conv positional embedding: the 31 shifted products
    # summed in the activation dtype, in the reference's order
    w = params["pos_conv"].to(x.dtype)
    half = _CONV_POS_K // 2
    xp = F.pad(x, (0, 0, half, half))
    pos = sum(xp[:, i:i + T] * w[i] for i in range(_CONV_POS_K))
    x = x + F.gelu(pos, approximate="tanh")   # jax.nn.gelu's tanh form
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)

    def layer(x, lp):
        return _layer_apply(lp, cfg, x, positions)[0]

    for lp in _layers(params["layers"]):
        x = remat(cfg, layer, x, lp)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = x @ params["head"].to(dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
