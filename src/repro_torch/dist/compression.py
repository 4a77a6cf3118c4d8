"""Gradient compression with error feedback (§VI-B bandwidth mitigation)
— the twin of the JAX package's `dist/compression.py`, over nested-dict
trees of tensors.

Plain quantization biases SGD; *error feedback* (Karimireddy et al., 2019)
folds each round's quantization residual into the next round's gradient,
so the applied updates track the true gradient sum.

Schemes:
  * ``none`` — identity (residual stays zero);
  * ``bf16`` — round-to-bfloat16 (2x smaller);
  * ``int8`` — per-tensor symmetric int8 (4x smaller vs f32); `torch.round`
    rounds half to even, as `jnp.round` does;
  * ``topk`` — keep the TOPK_FRACTION largest-|g| entries per tensor, each
    shipping an f32 value + int32 index. Which of several equal magnitudes
    survive may differ from `lax.top_k`'s choice.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.tree import flatten, tree_map

#: fraction of gradient entries top-k sparsification keeps per tensor
TOPK_FRACTION = 0.01

SCHEMES = ("none", "bf16", "int8", "topk")
_BYTES_PER_VALUE = {"none": 4.0, "bf16": 2.0, "int8": 1.0,
                    # f32 value + int32 index per surviving entry
                    "topk": 8.0 * TOPK_FRACTION}


def compression_ratio(scheme: str) -> float:
    """Payload bytes per f32 gradient value (feeds the PS capacity model)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; known: {SCHEMES}")
    return _BYTES_PER_VALUE[scheme] / 4.0


def payload_bytes(tree, scheme: str) -> float:
    """Wire bytes of one compressed gradient push."""
    n_values = sum(math.prod(leaf.shape) for _, leaf in flatten(tree))
    return n_values * _BYTES_PER_VALUE[scheme]


def _quantize(x: torch.Tensor, scheme: str) -> torch.Tensor:
    """Lossy round-trip of one tensor (decompressed representation)."""
    if scheme == "none":
        return x
    if scheme == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if scheme == "topk":
        flat = x.reshape(-1)
        k = max(1, int(round(TOPK_FRACTION * flat.numel())))
        _, idx = torch.topk(flat.abs(), k)
        kept = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
        return kept.reshape(x.shape)
    # int8: per-tensor symmetric scale
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale


class ErrorFeedback:
    """Stateless compressor + explicit residual tree (functional style, so
    the residual can live in a checkpointable train state)."""

    def __init__(self, scheme: str = "int8"):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; known: {SCHEMES}")
        self.scheme = scheme

    def init(self, params) -> Any:
        """Zero residual tree shaped like `params` (f32)."""
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def roundtrip(self, grads, residual) -> Tuple[Any, Any]:
        """Compress (grads + residual); return (decompressed update,
        new residual). The decompressed update is what the PS applies."""
        corrected = tree_map(lambda g, r: g.float() + r, grads, residual)
        applied = tree_map(lambda c: _quantize(c, self.scheme), corrected)
        new_residual = tree_map(lambda c, a: c - a, corrected, applied)
        return applied, new_residual
