"""Decoder-only transformer LM, dense family — the twin of the JAX
package's `models/transformer.py`.

The layer weights are stacked on a leading ``layers`` axis, as in the
reference, and a Python loop over that axis takes the place of
`lax.scan`. Parameters are drawn from an explicit `torch.Generator` with
the reference's shapes, scales and fp32 storage; the numbers differ from
`jax.random`'s, so the tests carry weights across with `bridge`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.tree import flatten, tree_map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_layers(gen: torch.Generator, cfg: ModelConfig,
                n: int) -> Dict[str, Any]:
    """``n`` layers' params, each drawn directly with a leading ``layers``
    axis (the reference builds per-layer trees and stacks them)."""
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, gen.device, n),
        "ln2": L.init_rmsnorm(cfg.d_model, gen.device, n),
        "attn": L.init_attention(gen, cfg, n),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant, n),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), scale=0.02),
        "final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
        "layers": init_layers(gen, cfg, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _layers(stacked) -> List[Dict[str, Any]]:
    """The per-layer trees of a stacked tree, as views. `unbind` gives all
    layers at once, so autograd stacks their gradients in one copy (an
    index per layer would add a zero-filled stacked gradient per layer)."""
    parts = tree_map(lambda v: v.unbind(0), stacked)
    n = len(next(flatten(parts))[1])
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def check_remat(cfg: ModelConfig) -> None:
    """Activation checkpointing is not ported: every family's forward
    refuses a config that asks for it."""
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} (activation checkpointing) is not ported "
            "yet (ROADMAP.md, queue 1 item 5)")


def _layer_apply(lp, cfg: ModelConfig, x, positions, cache=None,
                 cache_index=None):
    h, new_cache = L.attention(lp["attn"], cfg,
                               L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                               positions, cache, cache_index)
    x = x + h
    y = L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x + y, new_cache


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    dtype = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(dtype).T
    return x @ params["lm_head"].to(dtype)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """tokens: (B,S) integer. positions: (B,S). Returns logits (B,S,V)
    and the aux loss (zero for the dense family)."""
    check_remat(cfg)
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    for lp in _layers(params["layers"]):
        x, _ = _layer_apply(lp, cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet "
                                  "(ROADMAP.md, queue 1 item 6)")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"layers": {
        "k": L.Param(torch.zeros(shape, dtype=dtype, device=device), axes),
        "v": L.Param(torch.zeros(shape, dtype=dtype, device=device), axes),
    }}


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                index: L.Index):
    """One decode step. tokens: (B,) integer; index: scalar position, or
    a (B,) tensor of per-row positions (continuous batching — each slot at
    its own depth). Returns (logits (B,V), cache); the cache is updated
    in place."""
    B = tokens.shape[0]
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))[:, None]
    if L._is_scalar(index):
        pos = torch.full((B, 1), int(index), dtype=torch.long,
                         device=x.device)
    else:
        pos = index.long()[:, None]
    for lp, lc in zip(_layers(params["layers"]), _layers(cache["layers"])):
        x, _ = _layer_apply(lp, cfg, x, pos, cache=lc, cache_index=index)
    return _head(params, cfg, x)[:, 0], cache
