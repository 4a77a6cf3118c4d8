"""Zamba2-style hybrid: a Mamba2 backbone plus ONE weight-shared
attention+MLP block applied after every ``shared_attn_every`` Mamba2
layers — the twin of the JAX package's `models/hybrid.py`.

The tree is the reference's: ``mamba_groups`` stacked as
``(n_groups, every, …)`` with axes ``("groups", "layers", …)``,
``mamba_tail`` for the ``n_layers % every`` layers left over,
``shared_attn``; in the decode state ``groups``, ``attn_cache`` (one KV
cache per application of the shared block) and ``tail``. The Mamba2
layers run through `ssm_lm.run_layers`; the shared block through
`layers.attention` and `layers.mlp`, so on the card its prefill attention
launches the flash kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import ssm_lm
from repro_torch.models.transformer import _head, _layers, remat
from repro_torch.tree import tree_map


def _split_counts(cfg: ModelConfig) -> Tuple[int, int]:
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    rem = cfg.n_layers - n_groups * every
    return n_groups, rem


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    n_groups, rem = _split_counts(cfg)
    every = cfg.shared_attn_every
    grouped = tree_map(
        lambda p: L.Param(p.value.reshape((n_groups, every)
                                          + p.value.shape[1:]),
                          ("groups",) + p.axes),
        ssm_lm.init_layers(gen, cfg, n_groups * every))
    dev = gen.device
    p: Dict[str, Any] = {
        "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), scale=0.02),
        "mamba_groups": grouped,
        "shared_attn": {
            "ln1": L.init_rmsnorm(cfg.d_model, dev),
            "attn": L.init_attention(gen, cfg),
            "ln2": L.init_rmsnorm(cfg.d_model, dev),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff),
        },
        "final_norm": L.init_rmsnorm(cfg.d_model, dev),
        "lm_head": L._dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab")),
    }
    if rem:
        p["mamba_tail"] = ssm_lm.init_layers(gen, cfg, rem)
    return p


def _shared_attn_apply(sp, cfg: ModelConfig, x, positions, cache=None,
                       cache_index=None):
    h, new_cache = L.attention(sp["attn"], cfg,
                               L.rmsnorm(sp["ln1"], x, cfg.norm_eps),
                               positions, cache, cache_index)
    x = x + h
    x = x + L.mlp(sp["mlp"], L.rmsnorm(sp["ln2"], x, cfg.norm_eps))
    return x, new_cache


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """tokens: (B,S) integer. positions: (B,S). Returns logits (B,S,V)
    and a zero aux loss."""
    B, Sq = tokens.shape
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    if positions is None:
        positions = torch.arange(Sq, device=x.device).expand(B, Sq)
    sp = params["shared_attn"]

    def group(x, gp):
        # the reference's group body: its inner layers take the policy
        # too, so under remat the checkpoints nest, as its scans do
        x, _ = ssm_lm.run_layers(gp, cfg, x)
        return _shared_attn_apply(sp, cfg, x, positions)[0]

    for gp in _layers(params["mamba_groups"]):
        x = remat(cfg, group, x, gp)
    if "mamba_tail" in params:
        x, _ = ssm_lm.run_layers(params["mamba_tail"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_state(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """The decode carrier: the Mamba2 states of the groups and the tail,
    and one KV cache an application of the shared block. The shared
    block's cache has no int8 form, as in the reference (whose decode
    then fails on the missing scale leaves): ``cfg.kv_quant`` raises."""
    if cfg.kv_quant:
        raise ValueError(f"kv_quant (the int8 KV cache) is not supported "
                         f"for the {cfg.family!r} family ({cfg.name}): its "
                         "shared-attention cache has no scale leaves")
    n_groups, rem = _split_counts(cfg)
    kv_shape = (n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    st: Dict[str, Any] = {
        "groups": ssm_lm.state_leaves(cfg, batch,
                                      (n_groups, cfg.shared_attn_every),
                                      dtype, device),
        "attn_cache": {
            "k": L.Param(torch.zeros(kv_shape, dtype=dtype, device=device),
                         kv_axes),
            "v": L.Param(torch.zeros(kv_shape, dtype=dtype, device=device),
                         kv_axes),
        },
    }
    if rem:
        st["tail"] = ssm_lm.state_leaves(cfg, batch, (rem,), dtype, device)
    return st


def decode_step(params, cfg: ModelConfig, state, tokens: torch.Tensor,
                index: L.Index):
    """One decode step. tokens: (B,) integer; index: a scalar position or
    a (B,) tensor of per-row positions. Returns (logits (B,V), the new
    state): the KV caches are written in place, the Mamba2 leaves come
    back new, as `ssm_lm.decode_step` gives them."""
    B = tokens.shape[0]
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))[:, None]
    if L._is_scalar(index):
        pos = torch.full((B, 1), int(index), dtype=torch.long,
                         device=x.device)
    else:
        pos = index.long()[:, None]
    sp = params["shared_attn"]
    groups = []
    for gp, gst, gcache in zip(_layers(params["mamba_groups"]),
                               _layers(state["groups"]),
                               _layers(state["attn_cache"])):
        x, new_gst = ssm_lm.run_layers(gp, cfg, x, gst)
        groups.append(new_gst)
        x, _ = _shared_attn_apply(sp, cfg, x, pos, cache=gcache,
                                  cache_index=index)
    new_state: Dict[str, Any] = {
        "groups": {k: torch.stack([g[k] for g in groups])
                   for k in ("conv", "ssm")},
        "attn_cache": state["attn_cache"],
    }
    if "mamba_tail" in params:
        x, new_state["tail"] = ssm_lm.run_layers(params["mamba_tail"], cfg,
                                                 x, state["tail"])
    return _head(params, cfg, x)[:, 0], new_state
