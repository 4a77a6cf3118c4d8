"""Decoder-only transformer LM, dense, MoE and VLM families (GQA or MLA
attention, RoPE partial or M-RoPE; SwiGLU or GELU MLP or grouped-capacity
MoE, DeepSeek's first layers dense) — the twin of the JAX package's
`models/transformer.py`.

The layer weights are stacked on a leading ``layers`` axis, as in the
reference, and a Python loop over that axis takes the place of
`lax.scan`, each layer under the config's activation-checkpointing
policy (`remat`); ``first_k_dense`` layers form a second stack,
``dense_layers``, run first. Parameters are drawn from an explicit
`torch.Generator` with the reference's shapes, scales and fp32 storage;
the numbers differ from `jax.random`'s, so the tests carry weights across
with `bridge`.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.tree import flatten, tree_map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_layers(gen: torch.Generator, cfg: ModelConfig, n: int,
                dense_ffn: bool = False) -> Dict[str, Any]:
    """``n`` layers' params, each drawn directly with a leading ``layers``
    axis (the reference builds per-layer trees and stacks them). MLA or
    GQA attention by the config; MoE unless ``dense_ffn`` or the config
    has none, else an MLP of ``dense_d_ff`` (dense layers) or ``d_ff``."""
    d = cfg.d_model
    p: Dict[str, Any] = {
        "ln1": L.init_rmsnorm(d, gen.device, n),
        "ln2": L.init_rmsnorm(d, gen.device, n),
        "attn": (L.init_mla(gen, cfg, n) if cfg.mla is not None
                 else L.init_attention(gen, cfg, n)),
    }
    if cfg.moe is not None and not dense_ffn:
        p["moe"] = L.init_moe(gen, cfg, n)
    else:
        d_ff = cfg.dense_d_ff if (dense_ffn and cfg.dense_d_ff) else cfg.d_ff
        p["mlp"] = L.init_mlp(gen, d, d_ff, cfg.mlp_variant, n)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    n_dense = cfg.first_k_dense
    p: Dict[str, Any] = {
        "embed": L._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), scale=0.02),
        "final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
        "layers": init_layers(gen, cfg, cfg.n_layers - n_dense),
    }
    if n_dense:
        p["dense_layers"] = init_layers(gen, cfg, n_dense, dense_ffn=True)
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


def _groups(params) -> List[str]:
    """The stacked layer groups in the order they run."""
    return ["dense_layers", "layers"] if "dense_layers" in params \
        else ["layers"]


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the outputs of products without a batch
    dimension (``mm``, ``addmm``) and recompute everything else — ``bmm``,
    the kernels' outputs, the casts and the elementwise ops — as JAX's
    `checkpoint_dots_with_no_batch_dims` does."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)`` under the config's activation-checkpointing policy
    (the reference's `_remat` over one scanned layer body): ``"full"``
    keeps only the inputs and recomputes the layer in the backward pass;
    ``"dots"`` also keeps its ``mm``/``addmm`` outputs (`dots_policy`).
    The recompute runs the layer's kernels (their autograd Functions)
    again. Without a gradient (prefill, decode, serving) ``fn`` runs as
    it is, as the reference's checkpoint is a no-op there."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              dots_policy))
    raise ValueError(f"unknown remat policy {cfg.remat!r}; known: "
                     "('none', 'full', 'dots')")


def _layer_apply(lp, cfg: ModelConfig, x, positions, cache=None,
                 cache_index=None):
    """One layer: returns (x, aux loss or None for an MLP layer, cache)."""
    attn = L.mla_attention if cfg.mla is not None else L.attention
    h, new_cache = attn(lp["attn"], cfg, L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                        positions, cache, cache_index)
    x = x + h
    ffn_in = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        y, aux = L.moe(lp["moe"], cfg, ffn_in)
    else:
        y, aux = L.mlp(lp["mlp"], ffn_in), None
    return x + y, aux, new_cache


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    dtype = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(dtype).T
    return x @ params["lm_head"].to(dtype)


def forward(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            positions: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None):
    """tokens: (B,S) integer, or ``input_embeds`` (B,S,d) for a stubbed
    frontend (the VLM's patch embeddings). positions: (B,S), or (3,B,S)
    t/h/w rows for M-RoPE; by default each row is 0..S-1. Returns logits
    (B,S,V) and the aux loss summed over the MoE layers (zero without
    any)."""
    if input_embeds is not None:
        x = input_embeds.to(torch_dtype(cfg.dtype))
    else:
        x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.mrope_sections:
            positions = positions.expand(3, B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(x, lp):
        return _layer_apply(lp, cfg, x, positions)[:2]

    for group in _groups(params):
        for lp in _layers(params[group]):
            x, aux = remat(cfg, layer, x, lp)
            if aux is not None:
                aux_total = aux_total + aux
    return _head(params, cfg, x), aux_total


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Per layer group: K and V (B, max_len, KV, hd) for GQA, or MLA's
    latent ``c_kv`` (B, max_len, kv_lora_rank) and ``k_rope``. With
    ``cfg.kv_quant`` GQA's K and V are int8, with fp32 ``k_scale`` and
    ``v_scale`` (B, max_len, KV); MLA's latent cache ignores it, as in
    the reference."""
    def zeros(n, *shape, axes, dtype=dtype):
        return L.Param(torch.zeros((n, batch, max_len) + shape, dtype=dtype,
                                   device=device),
                       ("layers", "batch", "kv_seq") + axes)

    def group(n):
        if cfg.mla is not None:
            m = cfg.mla
            return {"c_kv": zeros(n, m.kv_lora_rank, axes=("qk_lora",)),
                    "k_rope": zeros(n, m.qk_rope_head_dim, axes=(None,))}
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        kv_dtype = torch.int8 if cfg.kv_quant else dtype
        c = {"k": zeros(n, kv, hd, axes=("kv_heads", None), dtype=kv_dtype),
             "v": zeros(n, kv, hd, axes=("kv_heads", None), dtype=kv_dtype)}
        if cfg.kv_quant:
            c["k_scale"] = zeros(n, kv, axes=("kv_heads",),
                                 dtype=torch.float32)
            c["v_scale"] = zeros(n, kv, axes=("kv_heads",),
                                 dtype=torch.float32)
        return c

    c = {"layers": group(cfg.n_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        c["dense_layers"] = group(cfg.first_k_dense)
    return c


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
    if cfg.mrope_sections:
        pos = pos.expand(3, B, 1)
    for group in _groups(params):
        for lp, lc in zip(_layers(params[group]), _layers(cache[group])):
            x, _, _ = _layer_apply(lp, cfg, x, pos, cache=lc,
                                   cache_index=index)
    return _head(params, cfg, x)[:, 0], cache
