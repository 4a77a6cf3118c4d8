"""Shared layers of the port: norms, RoPE, GQA attention (prefill and
single-token decode paths) and the SwiGLU/GELU MLP — the twin of the JAX
package's `models/layers.py`.

Param convention as in the reference: every parameter is built as
``Param(value, axes)`` with logical axis names, and `split_params` splits
a tree into (values, axes). Values are fp32 tensors; layers cast them to
the activation dtype at use, as the reference does.

Every RMSNorm (the residual norms and the qk-norm over head_dim) and
every prefill attention goes through `kernels.ops`, which launches the
hand-written kernel for a tensor on the card. Decode attention over the
cache and the projections stay plain PyTorch, as the reference left them
to XLA.

M-RoPE raises `NotImplementedError` (ROADMAP.md, queue 1 item 9); MLA
and MoE configs are refused by `models.api`, the int8 KV cache by
`transformer.init_cache`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.tree import tree_map

NEG_INF = -1e30
Index = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# Param container
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Param:
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def split_params(tree):
    return (tree_map(lambda p: p.value, tree),
            tree_map(lambda p: p.axes, tree))


def _dense_init(gen: torch.Generator, shape, axes, scale=None,
                n_stack: int = 0) -> Param:
    """Normal(0, scale) with scale 1/sqrt(fan_in) by default. With
    ``n_stack`` the value gets a leading ``layers`` axis of that size (the
    reference stacks per-layer trees; drawing stacked avoids a second
    copy of the weights)."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    lead = (n_stack,) if n_stack else ()
    v = torch.randn(lead + tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(scale)
    return Param(v, (("layers",) if n_stack else ()) + tuple(axes))


def _ones(shape, axes, device, n_stack: int = 0) -> Param:
    lead = (n_stack,) if n_stack else ()
    return Param(torch.ones(lead + tuple(shape), dtype=torch.float32,
                            device=device),
                 (("layers",) if n_stack else ()) + tuple(axes))


def _zeros(shape, axes, device, n_stack: int = 0) -> Param:
    lead = (n_stack,) if n_stack else ()
    return Param(torch.zeros(lead + tuple(shape), dtype=torch.float32,
                             device=device),
                 (("layers",) if n_stack else ()) + tuple(axes))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, device, n_stack: int = 0) -> Dict[str, Param]:
    return {"scale": _ones((d,), ("embed",), device, n_stack)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"].float(), eps)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: rmsnorm over the head_dim of (B,S,H,hd) — the same row
    function as `rmsnorm`, so it takes the same kernel."""
    return ops.rmsnorm(x, scale.float(), eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard / partial)
# ---------------------------------------------------------------------------
def rope_freqs(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rot_frac: float = 1.0,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B,S,H,hd). positions: (B,S)."""
    if mrope_sections:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md, "
                                  "queue 1 item 9)")
    hd = x.shape[-1]
    rot_dim = int(hd * rot_frac)
    if rot_dim == 0:
        return x
    rot_dim -= rot_dim % 2
    inv = rope_freqs(rot_dim, theta, x.device)             # (rot_dim/2,)
    angles = positions[..., None].float() * inv            # (B,S,rot_dim/2)
    cos = torch.cos(angles)[:, :, None, :]                 # (B,S,1,rot_dim/2)
    sin = torch.sin(angles)[:, :, None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., : rot_dim // 2], xr[..., rot_dim // 2:]
    out1 = x1 * cos - x2 * sin                             # fp32, as in JAX
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   n_stack: int = 0) -> Dict[str, Param]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, H, hd), ("embed", "heads", None),
                          n_stack=n_stack),
        "wk": _dense_init(gen, (d, KV, hd), ("embed", "kv_heads", None),
                          n_stack=n_stack),
        "wv": _dense_init(gen, (d, KV, hd), ("embed", "kv_heads", None),
                          n_stack=n_stack),
        "wo": _dense_init(gen, (H, hd, d), ("heads", None, "embed"),
                          scale=1.0 / math.sqrt(H * hd), n_stack=n_stack),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ones((hd,), (None,), gen.device, n_stack)
        p["k_norm"] = _ones((hd,), (None,), gen.device, n_stack)
    return p


def _is_scalar(index: Index) -> bool:
    return not isinstance(index, torch.Tensor) or index.dim() == 0


def _cache_store(buf: torch.Tensor, val: torch.Tensor,
                 index: Index) -> torch.Tensor:
    """Write a decode-step slice into ``buf`` at position ``index`` (axis
    1), in place, and return ``buf``.

    ``index`` is either a scalar — lockstep decode, every row at the same
    depth — or a (B,) vector of per-row positions for continuous batching,
    where each slot sits at its own depth. The vector path requires S == 1
    steps. The reference returns an updated copy; updating in place keeps
    one cache in device memory.
    """
    val = val.to(buf.dtype)
    if _is_scalar(index):
        i = int(index)
        buf[:, i:i + val.shape[1]] = val
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, index.long()] = val[:, 0]
    return buf


def _cache_valid(index: Index, S: int, Sk: int, n_between: int,
                 device=None) -> torch.Tensor:
    """Mask of attendable key positions: kpos <= index + S - 1, shaped with
    ``n_between`` singleton dims between the (optional) batch dim and Sk so
    it broadcasts against the decode logits."""
    kpos = torch.arange(Sk, device=device).reshape(
        (1,) * (n_between + 1) + (Sk,))
    if _is_scalar(index):
        return kpos <= int(index) + S - 1
    last = index.long() + S - 1
    return kpos <= last.reshape((-1,) + (1,) * (n_between + 1))


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) x (d,H,hd) -> (B,S,H,hd), contiguous."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1).to(x.dtype)).view(
        B, S, w.shape[1], w.shape[2])


def attention(params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_index: Optional[Index] = None):
    """Full attention. If ``cache`` is given: decode path (x is (B,1,d));
    the cache is written in place and returned as ``(out, cache)``.
    Otherwise prefill: returns ``(out, None)``."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.partial_rotary > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary,
                       cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary,
                       cfg.mrope_sections)

    if cache is not None:
        ck = _cache_store(cache["k"], k, cache_index)
        cv = _cache_store(cache["v"], v, cache_index)
        new_cache = {"k": ck, "v": cv}
        Sk, KV = ck.shape[1], ck.shape[2]
        valid = _cache_valid(cache_index, S, Sk, 3, x.device)
        qg = q.reshape(B, S, KV, H // KV, hd)
        logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                              ck.float()) / math.sqrt(hd)
        logits = logits.masked_fill(~valid, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", w, cv.float())
        out = out.reshape(B, S, H, hd).to(x.dtype)
    else:
        new_cache = None
        out = ops.flash_attention(q, k, v, causal=cfg.causal)
    wo = params["wo"]
    y = out.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1).to(x.dtype)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU, or the 2-matrix GELU of starcoder2)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             variant: str = "swiglu", n_stack: int = 0) -> Dict[str, Param]:
    p = {
        "wi": _dense_init(gen, (d, d_ff), ("embed", "ff"), n_stack=n_stack),
        "wo": _dense_init(gen, (d_ff, d), ("ff", "embed"), n_stack=n_stack),
    }
    if variant == "swiglu":
        p["wg"] = _dense_init(gen, (d, d_ff), ("embed", "ff"),
                              n_stack=n_stack)
    return p


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    if "wg" in params:  # SwiGLU
        h = F.silu(x @ params["wg"].to(x.dtype)) * (
            x @ params["wi"].to(x.dtype))
    else:               # 2-matrix GELU; jax.nn.gelu is the tanh form
        h = F.gelu(x @ params["wi"].to(x.dtype), approximate="tanh")
    return h @ params["wo"].to(x.dtype)
