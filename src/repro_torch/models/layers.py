"""Shared layers of the port: norms, RoPE, GQA and MLA attention (prefill
and single-token decode paths), the SwiGLU/GELU MLP and the
grouped-capacity MoE — the twin of the JAX package's `models/layers.py`.

Param convention as in the reference: every parameter is built as
``Param(value, axes)`` with logical axis names, and `split_params` splits
a tree into (values, axes). Values are fp32 tensors; layers cast them to
the activation dtype at use, as the reference does.

Every RMSNorm (the residual norms and the qk-norm over head_dim) and
every GQA prefill attention goes through `kernels.ops`, which launches
the hand-written kernel for a tensor on the card. Decode attention over
the cache, MLA's prefill attention (`_chunked_attn`: its q/k and v head
dims differ), the MoE dispatch, expert products and combine, and the
projections stay plain PyTorch, as the reference left them to XLA.

With ``cfg.kv_quant`` the GQA decode cache holds int8 K and V with one
fp32 scale a (token, head) (`_quant_int8`); each read multiplies the
int8 values by the scale rounded to bf16, whatever the model's dtype, as
the reference's decode computes it.
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


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation over the last dim: returns (q, scale),
    scale = max |x| / 127 (at least 1e-8 / 127) in fp32, q = x / scale
    rounded half to even."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard / partial / M-RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rot_frac: float = 1.0,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B,S,H,hd). positions: (B,S), or (3,B,S) for M-RoPE, whose
    section i of the rotary frequencies turns by the t/h/w row i."""
    hd = x.shape[-1]
    rot_dim = int(hd * rot_frac)
    if rot_dim == 0:
        return x
    rot_dim -= rot_dim % 2
    inv = rope_freqs(rot_dim, theta, x.device)             # (rot_dim/2,)
    if mrope_sections:
        assert positions.dim() == 3, "M-RoPE needs (3,B,S) positions"
        assert sum(mrope_sections) == rot_dim // 2, (mrope_sections,
                                                     rot_dim)
        parts, off = [], 0
        for i, n in enumerate(mrope_sections):
            parts.append(positions[i][..., None].float() * inv[off:off + n])
            off += n
        angles = torch.cat(parts, dim=-1)                  # (B,S,rot_dim/2)
    else:
        angles = positions[..., None].float() * inv        # (B,S,rot_dim/2)
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


def _chunked_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset: int,
                  chunk: int = 1024) -> torch.Tensor:
    """q:(B,Sq,H,hd) k:(B,Sk,KV,hd) v:(B,Sk,KV,vd) -> (B,Sq,H,vd). GQA by
    head broadcast; fp32 logits and softmax, one query chunk at a time
    against the whole of k and v (the reference's `lax.scan` over
    chunks), so the scores take B·H·chunk·Sk floats at a time."""
    B, Sq, H, hd = q.shape
    KV, vd = k.shape[2], v.shape[-1]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scale = 1.0 / math.sqrt(hd)
    if Sq <= chunk:
        return _attn_block(qg, k, v, causal, q_offset, 0, scale).reshape(
            B, Sq, H, vd)
    if Sq % chunk:
        raise ValueError(f"Sq={Sq} must be a multiple of chunk={chunk}")
    out = [_attn_block(qg[:, i:i + chunk], k, v, causal, q_offset, i, scale)
           for i in range(0, Sq, chunk)]
    return torch.cat(out, dim=1).reshape(B, Sq, H, vd)


def _attn_block(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, q_offset: int, block_start: int,
                scale: float) -> torch.Tensor:
    """qg:(B,sq,KV,G,hd) against the full k,v:(B,Sk,KV,·); the causal
    mask is top-left: query i of the block sees keys up to
    q_offset + block_start + i."""
    sq, Sk = qg.shape[1], k.shape[1]
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    if causal:
        qpos = q_offset + block_start + torch.arange(sq, device=qg.device)
        kpos = torch.arange(Sk, device=qg.device)
        logits = logits.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.to(qg.dtype)


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
        if cfg.kv_quant:
            # int8 KV cache: one scale a (token, head)
            kq, ks = _quant_int8(k)
            vq, vs = _quant_int8(v)
            ck = _cache_store(cache["k"], kq, cache_index)
            cv = _cache_store(cache["v"], vq, cache_index)
            cks = _cache_store(cache["k_scale"], ks, cache_index)
            cvs = _cache_store(cache["v_scale"], vs, cache_index)
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs}
            # the reference's bf16 dequantisation as XLA runs it: the
            # scale rounded to bf16, the product of the (exact) int8 value
            # and that scale kept in fp32 (XLA's excess precision drops
            # the product's own rounding to bf16)
            ck = ck.float() * cks[..., None].to(torch.bfloat16).float()
            cv = cv.float() * cvs[..., None].to(torch.bfloat16).float()
        else:
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
# MLA attention (DeepSeek-V2): latent-compressed KV. Prefill materialises
# per-head K/V; decode uses the absorbed form against the compact
# (c_kv, k_rope) cache
# ---------------------------------------------------------------------------
def init_mla(gen: torch.Generator, cfg: ModelConfig,
             n_stack: int = 0) -> Dict[str, Param]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": _dense_init(gen, (d, H, qk_head), ("embed", "heads", None),
                          n_stack=n_stack),
        "wdkv": _dense_init(gen, (d, m.kv_lora_rank), ("embed", "qk_lora"),
                            n_stack=n_stack),
        "wkrope": _dense_init(gen, (d, m.qk_rope_head_dim), ("embed", None),
                              n_stack=n_stack),
        "wuk": _dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim),
                           ("qk_lora", "heads", None), n_stack=n_stack),
        "wuv": _dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim),
                           ("qk_lora", "heads", None), n_stack=n_stack),
        "wo": _dense_init(gen, (H, m.v_head_dim, d), ("heads", None, "embed"),
                          scale=1.0 / math.sqrt(H * m.v_head_dim),
                          n_stack=n_stack),
        "kv_norm": _ones((m.kv_lora_rank,), (None,), gen.device, n_stack),
    }


def mla_attention(params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_index: Optional[Index] = None):
    """As `attention`, for MLA. The latent ``c_kv`` goes through
    `rmsnorm` (``kv_norm``), so on the card through the RMSNorm kernel.
    Decode runs in fp32: q_lat = q_nope·W_uk, logits = q_lat·c_kvᵀ +
    q_rope·k_ropeᵀ, out = (softmax·c_kv)·W_uv."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(nope + rope_d)

    q = _project(x, params["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = rmsnorm({"scale": params["kv_norm"]},
                   x @ params["wdkv"].to(x.dtype), cfg.norm_eps)   # (B,S,r)
    k_rope = (x @ params["wkrope"].to(x.dtype))[:, :, None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        cc = _cache_store(cache["c_kv"], c_kv, cache_index)
        cr = _cache_store(cache["k_rope"], k_rope, cache_index)
        new_cache = {"c_kv": cc, "k_rope": cr}
        ccf = cc.float()
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                             params["wuk"].float())
        logits = (torch.einsum("bshr,btr->bhst", q_lat, ccf)
                  + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                 cr.float())) * scale
        valid = _cache_valid(cache_index, S, cc.shape[1], 2, x.device)
        w = torch.softmax(logits.masked_fill(~valid, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w, ccf)
        out = torch.einsum("bshr,rhv->bshv", o_lat,
                           params["wuv"].float()).to(x.dtype)
    else:
        new_cache = None
        k_nope = _project(c_kv, params["wuk"])
        v = _project(c_kv, params["wuv"])
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_d)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = _chunked_attn(q_full, k_full, v, cfg.causal, 0)
    y = out.reshape(B, S, H * vd) @ params["wo"].reshape(H * vd, -1).to(
        x.dtype)
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


# ---------------------------------------------------------------------------
# MoE: grouped-capacity sort dispatch (static shapes, a local sort in each
# group of tokens)
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig,
             n_stack: int = 0) -> Dict[str, Param]:
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.n_experts, mo.expert_d_ff
    p = {
        "router": _dense_init(gen, (d, E), ("embed", "experts"), scale=0.02,
                              n_stack=n_stack),
        "wi": _dense_init(gen, (E, d, f), ("experts", "embed", "ff"),
                          n_stack=n_stack),
        "wg": _dense_init(gen, (E, d, f), ("experts", "embed", "ff"),
                          n_stack=n_stack),
        "wo": _dense_init(gen, (E, f, d), ("experts", "ff", "embed"),
                          n_stack=n_stack),
    }
    if mo.n_shared_experts:
        p["shared"] = init_mlp(gen, d, mo.n_shared_experts * f,
                               n_stack=n_stack)
    return p


def moe_capacity(cfg: ModelConfig, g: int) -> int:
    """Slots an expert takes in a group of ``g`` tokens: g·k/E times the
    capacity factor, rounded up to 8, at most g and at least 8."""
    mo = cfg.moe
    cap = int(math.ceil(g * mo.top_k / mo.n_experts * mo.capacity_factor))
    return max(8, min(cap + (-cap) % 8, g))


def _group_dispatch(xg: torch.Tensor, eid: torch.Tensor, w: torch.Tensor,
                    n_experts: int, cap: int):
    """xg:(g,d) eid,w:(g,k). Returns (buf (E·cap, d), meta): the (token,
    slot) pairs sorted stably by expert, each expert's first ``cap`` pairs
    written to its rows and the rest to a dropped row at E·cap. meta is
    (dest, order, w_sorted, keep) over the sorted pairs; pair i is flat
    pair order[i], of token order[i] // k."""
    g, k = eid.shape
    flat_e = eid.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # each expert's first sorted pair (the reference's cumsum of counts
    # less the counts); `bincount` would wait for the card to size its
    # output
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=xg.device))
    pos = torch.arange(g * k, device=xg.device) - starts[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, n_experts * cap)
    buf = xg.new_zeros((n_experts * cap + 1, xg.shape[-1]))
    buf[dest] = xg[order // k]          # the drop row may be written often
    return buf[:-1], (dest, order, w.reshape(-1)[order], keep)


def _group_combine(out_buf: torch.Tensor, meta, g: int, k: int,
                   d: int) -> torch.Tensor:
    """(g, d): each token's kept pairs' expert outputs times their
    weights, summed over its k slots. The reference scatter-adds the
    pairs into their tokens; here the sorted pairs go back to (token,
    slot) order through the inverse of the sort and are summed over k in
    one fixed order, so two calls on the card give the same bits."""
    dest, order, w_sorted, keep = meta
    padded = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    pair_out = padded[torch.where(keep, dest, out_buf.shape[0])] \
        * w_sorted[:, None].to(out_buf.dtype)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(g * k, device=order.device)
    return pair_out[inverse].view(g, k, d).sum(dim=1)


def moe_route(params, cfg: ModelConfig, xf: torch.Tensor):
    """xf:(G,g,d) -> (probs (G,g,E) fp32, top_w, top_e (G,g,k)): router
    logits in the activation dtype, softmax in fp32, the top-k weights
    renormalised. bf16 logits tie often; a stable descending sort breaks
    ties toward the lower expert, as `lax.top_k` does (`torch.topk`
    promises no order)."""
    logits = xf @ params["router"].to(xf.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_e


def moe(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (B,S,d) -> (y, aux loss). Tokens are routed in groups of
    ``group_size`` (the whole batch when it is smaller), one group at a
    time; the Switch aux loss is E · Σ_e mean prob_e · routed share_e."""
    mo = cfg.moe
    B, S, d = x.shape
    E, k = mo.n_experts, mo.top_k
    T = B * S
    g = min(mo.group_size, T)
    if T % g:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    cap = moe_capacity(cfg, g)
    xf = x.reshape(T // g, g, d)
    probs, top_w, top_e = moe_route(params, cfg, xf)

    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_e, E).float().sum(dim=2).mean(dim=(0, 1)) / k
    aux = E * torch.sum(me * ce) * mo.aux_loss_coef

    wg, wi, wo = (params[n].to(x.dtype) for n in ("wg", "wi", "wo"))
    ys = []
    for xg, eg, weights in zip(xf, top_e, top_w):
        buf, meta = _group_dispatch(xg, eg, weights, E, cap)
        buf = buf.view(E, cap, d)
        h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
        out_buf = torch.bmm(h, wo).view(E * cap, d)
        ys.append(_group_combine(out_buf, meta, g, k, d))
    y = torch.stack(ys).view(B, S, d)
    if mo.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y, aux
