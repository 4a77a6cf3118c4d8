"""Mamba2 / SSD mixer (arXiv:2405.21060), chunked state-space-duality form —
the twin of the JAX package's `models/ssm.py`.

`ssd` is the plain chunked scan: within a chunk a masked ``(C Bᵀ) x``
product, across chunks a recurrence over the per-chunk states (a Python
loop over the chunks in place of `lax.associative_scan`). It is the
oracle of the SSD kernel (`kernels.ref.ssd_scan_ref` delegates to it).

`mamba2_block` follows the reference's default path (``use_kernel=False``):
``dt`` stays fp32 and B, C enter the scan as fp32. The scan goes through
`kernels.ops.ssd_scan`, so a tensor on the card launches the
hand-written SSD kernel (which upcasts B and C on load, exactly) and a
CPU tensor takes `ssd`. The gated norm at width d_inner goes through the
RMSNorm kernel like every other norm. Decode (one token against a state)
is the plain recurrence `ssd_decode_step`, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Param, _dense_init, _ones, _zeros, rmsnorm


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int, initial_state: Optional[torch.Tensor] = None,
        return_state: bool = False):
    """SSD scan.

    x: (b, s, h, p)   dt: (b, s, h)   A: (h,) (negative)
    B, C: (b, s, g, n) with h % g == 0.
    Returns y: (b, s, h, p) [, final_state (b, h, n, p)].
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd needs s % chunk == 0, got s={s}, chunk={chunk}")
    nc = s // chunk
    rep = h // g
    # heads split as (group, head within group), so C Bᵀ is formed once per
    # group, and the L x L terms keep (l, m) last, contiguous: the same
    # arithmetic as the reference's per-head einsums, in fewer passes
    xc = x.reshape(b, nc, chunk, g, rep, p)
    dtc = dt.reshape(b, nc, chunk, g, rep).permute(0, 1, 3, 4, 2)  # (b,nc,g,r,L)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)

    cum = torch.cumsum(dtc * A.reshape(g, rep, 1), dim=-1)         # (b,nc,g,r,L)
    # --- intra-chunk (diagonal blocks) ---
    seg = cum[..., :, None] - cum[..., None, :]                     # (..,L,L)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    # mask BEFORE exp: masked entries have seg > 0 (can overflow and would
    # leak NaNs through the masked gradient)
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)                 # (b,nc,g,L,L)
    scores = cb[:, :, :, None] * decay * dtc[..., None, :]          # (b,nc,g,r,L,L)
    y_diag = torch.einsum("bcgrlm,bcmgrp->bclgrp", scores,
                          xc.to(scores.dtype))

    # --- per-chunk states ---
    chunk_sum = cum[..., -1]                                        # (b,nc,g,r)
    w = torch.exp(chunk_sum[..., None] - cum) * dtc                 # (b,nc,g,r,L)
    xw = xc.to(w.dtype) * w.permute(0, 1, 4, 2, 3)[..., None]
    states = torch.einsum("bclgn,bclgrp->bcgrnp", Bc.to(w.dtype), xw)

    # --- inter-chunk recurrence: S_c+1 = exp(sum_da_c) S_c + states_c ---
    if initial_state is None:
        initial_state = torch.zeros((b, h, n, p), dtype=x.dtype,
                                    device=x.device)
    gammas = torch.exp(chunk_sum)                                   # (b,nc,g,r)
    state = initial_state.float().reshape(b, g, rep, n, p)
    prev = []                       # the state BEFORE each chunk
    for c in range(nc):
        prev.append(state)
        state = state * gammas[:, c, :, :, None, None] + states[:, c].float()
    prev = torch.stack(prev, dim=1)                                 # (b,nc,g,r,n,p)
    final_state = state.reshape(b, h, n, p).to(x.dtype)

    # --- off-diagonal contribution ---
    y_off = torch.einsum("bclgn,bcgrnp->bclgrp", Cc.float(), prev) \
        * torch.exp(cum).permute(0, 1, 4, 2, 3)[..., None]
    y = (y_diag.float() + y_off).reshape(b, s, h, p).to(x.dtype)
    if return_state:
        return y, final_state
    return y


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """Single-token recurrence. state:(b,h,n,p) x:(b,h,p) dt:(b,h)
    B,C:(b,g,n). The update runs in the promoted type (fp32 for a bf16
    state and fp32 dt); the new state keeps the state's dtype and y takes
    x's."""
    b, h, p = x.shape
    g = B.shape[1]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=1)             # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1)
    da = torch.exp(dt * A[None, :])                  # (b,h)
    new_state = state * da[..., None, None] + \
        (dt[..., None] * Bh)[..., :, None] * x[..., None, :]  # (b,h,n,p)
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(new_state.dtype), new_state)
    return new_state.to(state.dtype), y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def init_mamba2(gen: torch.Generator, cfg: ModelConfig,
                n_stack: int = 0) -> Dict[str, Param]:
    """The reference's tree; with ``n_stack`` every leaf gets a leading
    ``layers`` axis of that size."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    dev = gen.device
    lo, hi = s.a_init_range
    a_init = torch.log(torch.linspace(lo, hi, nheads, dtype=torch.float32,
                                      device=dev))
    if n_stack:
        a_init = a_init.expand(n_stack, nheads).clone()
    return {
        # order: [z (d_inner), x (d_inner), B (g*n), C (g*n), dt (nheads)]
        "in_proj": _dense_init(gen, (d, 2 * d_inner + 2 * s.n_groups
                                     * s.d_state + nheads),
                               ("embed", "ssm_inner"), n_stack=n_stack),
        "conv_w": _dense_init(gen, (s.d_conv, conv_dim), (None, "conv_dim"),
                              scale=1.0 / math.sqrt(s.d_conv),
                              n_stack=n_stack),
        "conv_b": _zeros((conv_dim,), ("conv_dim",), dev, n_stack),
        "A_log": Param(a_init, (("layers",) if n_stack else ())
                       + ("ssm_heads",)),
        "D": _ones((nheads,), ("ssm_heads",), dev, n_stack),
        "dt_bias": _zeros((nheads,), ("ssm_heads",), dev, n_stack),
        "norm": _ones((d_inner,), ("ssm_inner",), dev, n_stack),
        "out_proj": _dense_init(gen, (d_inner, d), ("ssm_inner", "embed"),
                                n_stack=n_stack),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x:(B,S,C) depthwise causal conv, kernel w:(K,C). state:(B,K-1,C).

    A sum of K shifted products in x's dtype, in the order i = 0..K-1, as
    the reference computes it (`F.conv1d` sums in another order, and
    through cuDNN possibly in TF32)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i][None, None, :]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out + b[None, None, :], new_state


def mamba2_block(params, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """x: (B,S,d). state: (conv_state (B,K-1,conv_dim), ssm_state
    (B,h,n,p)).

    Returns (y, new_state or None)."""
    s = cfg.ssm
    B_, S, d = x.shape
    d_inner = s.expand * d
    nheads = d_inner // s.head_dim
    gn = s.n_groups * s.d_state

    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * gn]
    dt_raw = zxbcdt[..., -nheads:]

    conv_state = state[0] if state is not None else None
    xbc, new_conv_state = _causal_conv(xbc, params["conv_w"].to(x.dtype),
                                       params["conv_b"].to(x.dtype),
                                       conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner]
    Bmat = xbc[..., d_inner:d_inner + gn].reshape(B_, S, s.n_groups,
                                                  s.d_state)
    Cmat = xbc[..., d_inner + gn:].reshape(B_, S, s.n_groups, s.d_state)

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(B_, S, nheads, s.head_dim)

    if state is not None and S == 1:
        new_ssm, yh = ssd_decode_step(state[1], xh[:, 0], dt[:, 0], A,
                                      Bmat[:, 0], Cmat[:, 0])
        y = yh[:, None]
        new_state = (new_conv_state, new_ssm)
    else:
        # B and C are fp32 in the scan; the kernel upcasts them on load
        y = ops.ssd_scan(xh, dt, A, Bmat, Cmat, chunk=min(s.chunk_size, S))
        new_state = None

    y = y + xh * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B_, S, d_inner)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm"]}, y, cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    return out, new_state


def mamba2_state_shape(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return ((batch, s.d_conv - 1, conv_dim),
            (batch, nheads, s.d_state, s.head_dim))
