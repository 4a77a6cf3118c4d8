"""Plain PyTorch versions of the ported kernels: the twins of the JAX
package's `kernels/ref.py` oracles.

`kernels.ops` takes them for tensors that lie on the CPU; the tests and
`chip_smoke.py` hold the CUDA kernels against them. They are never a
fallback for a tensor on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q:(B,Sq,H,hd) k,v:(B,Sk,KV,hd) -> out (B,Sq,H,hd) in q's dtype and
    the fp32 logsumexp of the scaled scores, (B,H,Sq). Softmax in fp32.

    The causal mask is aligned bottom-right (``tril(.., Sk - Sq)``), as in
    the reference oracle; it equals the kernels' top-left mask at
    ``Sq == Sk``, the only causal shape the kernels take.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)                 # (B,KV,G,Sq)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return (out.reshape(B, Sq, H, hd).to(q.dtype),
            lse.reshape(B, H, Sq))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients of `flash_attention_ref`'s ``out`` given ``do``, as
    the reference's `_bwd_dq_kernel`/`_bwd_dkv_kernel` compute them, in
    fp32: ``p = exp(s - lse)`` (masked scores at -1e30),
    ``delta = rowsum(do * out)``, ``ds = p (dp - delta) scale``, and
    dk/dv summed over each GQA group. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    dog = do.reshape(B, Sq, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    delta = (do.float() * out.float()).sum(-1)            # (B,Sq,H)
    delta = delta.reshape(B, Sq, KV, G).permute(0, 2, 3, 1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf).reshape(B, Sq, H, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Row mean-square in fp32, ``x * rsqrt(var + eps) * scale``, cast
    back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of `rmsnorm_ref` given ``dy``, from the formula, in
    fp32: with ``r = rsqrt(mean(x^2) + eps)``, ``xh = x r`` and
    ``g = dy scale``, ``dx = r (g - xh mean(g xh))`` cast once to x's
    dtype, and ``dscale`` the sum of ``dy xh`` over every row, in fp32."""
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xh = x32 * r
    g = dy32 * scale.float()
    dx = r * (g - xh * torch.mean(g * xh, dim=-1, keepdim=True))
    dscale = (dy32 * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """The Mamba2 SSD chunked scan in fp32, cast back to x's dtype: the
    oracle of the SSD kernel, delegating to `models.ssm.ssd` as the
    reference's `ssd_scan_ref` does. x:(b,s,h,p) dt:(b,s,h) A:(h,)
    B,C:(b,s,g,n) -> y:(b,s,h,p)."""
    from repro_torch.models.ssm import ssd  # models import kernels.ops
    return ssd(x.float(), dt.float(), A.float(), B.float(), C.float(),
               chunk=chunk).to(x.dtype)


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                     chunk: int) -> Tuple[torch.Tensor, ...]:
    """The gradients of `ssd_scan_ref`'s y given ``dy``, from the closed
    form, in fp32: the oracle of the SSD backward kernel. Per chunk, with
    ``cum`` the cumsum of dt A, ``Lg`` its last value, the states S_c
    entering each chunk (the forward's recurrence) and D_c, the gradient
    of the state leaving it (``D_last = 0``, ``D_{c-1} = e^Lg_c D_c +
    sum_l e^cum_l C_l dy_lᵀ``)::

        dx_m  = sum_{l>=m} (C_l.B_m) e^(cum_l-cum_m) dt_m dy_l
                + e^(Lg-cum_m) dt_m Dᵀ B_m
        dC_l  = sum_{m<=l} e^(cum_l-cum_m) dt_m (dy_l.x_m) B_m
                + e^cum_l S_c dy_l
        dB_m  = sum_{l>=m} e^(cum_l-cum_m) dt_m (dy_l.x_m) C_l
                + e^(Lg-cum_m) dt_m D x_m

    (dB, dC summed over each group's heads); ``dcum`` from the terms in
    ``cum``, its reverse cumsum ``da``, ``ddt += A da`` and ``dA = sum dt
    da``. Returns (dx, ddt, dA, dB, dC) in the inputs' dtypes."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L = min(int(chunk), s)
    nc, r = s // L, h // g
    xc = x.float().reshape(b, nc, L, g, r, p)
    dyc = dy.float().reshape(b, nc, L, g, r, p)
    dtc = dt.float().reshape(b, nc, L, g, r).permute(0, 1, 3, 4, 2)
    Bc = B.float().reshape(b, nc, L, g, n)
    Cc = C.float().reshape(b, nc, L, g, n)
    cum = torch.cumsum(dtc * A.float().reshape(g, r, 1), dim=-1)  # (b,nc,g,r,L)
    last = cum[..., -1]                                            # (b,nc,g,r)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~causal, float("-inf")))        # (..,l,m)
    cb = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)[:, :, :, None]
    dyx = torch.einsum("bclgrp,bcmgrp->bcgrlm", dyc, xc)
    dt_m = dtc[..., None, :]
    q = cb * decay * dyx                    # ddt's intra-chunk terms
    m_lm = q * dt_m                         # M_lm, the terms in cum
    scores = cb * decay * dt_m
    hd = decay * dt_m * dyx
    ew = torch.exp(last[..., None] - cum)   # e^(Lg - cum_m)
    w = ew * dtc
    ec = torch.exp(cum)

    local = torch.einsum("bcmgn,bcgrm,bcmgrp->bcgrnp", Bc, w, xc)
    dy_state = torch.einsum("bclgn,bcgrl,bclgrp->bcgrnp", Cc, ec, dyc)
    gammas = torch.exp(last)[..., None, None]
    state = torch.zeros_like(local[:, 0])
    grad = torch.zeros_like(local[:, 0])
    S, D = [], [None] * nc
    for c in range(nc):
        S.append(state)
        state = gammas[:, c] * state + local[:, c]
    for c in reversed(range(nc)):
        D[c] = grad
        grad = gammas[:, c] * grad + dy_state[:, c]
    S, D = torch.stack(S, dim=1), torch.stack(D, dim=1)    # (b,nc,g,r,n,p)

    bd = torch.einsum("bcmgn,bcgrnp->bcgrmp", Bc, D)       # (Dᵀ B_m)
    dx = (torch.einsum("bcgrlm,bclgrp->bcmgrp", scores, dyc)
          + (bd * w[..., None]).permute(0, 1, 4, 2, 3, 5))
    dB = (torch.einsum("bcgrlm,bclgn->bcmgn", hd, Cc)
          + torch.einsum("bcgrm,bcgrnp,bcmgrp->bcmgn", w, D, xc))
    dC = (torch.einsum("bcgrlm,bcmgn->bclgn", hd, Bc)
          + torch.einsum("bcgrl,bcgrnp,bclgrp->bclgn", ec, S, dyc))
    v = torch.einsum("bcgrmp,bcmgrp->bcgrm", bd, xc)       # B_mᵀ D x_m
    ddt = q.sum(-2) + ew * v
    u = w * v
    y_off = torch.einsum("bclgn,bcgrnp->bcgrlp", Cc, S) * ec[..., None]
    dcum = (m_lm.sum(-1) - m_lm.sum(-2) - u
            + torch.einsum("bcgrlp,bclgrp->bcgrl", y_off, dyc))
    dcum[..., -1] += u.sum(-1) + torch.exp(last) * (D * S).sum((-2, -1))
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = ddt + A.float().reshape(g, r, 1) * da
    dA = (dtc * da).sum((0, 1, 4)).reshape(h)
    return (dx.reshape(b, s, h, p).to(x.dtype),
            ddt.permute(0, 1, 4, 2, 3).reshape(b, s, h).to(dt.dtype),
            dA.to(A.dtype), dB.reshape(b, s, g, n).to(B.dtype),
            dC.reshape(b, s, g, n).to(C.dtype))


def event_select_ref(ev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row masked min and argmin of an (n, m) candidate-event matrix
    (inf = masked), ties broken to the lowest column: ``(t (n,), i (n,)
    int32)``. All-inf rows give (inf, 0). A row holding a NaN gives
    (NaN, 0), as the Pallas kernel does; ``t`` is then the row's first
    NaN, so the CUDA kernel matches this bit for bit."""
    isnan = torch.isnan(ev)
    nan_row = isnan.any(dim=1)
    arg = torch.argmin(ev, dim=1)             # first index of the minimum
    first_nan = torch.argmax(isnan.to(torch.uint8), dim=1)
    pick = torch.where(nan_row, first_nan, arg)
    t = torch.gather(ev, 1, pick[:, None])[:, 0]
    i = torch.where(nan_row, torch.zeros_like(arg), arg)
    return t, i.to(torch.int32)
