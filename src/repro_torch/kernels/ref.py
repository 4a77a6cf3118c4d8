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


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Row mean-square in fp32, ``x * rsqrt(var + eps) * scale``, cast
    back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
