"""Device dispatch for the ported kernels — the twin of the JAX package's
`kernels/ops.py` (forward parts).

The rule: a tensor on the CPU takes the plain PyTorch version
(`kernels.ref`); a tensor on the card launches the hand-written kernel or
raises. There is no fallback from the card to the plain version and no
flag that turns a kernel off.

Each wrapper keeps a plain-int ``launches`` count, incremented only where
it launched its kernel, so a run can show that its path went through the
kernels (``chip_smoke.py`` zeroes the counts before the main path and
reads them after).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q:(B,Sq,H,hd) k,v:(B,Sk,KV,hd) -> (B,Sq,H,hd), softmax scale
    1/sqrt(hd). Causal needs Sq == Sk on either device."""
    fa.check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)[0]
    out, _ = fa.flash_attention_fwd(q, k, v, causal=causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x:(..., d), scale:(d,) -> x's shape and dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    out = rn.rmsnorm_fwd(x, scale, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def reset_launches() -> None:
    flash_attention.launches = 0
    rmsnorm.launches = 0
