"""Launchers of the hand-written RMSNorm kernels (``csrc/rmsnorm.cu``):
the forward, the twin of the JAX package's Pallas
`kernels/rmsnorm.py:rmsnorm_fwd`, and the backward, which the reference
takes as `jax.vjp` of its oracle (`kernels/ops.py:_rn_bwd`).

x ``(..., d)`` in fp32 or bf16, contiguous; scale ``(d,)`` fp32. The
output has x's shape and dtype; the backward's dx too, and its dscale is
fp32. d is a multiple of a 16-byte vector (8 bf16 or 4 fp32 values) and
at most 2048 such vectors (starcoder2-15b's 6144 in fp32 is 1536).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECTORS = 2048  # the widest row the kernels take, in 16-byte vectors


def _check(x: torch.Tensor, scale: torch.Tensor, what: str) -> int:
    """Refuse what the kernels do not take; returns d."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"{what} launches a CUDA kernel: x and scale must "
                         "lie on one CUDA device")
    if x.dtype not in _DTYPE_CODE or scale.dtype != torch.float32:
        raise TypeError(f"{what} takes fp32/bf16 x and fp32 scale, got "
                        f"{x.dtype}, {scale.dtype}")
    d = x.shape[-1]
    width = 16 // x.element_size()  # elements per 16-byte vector
    if scale.shape != (d,) or not scale.is_contiguous() \
            or scale.data_ptr() % 16:
        raise ValueError(f"scale {tuple(scale.shape)} is not a contiguous, "
                         f"16-byte aligned ({d},) vector")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{what} needs a non-empty contiguous x")
    if d % width or d > MAX_VECTORS * width or x.data_ptr() % 16:
        raise ValueError(f"{what} needs d % {width} == 0, d <= "
                         f"{MAX_VECTORS * width} and a 16-byte aligned x, "
                         f"got d={d}")
    return d


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Launch the forward kernel on the card."""
    d = _check(x, scale, "rmsnorm_fwd")
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_rmsnorm_fwd(x.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), x.numel() // d, d,
                                    float(eps), _DTYPE_CODE[x.dtype], stream)
    _build.check(err, "rmsnorm_fwd")
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5, need_dscale: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the backward kernel on the card: (dx in x's dtype, dscale
    in fp32, or None when it is not asked for). dscale is summed in a
    fixed order, so two calls give the same bits."""
    d = _check(x, scale, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"dy must be a contiguous, 16-byte aligned "
                         f"{tuple(x.shape)} {x.dtype} tensor beside x")
    rows, code = x.numel() // d, _DTYPE_CODE[x.dtype]
    lib = _build.library()
    with torch.cuda.device(x.device):
        ws_bytes = lib.repro_rmsnorm_bwd_workspace_bytes(rows, d, code)
        if ws_bytes < 0:
            raise ValueError(f"rmsnorm_bwd refuses rows={rows}, d={d}")
        dx = torch.empty_like(x)
        dscale = (torch.empty(d, dtype=torch.float32, device=x.device)
                  if need_dscale else None)
        ws = (torch.empty(ws_bytes // 4, dtype=torch.float32,
                          device=x.device)
              if need_dscale and ws_bytes else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_rmsnorm_bwd(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            None if dscale is None else dscale.data_ptr(),
            None if ws is None else ws.data_ptr(), rows, d, float(eps),
            code, stream)
    _build.check(err, "rmsnorm_bwd")
    return dx, dscale
