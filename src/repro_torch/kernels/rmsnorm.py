"""Launcher of the hand-written RMSNorm kernel (``csrc/rmsnorm.cu``), the
twin of the JAX package's Pallas `kernels/rmsnorm.py:rmsnorm_fwd`.

x ``(..., d)`` in fp32 or bf16, contiguous; scale ``(d,)`` fp32. The
output has x's shape and dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on the card."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError("rmsnorm_fwd launches a CUDA kernel: x and scale "
                         "must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODE or scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm_fwd takes fp32/bf16 x and fp32 scale, got "
                        f"{x.dtype}, {scale.dtype}")
    d = x.shape[-1]
    width = 16 // x.element_size()  # elements per 16-byte vector
    if scale.shape != (d,) or not scale.is_contiguous():
        raise ValueError(f"scale {tuple(scale.shape)} is not a contiguous "
                         f"({d},) vector")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("rmsnorm_fwd needs a non-empty contiguous x")
    if d % width or x.data_ptr() % 16:
        raise ValueError(f"rmsnorm_fwd needs d % {width} == 0 and a 16-byte "
                         f"aligned x, got d={d}")
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_rmsnorm_fwd(x.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), x.numel() // d, d,
                                    float(eps), _DTYPE_CODE[x.dtype], stream)
    _build.check(err, "rmsnorm_fwd")
    return out
