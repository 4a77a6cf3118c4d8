"""Launcher of the hand-written flash-attention forward kernel
(``csrc/flash_attention_fwd.cu``), the twin of the JAX package's Pallas
`kernels/flash_attention.py:flash_attention_fwd`.

It takes the reference's layout, q ``(B,Sq,H,hd)`` and k, v
``(B,Sk,KV,hd)``, with any batch/sequence/head strides (the head_dim must
be contiguous), and returns ``out`` ``(B,Sq,H,hd)`` in the input dtype
plus the fp32 logsumexp ``(B,H,Sq)``. Unlike the Pallas kernel it takes
ragged lengths (no ``S % block == 0``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    """Shape rules shared by the kernel and its plain version."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,Sq,H,hd) and k, v "
                         f"(B,Sk,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if causal and Sq != k.shape[1]:
        # the kernel masks top-left (kpos <= qpos) like the Pallas kernel,
        # the plain version bottom-right like ref.py: they agree only here
        raise ValueError(f"causal flash_attention needs Sq == Sk, got "
                         f"Sq={Sq}, Sk={k.shape[1]}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the card. Returns (out, lse)."""
    check_shapes(q, k, v, causal)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd launches a CUDA kernel: q, k "
                         "and v must lie on one CUDA device")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_fwd takes fp32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_fwd needs a contiguous head_dim")
    if q.dtype == torch.bfloat16 and (
            any(t.stride(i) % 8 for t in (q, k, v) for i in range(3))
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        # the bf16 kernel moves rows as 16-byte vectors
        raise ValueError("bf16 flash_attention_fwd needs strides that are "
                         "multiples of 8 and 16-byte aligned q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Sk, H, KV, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(bool(causal)), stream)
    _build.check(err, "flash_attention_fwd")
    return out, lse
