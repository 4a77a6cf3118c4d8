"""Launchers of the hand-written flash-attention kernels, the twins of the
JAX package's Pallas `kernels/flash_attention.py`: `flash_attention_fwd`
(``csrc/flash_attention_fwd.cu``) and `flash_attention_bwd`
(``csrc/flash_attention_bwd.cu``).

They take the reference's layout, q ``(B,Sq,H,hd)`` and k, v
``(B,Sk,KV,hd)``, with any batch/sequence/head strides (the head_dim must
be contiguous). The forward returns ``out`` ``(B,Sq,H,hd)`` in the input
dtype plus the fp32 logsumexp ``(B,H,Sq)``; the backward takes those and
``dO`` and returns ``(dq, dk, dv)``, dk and dv summed over each GQA group.
Unlike the Pallas kernels they take ragged lengths (no
``S % block == 0``).

The bf16 kernels load q, k, v and dO through TMA tensor maps (Hopper's
Tensor Memory Accelerator), which describe each tensor as it lies, strides
and all. TMA takes only base addresses aligned to 16 bytes and strides
that are multiples of 16 bytes, so bf16 tensors need 16-byte-aligned
pointers and batch, sequence and head strides that are multiples of 8
elements; a view such as q, k, v cut from one fused projection meets both
and is read without a copy. The fp32 kernels load with plain loads and take
any strides with a contiguous head_dim.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

#: head dims the forward and backward kernels are built for (80 is
#: hubert-xlarge's)
HEAD_DIMS = (32, 64, 80, 128)
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


def _check_launch(what: str, q: torch.Tensor, *others: torch.Tensor):
    """Device, dtype and layout rules of both kernels; raises on what they
    do not take (there is no fallback). Returns the batch, sequence and
    head strides of each tensor, in order, as the C entry points take
    them."""
    ts = (q, *others)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in others):
        raise ValueError(f"{what} launches a CUDA kernel: its tensors must "
                         "lie on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{what} takes fp32 or bf16 tensors of one dtype, "
                        f"got {[str(t.dtype) for t in ts]}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{what} takes head_dim in {HEAD_DIMS}, not "
                         f"{q.shape[3]}")
    strides = [t.stride() for t in ts]
    if any(st[3] != 1 for st in strides):
        raise ValueError(f"{what} needs a contiguous head_dim")
    flat = [x for st in strides for x in st[:3]]
    if q.dtype == torch.bfloat16 and (
            any(x % 8 for x in flat) or any(t.data_ptr() % 16 for t in ts)):
        # TMA's rules: 16-byte-aligned bases, strides of 16 bytes
        raise ValueError(f"bf16 {what} needs strides that are multiples of "
                         "8 and 16-byte aligned tensors")
    return flat


def _launch(entry, device: torch.device, *args) -> int:
    """Call a C entry point on ``device``'s current stream (the stream is
    its last argument)."""
    if device.index == torch.cuda.current_device():
        return entry(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the card. Returns (out, lse)."""
    check_shapes(q, k, v, causal)
    strides = _check_launch("flash_attention_fwd", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _launch(
        _build.library().repro_flash_attention_fwd, q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Sq, Sk, H, KV, hd, *strides, float(scale),
        int(bool(causal)))
    _build.check(err, "flash_attention_fwd")
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (delta, dq, then dk/dv) on the card, at
    any head dim of `HEAD_DIMS`.

    ``out`` and ``lse`` are the forward's; ``do`` is the gradient of
    ``out``, any strides with a contiguous head_dim. ``delta =
    rowsum(do * out)`` (fp32, (B,H,Sq)) is allocated here and filled by a
    kernel of the same library before the gradient kernels run. Returns
    (dq, dk, dv) in the input dtype."""
    check_shapes(q, k, v, causal)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    strides = _check_launch("flash_attention_bwd", q, k, v,
                            do, out)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous fp32 ({B}, {H}, {Sq}) "
                         "tensor on q's device")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, KV, hd), dtype=v.dtype, device=q.device)
    err = _launch(
        _build.library().repro_flash_attention_bwd, q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Sk, H, KV, hd, *strides,
        float(scale), int(bool(causal)))
    _build.check(err, "flash_attention_bwd")
    return dq, dk, dv
