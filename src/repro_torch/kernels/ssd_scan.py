"""Launcher of the hand-written SSD chunked-scan kernel
(``csrc/ssd_scan.cu``), the twin of the JAX package's Pallas
`kernels/ssd_scan.py:ssd_scan_fwd`.

x ``(b,s,h,p)`` and B, C ``(b,s,g,n)`` in one dtype, fp32 or bf16, with
any batch/sequence/head strides that are multiples of 16 bytes, a
contiguous last dimension and 16-byte aligned data (the Mamba2 block
hands over views into its conv output); dt ``(b,s,h)`` and A ``(h,)`` in
fp32. The output y ``(b,s,h,p)`` is contiguous, in x's
dtype. The kernels pick their own chunk length whatever ``chunk`` is (the
scan does not depend on it); ``chunk`` is checked as the reference checks
it. bf16 runs three chunk-parallel stages on `wgmma` with TMA loads, which
pass the chunk states through a device workspace this launcher allocates
(``repro_ssd_scan_workspace_bytes`` sizes it); fp32 runs one kernel of
fp32 FMAs.

On the meta device (the dry run) the launcher checks what the kernel
takes and allocates y, and launches nothing (nor sizes the workspace);
`cost` gives a call's products and bytes.
"""
from __future__ import annotations

import torch

from typing import Tuple

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int) -> int:
    """Shape rules shared by the kernel and its plain version. Returns
    the chunk the scan uses, ``min(chunk, s)``, which must divide s."""
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_scan takes x (b,s,h,p) and B, C (b,s,g,n); "
                         f"got {tuple(x.shape)}, {tuple(B.shape)}")
    b, s, h, _ = x.shape
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (b, s) or C.shape != B.shape):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if h % B.shape[2]:
        raise ValueError(f"{h} heads do not group over {B.shape[2]} B/C "
                         "groups")
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan needs s % chunk == 0, got s={s}, "
                         f"chunk={chunk}")
    return chunk


def cost(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
         itemsize: int = 2) -> Tuple[float, float]:
    """(products, bytes) of one call: per chunk of L tokens the causal
    halves of C.B^T (once per group) and of scores.x (per head), plus C.S
    and the state update (per head); x and y in x's dtype, dt and A in
    fp32, B and C in x's dtype, each once."""
    L = min(chunk, s)
    pairs = L * (L + 1)            # 2 x the causal (l, m) pairs
    flops = b * (s // L) * (g * n * pairs + h * (p * pairs + 4 * L * n * p))
    nbytes = (2 * itemsize * b * s * h * p + 4 * (b * s * h + h)
              + 2 * itemsize * b * s * g * n)
    return float(flops), float(nbytes)


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Launch the kernel on the card. Returns y (b,s,h,p) in x's dtype."""
    check_shapes(x, dt, A, B, C, chunk)
    ins = (x, dt, A, B, C)
    if x.device.type not in ("cuda", "meta") or any(t.device != x.device
                                                     for t in ins):
        raise ValueError("ssd_scan_fwd launches a CUDA kernel: its tensors "
                         "must lie on one CUDA device")
    if (x.dtype not in _DTYPE_CODE or B.dtype != x.dtype
            or C.dtype != x.dtype or dt.dtype != torch.float32
            or A.dtype != torch.float32):
        raise TypeError(f"ssd_scan_fwd takes x, B, C in one of fp32/bf16 and "
                        f"fp32 dt and A, got {[str(t.dtype) for t in ins]}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan_fwd takes head_dim p in {HEAD_DIMS} and "
                         f"d_state n in {STATE_DIMS}, got p={p}, n={n}")
    if any(t.stride(3) != 1 for t in (x, B, C)) or not A.is_contiguous():
        raise ValueError("ssd_scan_fwd needs x, B, C with a contiguous last "
                         "dimension and a contiguous A")
    # strides of size-1 dims are never stepped; pass them as 0
    strides = [t.stride(i) if t.shape[i] > 1 else 0
               for t in (x, dt, B, C) for i in range(3)]
    vec = 16 // x.element_size()
    if (any(st % vec for i, st in enumerate(strides) if not 3 <= i < 6)
            or any(t.data_ptr() % 16 for t in (x, B, C))):
        raise ValueError(f"ssd_scan_fwd moves x, B, C as 16-byte vectors: "
                         f"their strides must be multiples of {vec} and "
                         "their data 16-byte aligned")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if x.is_meta:
        return y
    lib = _build.library()
    code = _DTYPE_CODE[x.dtype]
    work_bytes = lib.repro_ssd_scan_workspace_bytes(code, b, s, h, p, n)
    work = (torch.empty(work_bytes, dtype=torch.uint8, device=x.device)
            if work_bytes else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(),
            work.data_ptr() if work is not None else None, work_bytes, code,
            b, s, h, p, g, n, *strides, stream)
    _build.check(err, "ssd_scan_fwd")
    return y
