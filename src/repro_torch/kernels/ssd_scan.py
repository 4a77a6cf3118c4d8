"""Launchers of the hand-written SSD chunked-scan kernels: the forward
(``csrc/ssd_scan.cu``), the twin of the JAX package's Pallas
`kernels/ssd_scan.py:ssd_scan_fwd`, and the bf16 backward
(``csrc/ssd_scan_bwd.cu``), which has no Pallas twin (the reference takes
`jax.vjp` of its oracle).

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

The backward takes the forward's inputs as the forward takes them, dy
in their dtype, and returns (dx, ddt, dA, dB, dC): dx, dB and dC in bf16,
ddt and dA in fp32, each contiguous. It runs four kernels over 64-token
chunks and a workspace this launcher allocates
(``repro_ssd_scan_bwd_workspace_bytes`` sizes it).

On the meta device (the dry run) each launcher checks what its kernel
takes and allocates its outputs, and launches nothing (nor sizes the
workspace); `cost` and `bwd_cost` give a call's products and bytes.
"""
from __future__ import annotations

import torch

from typing import Tuple

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 32, 64, 128)
BWD_CHUNK = 64  # tokens per chunk of the backward kernel (`kL`)
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


def bwd_cost(b: int, s: int, h: int, p: int, g: int, n: int,
             itemsize: int = 2) -> Tuple[float, float]:
    """(products, bytes) of one backward call, at the kernel's own chunk
    of `BWD_CHUNK` tokens whatever chunk the caller names (the gradient
    does not depend on it; a ragged last chunk counts its own length):
    per chunk of L tokens the causal halves of C.B^T (once per group)
    and, per head, of dy.x^T, scores^T.dy (dx), and the two L x L terms
    of dB and dC, plus six state-sized products per head (the local
    state, dy's share of D, B.D^T, x.D^T, C.S^T, dy.S^T); x, dy, dx, B,
    C, dB, dC in x's dtype, dt, ddt, A and dA in fp32, each once."""
    def chunk_flops(L: int) -> int:
        pairs = L * (L + 1)        # 2 x the causal (l, m) pairs
        return g * n * pairs + h * ((2 * p + 2 * n) * pairs + 12 * L * n * p)

    full, rest = divmod(s, BWD_CHUNK)
    flops = b * (full * chunk_flops(BWD_CHUNK) + chunk_flops(rest))
    nbytes = (3 * itemsize * b * s * h * p + 8 * (b * s * h + h)
              + 4 * itemsize * b * s * g * n)
    return float(flops), float(nbytes)


def _strides(x, dt, B, C):
    # strides of size-1 dims are never stepped; pass them as 0
    return [t.stride(i) if t.shape[i] > 1 else 0
            for t in (x, dt, B, C) for i in range(3)]


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
    strides = _strides(x, dt, B, C)
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


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on the card for bf16 x, B, C and dy.
    Returns (dx, ddt, dA, dB, dC), the gradients of `ssd_scan_fwd`'s y."""
    check_shapes(x, dt, A, B, C, chunk)
    ins = (x, dt, A, B, C, dy)
    if x.device.type not in ("cuda", "meta") or any(t.device != x.device
                                                     for t in ins):
        raise ValueError("ssd_scan_bwd launches a CUDA kernel: its tensors "
                         "must lie on one CUDA device")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if (any(t.dtype != torch.bfloat16 for t in (x, B, C, dy))
            or dt.dtype != torch.float32 or A.dtype != torch.float32):
        raise TypeError(f"ssd_scan_bwd takes bf16 x, B, C, dy and fp32 dt "
                        f"and A, got {[str(t.dtype) for t in ins]}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan_bwd takes head_dim p in {HEAD_DIMS} and "
                         f"d_state n in {STATE_DIMS}, got p={p}, n={n}")
    if any(t.stride(3) != 1 for t in (x, B, C)) or not A.is_contiguous():
        raise ValueError("ssd_scan_bwd needs x, B, C with a contiguous last "
                         "dimension and a contiguous A")
    strides = _strides(x, dt, B, C)
    dy = dy.contiguous()
    if (any(st % 8 for i, st in enumerate(strides) if not 3 <= i < 6)
            or any(t.data_ptr() % 16 for t in (x, B, C, dy))):
        raise ValueError("ssd_scan_bwd reads x, B, C as TMA boxes: their "
                         "strides must be multiples of 8 and their data "
                         "16-byte aligned")
    if x.is_meta:
        return _bwd_outputs(x, B, C)
    return _launch_bwd(x, dt, A, B, C, dy)


def _bwd_outputs(x, B, C):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    return (torch.empty((b, s, h, p), dtype=x.dtype, device=x.device),
            torch.empty((b, s, h), dtype=torch.float32, device=x.device),
            torch.empty((h,), dtype=torch.float32, device=x.device),
            torch.empty((b, s, g, n), dtype=B.dtype, device=x.device),
            torch.empty((b, s, g, n), dtype=C.dtype, device=x.device))


# The launch is a registered operator so that a profiler ties the kernels
# to the span around it: the profiler ties a kernel to the innermost
# operator open at its launch (a `record_function` range is none), and a
# call into the library is no operator, so without this one the kernels
# went to autograd's node, which opens before ``repro_torch.ssd_bwd``.
@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _launch_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dx, ddt, dA, dB, dC = _bwd_outputs(x, B, C)
    strides = _strides(x, dt, B, C)
    lib = _build.library()
    work_bytes = lib.repro_ssd_scan_bwd_workspace_bytes(b, s, h, p, g, n)
    work = torch.empty(work_bytes, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), work.data_ptr(),
            work_bytes, b, s, h, p, g, n, *strides, stream)
    _build.check(err, "ssd_scan_bwd")
    return dx, ddt, dA, dB, dC

