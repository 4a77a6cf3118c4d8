"""Launcher of the hand-written event-select kernel
(``csrc/event_select.cu``), the twin of the JAX package's Pallas
`kernels/event_select.py:event_select_fwd`.

ev ``(n, m)`` float64 (the fleet engine's type) or float32, contiguous,
on the card. Returns ``(t, i)``: the row minimum ``(n,)`` in ev's type and
the lowest column attaining it ``(n,)`` int32. All-inf rows give
``(inf, 0)``; a row holding a NaN gives ``(NaN, 0)``. Not differentiable.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1}


def event_select_fwd(ev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the card."""
    if not ev.is_cuda:
        raise ValueError("event_select_fwd launches a CUDA kernel: ev must "
                         "lie on a CUDA device")
    if ev.dtype not in _DTYPE_CODE:
        raise TypeError(f"event_select_fwd takes float64 or float32, got "
                        f"{ev.dtype}")
    if ev.dim() != 2 or 0 in ev.shape or not ev.is_contiguous():
        raise ValueError(f"event_select_fwd needs a non-empty contiguous "
                         f"(n, m) matrix, got {tuple(ev.shape)}")
    n, m = ev.shape
    t = torch.empty(n, dtype=ev.dtype, device=ev.device)
    i = torch.empty(n, dtype=torch.int32, device=ev.device)
    lib = _build.library()
    with torch.cuda.device(ev.device):
        stream = torch.cuda.current_stream(ev.device).cuda_stream
        err = lib.repro_event_select_fwd(ev.data_ptr(), t.data_ptr(),
                                         i.data_ptr(), n, m,
                                         _DTYPE_CODE[ev.dtype], stream)
    _build.check(err, "event_select_fwd")
    return t, i
