"""Device dispatch for the ported kernels — the twin of the JAX package's
`kernels/ops.py`.

The rule: a tensor on the CPU takes the plain PyTorch version
(`kernels.ref`), which autograd differentiates; a tensor on the card
launches the hand-written kernel or raises. There is no fallback from the
card to the plain version and no flag that turns a kernel off.

On the card each op is a `torch.autograd.Function` (the twin of the
reference's `jax.custom_vjp`):

* flash attention: the forward kernel, whose (q, k, v, out, lse) are
  saved, and the backward kernel (``csrc/flash_attention_bwd.cu``), both
  at head dims 32, 64, 80 and 128;
* RMSNorm: the forward kernel, whose (x, scale) are saved, and the
  backward kernel (``csrc/rmsnorm.cu``), where the reference's `_rn_bwd`
  takes `jax.vjp` of its oracle (it has no Pallas backward);
* SSD scan: the forward kernel (``csrc/ssd_scan.cu``), whose inputs are
  saved, and a backward by recompute — autograd over `ref.ssd_scan_ref`
  at the same chunk, as the reference's `_ssd_bwd`;
* event select (the fleet engine's next event): the kernel
  (``csrc/event_select.cu``), not differentiable, so no Function.

Under ``torch.no_grad()`` (prefill, serving) autograd builds no graph, so
what the forward saves is dropped when it returns.

``launches`` counts each kernel's launches, keyed by kernel name, and is
incremented only where a kernel was launched, so a run can show that its
path went through the kernels (``chip_smoke.py`` zeroes the counts with
`reset_launches` before the main path and reads them after).

On the meta device (the dry run, `launch/dryrun.py`) every op takes the
same path as on the card, through the same autograd Functions, so the
backward and a checkpoint's recompute are reached as they are there; the
launchers allocate their outputs and launch nothing. Such a call adds
nothing to ``launches``: it adds one call and the kernel's operations and
bytes (each wrapper's cost function) to ``tally`` instead.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import event_select as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ss

launches: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0, "rmsnorm_fwd": 0,
                            "rmsnorm_bwd": 0, "ssd_scan_fwd": 0,
                            "event_select_fwd": 0}


#: the dry run's count by kernel: [calls on the meta device, operations,
#: bytes]
tally: Dict[str, List[float]] = {name: [0, 0.0, 0.0] for name in launches}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def reset_tally() -> None:
    for name in tally:
        tally[name] = [0, 0.0, 0.0]


def _tally(name: str, cost: Tuple[float, float]) -> None:
    row = tally[name]
    row[0] += 1
    row[1] += cost[0]
    row[2] += cost[1]


def _flash_cost(cost, q, k, causal):
    B, Sq, H, hd = q.shape
    return cost(B, Sq, k.shape[1], H, k.shape[2], hd, causal,
                q.element_size())


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        if q.is_meta:
            _tally("flash_attention_fwd",
                   _flash_cost(fa.fwd_cost, q, k, causal))
        else:
            launches["flash_attention_fwd"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # dO may arrive with the strides of the reshape before `wo`
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse,
                                            do.contiguous(),
                                            causal=ctx.causal)
        if q.is_meta:
            _tally("flash_attention_bwd",
                   _flash_cost(fa.bwd_cost, q, k, ctx.causal))
        else:
            launches["flash_attention_bwd"] += 1
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q:(B,Sq,H,hd) k,v:(B,Sk,KV,hd) -> (B,Sq,H,hd), softmax scale
    1/sqrt(hd). Causal needs Sq == Sk on either device."""
    fa.check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)[0]
    return _FlashAttention.apply(q, k, v, causal)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        out = rn.rmsnorm_fwd(x, scale, eps)
        if x.is_meta:
            _tally("rmsnorm_fwd", rn.fwd_cost(x.numel() // x.shape[-1],
                                              x.shape[-1], x.element_size()))
        else:
            launches["rmsnorm_fwd"] += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        # one count a call, whether the kernel sums dscale in one launch
        # or two
        dx, dscale = rn.rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps,
                                    need_dscale=ctx.needs_input_grad[1])
        if x.is_meta:
            _tally("rmsnorm_bwd", rn.bwd_cost(x.numel() // x.shape[-1],
                                              x.shape[-1], x.element_size()))
        else:
            launches["rmsnorm_bwd"] += 1
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x:(..., d), scale:(d,) -> x's shape and dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    return _RMSNorm.apply(x, scale, eps)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y = ss.ssd_scan_fwd(x, dt, A, B, C, chunk)
        if x.is_meta:
            _tally("ssd_scan_fwd", ss.cost(*x.shape, *B.shape[2:], chunk,
                                           x.element_size()))
        else:
            launches["ssd_scan_fwd"] += 1
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            y = ref.ssd_scan_ref(*ins, ctx.chunk)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, dy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in ins) + (None,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mamba2 SSD chunked scan. x:(b,s,h,p) dt:(b,s,h) A:(h,)
    B,C:(b,s,g,n) -> y:(b,s,h,p) in x's dtype, computed in fp32. The chunk
    is ``min(chunk, s)``, which must divide s on either device."""
    chunk = ss.check_shapes(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    return _SSDScan.apply(x, dt, A, B, C, chunk)


def event_select(ev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, m) candidate-event times, inf = masked -> (min (n,), argmin (n,)
    int32), ties broken to the lowest column; all-inf rows (inf, 0)."""
    if ev.device.type == "cpu":
        return ref.event_select_ref(ev)
    t, i = es.event_select_fwd(ev)
    if ev.is_meta:
        _tally("event_select_fwd", es.cost(*ev.shape, ev.element_size()))
    else:
        launches["event_select_fwd"] += 1
    return t, i
