"""The benchmark's own yardstick: the H100's published peaks and the work a
kernel's call needs, counted from its shapes alone, whatever implements it.

Operations count the products' multiply-adds as two; elementwise work
(masks, exponentials, scalings) is not counted. Bytes count each input read
once and each output written once, at the dtypes the model hands the call:
bf16 activations, fp32 ``lse`` and ``dt``.
"""
from __future__ import annotations

from typing import Tuple

#: NVIDIA H100 SXM 80GB (data sheet, dense, at its 700 W limit): tensor-core
#: bf16, and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

BF16, FP32 = 2, 4


def attention_pairs(seq: int, causal: bool) -> int:
    """(query, key) pairs a head of one row keeps."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of its two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def flash_fwd_cost(batch: int, seq: int, heads: int, kv_heads: int,
                   head_dim: int, causal: bool) -> Tuple[float, float]:
    """(FLOPs, bytes): QKᵀ and PV over the kept pairs; Q, K, V read, O and
    the fp32 log-sum-exp written."""
    pairs = batch * heads * attention_pairs(seq, causal)
    flops = 4.0 * head_dim * pairs
    q = batch * seq * heads * head_dim
    kv = batch * seq * kv_heads * head_dim
    nbytes = BF16 * (q + 2 * kv + q) + FP32 * batch * heads * seq
    return flops, float(nbytes)


def flash_bwd_cost(batch: int, seq: int, heads: int, kv_heads: int,
                   head_dim: int, causal: bool) -> Tuple[float, float]:
    """(FLOPs, bytes): QKᵀ formed again (P is not an input), then dV, dP, dQ
    and dK, five products over the kept pairs; Q, K, V, O, dO and the
    log-sum-exp read, dQ, dK and dV written."""
    pairs = batch * heads * attention_pairs(seq, causal)
    flops = 10.0 * head_dim * pairs
    q = batch * seq * heads * head_dim
    kv = batch * seq * kv_heads * head_dim
    nbytes = (BF16 * (q + 2 * kv + 2 * q)          # q, k, v, o, do
              + FP32 * batch * heads * seq         # lse
              + BF16 * (q + 2 * kv))               # dq, dk, dv
    return flops, float(nbytes)


def ssd_fwd_cost(batch: int, seq: int, heads: int, head_dim: int,
                 groups: int, d_state: int, chunk: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the SSD forward, chunked: inside each chunk C·Bᵀ a
    group and the masked scores times x a head over the chunk's causal
    pairs; each token's contribution to its chunk's state and the state's
    to each token's output; the recurrence over chunk states. x and B, C
    (bf16) and dt (fp32) read, y (bf16) written."""
    b, s, h, p, g, n = batch, seq, heads, head_dim, groups, d_state
    chunks = s // chunk
    pairs = b * chunks * chunk * (chunk + 1) // 2
    flops = (2.0 * n * g * pairs + 2.0 * p * h * pairs
             + 2 * (2.0 * b * s * h * n * p) + 2.0 * b * chunks * h * n * p)
    nbytes = (BF16 * b * s * h * p + FP32 * b * s * h + FP32 * h
              + BF16 * 2 * b * s * g * n + BF16 * b * s * h * p)
    return flops, float(nbytes)


COSTS = {"flash_attention_fwd": ("flash_attention", flash_fwd_cost),
         "flash_attention_bwd": ("flash_attention", flash_bwd_cost),
         "ssd_scan_fwd": ("ssd_scan", ssd_fwd_cost)}


def kernel_roofline_pct(run, kernel: str, fragment: str):
    """A kernel's share of its roofline in the traced window: the least
    time of the calls the traced steps make (counted from the model's
    shapes) over the device time of the kernels whose names hold
    ``fragment``; None where the model makes no such call or the trace
    holds no such kernel."""
    call, cost = COSTS[kernel]
    calls = run.kernel_calls().get(call)
    seconds = run.trace.kernel_seconds(fragment) if run.trace else 0.0
    if calls is None or seconds <= 0.0:
        return None
    n, shape = calls
    least = n * run.trace.steps * least_seconds(*cost(**shape))
    return 100.0 * least / seconds
