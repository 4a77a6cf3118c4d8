"""The flash-attention backward's share of its roofline: 10·hd FLOPs a kept
pair and head (P formed again); Q, K, V, O, dO, lse read and dQ, dK, dV
written once; over the device time of the kernels named ``flash_bwd_``
(delta, dq, dk/dv)."""
from portbench import yardstick


def read(run):
    return yardstick.kernel_roofline_pct(run, "flash_attention_bwd",
                                         "flash_bwd_")
