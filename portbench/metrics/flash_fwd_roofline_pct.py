"""The flash-attention forward's share of its roofline: the least time of a
step's calls at the cell's shapes (4·hd FLOPs a kept pair and head; Q, K, V
read and O, lse written once) over the device time of the kernels named
``flash_fwd_``."""
from portbench import yardstick


def read(run):
    return yardstick.kernel_roofline_pct(run, "flash_attention_fwd",
                                         "flash_fwd_")
