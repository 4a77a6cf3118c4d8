"""The SSD scan forward's share of its roofline, from the chunked scan's
products and its inputs and output at the cell's shapes, over the device
time of the kernels named ``ssd_`` (its three stages)."""
from portbench import yardstick


def read(run):
    return yardstick.kernel_roofline_pct(run, "ssd_scan_fwd", "ssd_")
