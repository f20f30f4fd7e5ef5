"""The fused residual LayerNorm calls' least time over their kernels'
device time."""

from portbench.readers import LN, roofline_pct

FAMILIES = LN


def read(run):
    return roofline_pct(run, FAMILIES)
