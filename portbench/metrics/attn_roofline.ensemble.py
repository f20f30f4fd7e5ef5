"""The windowed-attention calls' (forward; backward) least time over their
kernels' device time."""

from portbench.readers import ATTN, roofline_pct

FAMILIES = ATTN


def read(run):
    return roofline_pct(run, FAMILIES)
