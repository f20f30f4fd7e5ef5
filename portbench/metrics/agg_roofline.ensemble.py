"""The aggregation calls' least time over their kernels' device time."""

from portbench.readers import AGG, roofline_pct

FAMILIES = AGG


def read(run):
    return roofline_pct(run, FAMILIES)
