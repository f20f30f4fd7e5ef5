"""The window's useful operations (matrix products, aggregation,
attention; roofline/epd.py) over its seconds times the bf16 peak."""

from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
