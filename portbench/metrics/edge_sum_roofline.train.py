"""The edge sums' least time (roofline/graphcast.py: E × L read, receivers
× L written, the index; the backward the other way round; recomputed calls
included) over the device time on paths through ``gwen.op.edge_sum`` and
``gwen.op.edge_sum.bwd``."""

from portbench import tap
from portbench.roofline.graphcast import span_roofline_pct

tap.install()


def read(run):
    return span_roofline_pct(run, tap.span_trace(run), "edge_sum",
                             ("gwen.op.edge_sum", "gwen.op.edge_sum.bwd"))
