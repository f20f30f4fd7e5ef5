"""The gathers' least time (roofline/graphcast.py: the edge latent and the
two node sets read, the joined edge rows written, two indices; the
backward the other way round; recomputed calls included) over the device
time on paths through ``gwen.op.gather`` and ``gwen.op.gather.bwd``."""

from portbench import tap
from portbench.roofline.graphcast import span_roofline_pct

tap.install()


def read(run):
    return span_roofline_pct(run, tap.span_trace(run), "gather",
                             ("gwen.op.gather", "gwen.op.gather.bwd"))
