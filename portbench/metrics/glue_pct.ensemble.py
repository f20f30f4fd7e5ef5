"""The share of the device time under ``gwen.ensemble`` whose span path
holds no ``gwen.op.*`` span (the torch glue), in %."""

from portbench import tap
from portbench.spans import glue_pct

tap.install()


def read(run):
    return glue_pct(tap.span_trace(run), ("gwen.ensemble",))
