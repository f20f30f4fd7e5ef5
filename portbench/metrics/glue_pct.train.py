"""The share of the device time under ``gwen.forward`` and
``gwen.backward`` whose span path holds no ``gwen.op.*`` span (the torch
glue: activations, casts, residual and bias-gradient sums outside the
products, head transposes, the padding ``cat``), in %."""

from portbench import tap
from portbench.spans import glue_pct

tap.install()


def read(run):
    return glue_pct(tap.span_trace(run), ("gwen.forward", "gwen.backward"))
