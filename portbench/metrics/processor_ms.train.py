"""Device ms a train step on paths through the program's span
``gwen.process`` (GraphCast's processor layers, forward and backward),
over the ``gwen.train_step`` spans begun in the window."""

from portbench import tap
from portbench.spans import per_step_ms

tap.install()


def read(run):
    return per_step_ms(tap.span_trace(run), "gwen.process")
