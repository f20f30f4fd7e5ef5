"""Device ms a train step under the program's span ``gwen.backward``: the
window's device time on paths through it, over the ``gwen.train_step``
spans begun in the window."""

from portbench import tap
from portbench.spans import per_step_ms

tap.install()


def read(run):
    return per_step_ms(tap.span_trace(run), "gwen.backward")
