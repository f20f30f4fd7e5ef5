"""The median request's device idle ms, from the host start of its
``gwen.ensemble`` span to the end of the last device event launched under
it, on the profiler's one clock."""

from portbench import tap
from portbench.spans import request_idle_ms

tap.install()


def read(run):
    return request_idle_ms(tap.span_trace(run))
