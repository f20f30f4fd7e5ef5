"""The nearest-rank 95th percentile of every request's latency in the
window (call to the synchronise after it)."""

from portbench.readers import percentile_ms


def read(run):
    return percentile_ms(run, 95)
