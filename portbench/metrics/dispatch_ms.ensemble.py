"""Median host time for one call (a `generate_ensemble` request) to return,
before any synchronise."""

from portbench.readers import median_dispatch_ms


def read(run):
    return median_dispatch_ms(run)
