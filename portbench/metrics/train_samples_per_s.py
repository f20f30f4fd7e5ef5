"""Samples of every train step completed in the window, over its seconds."""

from portbench.readers import per_second


def read(run):
    return per_second(run, lambda u: u.get("samples", 0))
