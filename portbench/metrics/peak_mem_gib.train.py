"""The allocator's peak over the window (reset at its start)."""

from portbench.readers import peak_gib


def read(run):
    return peak_gib(run)
