"""The share of the traced window in which no device operation ran."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
