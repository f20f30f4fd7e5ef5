"""Members × lead steps of every request completed in the window, over its
seconds."""

from portbench.readers import per_second


def read(run):
    return per_second(run, lambda u: u.get("members", 0) * u.get("steps", 0))
