"""Process start to the window's first call."""


def read(run):
    return run.setup_s
