"""Median host time for one call (a `Trainer.train_step`) to return,
before any synchronise."""

from portbench.readers import median_dispatch_ms


def read(run):
    return median_dispatch_ms(run)
