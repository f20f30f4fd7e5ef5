"""What a measured window records, and the host's named ranges in it."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch


@dataclass
class Window:
    """One measured window: its length (first call to the device's
    synchronise after the last), the units issued and failed, each
    completed unit (``{"samples": B}`` for a train step, ``{"members": K,
    "steps": T, "latency_s": s}`` for an ensemble request) and the host time
    of each call to return, before any synchronise."""

    seconds: float
    attempted: int
    failed: int
    units: list[dict] = field(default_factory=list)
    dispatch_s: list[float] = field(default_factory=list)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Named host ranges: ``torch.profiler`` annotations in a traced run,
    nothing otherwise."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.names: set[str] = set()

    def range(self, name: str):
        if self.traced:
            self.names.add(name)
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()
