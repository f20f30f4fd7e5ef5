"""The device trace of a window: ``torch.profiler`` (kineto, CUPTI) around
it, read from the profiler's event list in memory (no trace file is
written), and reduced to the device's busy time, the device time of each
kernel name and the idle gaps named by the host range open at the time.

The arithmetic is the port's ``profiling.profile_step``'s: busy time is
the union of the device events' intervals, the GPU-side annotation ranges
left out.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

WINDOW_RANGE = "window"


@dataclass
class Trace:
    """A window's device trace: device seconds and launches by kernel name,
    the busy seconds (union of device intervals inside the window range)
    and the idle seconds by the host range that was open."""

    events: int = 0
    kernels: dict[str, list] = field(default_factory=dict)  # name -> [count, s]
    busy_s: float = 0.0
    span_s: float = 0.0
    idle_by_range: dict[str, float] = field(default_factory=dict)

    def launches(self, patterns) -> int:
        return sum(c for name, (c, _) in self.kernels.items()
                   if any(p in name for p in patterns))

    def seconds(self, patterns) -> float:
        return sum(s for name, (_, s) in self.kernels.items()
                   if any(p in name for p in patterns))

    def top_kernels(self, k: int = 10) -> list[list]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name, s] for name, (_, s) in top]

    def top_idle(self, k: int = 10) -> list[list]:
        top = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:k]
        return [[name, s] for name, s in top]


class Event(NamedTuple):
    """One profiler event: its name, whether it ran on the device, whether
    it is an annotation range, and its interval in ns."""

    name: str
    device: bool
    annotation: bool
    start_ns: int
    end_ns: int


@dataclass
class Capture:
    """The events of a profiled block, once it has ended, and which list
    they were read from (``raw`` kineto events or the ``parsed`` ones)."""

    events: list[Event] = field(default_factory=list)
    source: str = ""


@contextlib.contextmanager
def capture(device: torch.device):
    """Profile the block (host and, on CUDA, device activity); yields a
    :class:`Capture` that holds the events once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    out = Capture()
    with profile(activities=acts) as prof:
        yield out
    results = getattr(prof.profiler, "kineto_results", None)
    raw = results.events() if results is not None else []
    if raw:
        out.events, out.source = [_from_kineto(ev) for ev in raw], "raw"
    else:  # the parsed events, where the raw list is not exposed
        out.events, out.source = [_from_function_event(ev) for ev in prof.events()], "parsed"


def _from_kineto(ev) -> Event:
    from torch.autograd import DeviceType

    start = ev.start_ns()
    annotation = ev.is_user_annotation() if hasattr(ev, "is_user_annotation") else False
    return Event(ev.name(), ev.device_type() == DeviceType.CUDA, annotation,
                 start, start + ev.duration_ns())


def _from_function_event(ev) -> Event:
    from torch.autograd import DeviceType

    return Event(ev.name, ev.device_type == DeviceType.CUDA,
                 bool(getattr(ev, "is_user_annotation", False)),
                 int(ev.time_range.start * 1000), int(ev.time_range.end * 1000))


def reduce(events: list[Event], range_names) -> Trace:
    """Reduce profiler events to a :class:`Trace`; idle gaps are named by
    the host ranges in ``range_names`` (the harness's own)."""
    dev, ranges, window = [], [], None
    out = Trace(events=len(events))
    for ev in events:
        if ev.device:
            if ev.annotation:
                continue
            dev.append((ev.start_ns, ev.end_ns))
            entry = out.kernels.setdefault(ev.name, [0, 0.0])
            entry[0] += 1
            entry[1] += (ev.end_ns - ev.start_ns) / 1e9
        elif ev.name == WINDOW_RANGE:
            window = (ev.start_ns, ev.end_ns)
        elif ev.name in range_names:
            ranges.append((ev.start_ns, ev.end_ns, ev.name))
    if window is None or not dev:
        return out
    w_lo, w_hi = window
    out.span_s = (w_hi - w_lo) / 1e9
    dev = sorted((max(lo, w_lo), min(hi, w_hi)) for lo, hi in dev if hi > w_lo and lo < w_hi)
    ranges.sort()
    gaps, cur_lo, cur_hi = [], w_lo, w_lo
    busy = 0
    for lo, hi in dev:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            gaps.append((cur_hi, lo))
            cur_lo = lo
        cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    if w_hi > cur_hi:
        gaps.append((cur_hi, w_hi))
    out.busy_s = busy / 1e9
    starts = [r[0] for r in ranges]
    for lo, hi in gaps:
        name = _open_range(ranges, starts, (lo + hi) // 2)
        out.idle_by_range[name] = out.idle_by_range.get(name, 0.0) + (hi - lo) / 1e9
    return out


def _open_range(ranges: list[tuple[int, int, str]], starts: list[int],
                t: int) -> str:
    """The host range open at ``t`` (the harness's ranges inside the window
    follow one another), or "harness" where none is."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][1] >= t:
        return ranges[i][2]
    return "harness"
