"""Profiling and performance observability: counterpart of
``gwen_tpu.profiling``, on CUDA events, ``torch.profiler`` and the caching
allocator's statistics.

The reference's names, with the same return values:

* :func:`timeit` and :func:`scan_timeit`: host-clock timing of a function
  with a barrier (``torch.cuda.synchronize`` when CUDA is up); the second
  chains ``iters`` calls and reads ``(T(2N) − T(N)) / N``, so every fixed
  cost cancels.
* :class:`StepTimer`: rolling per-step stats with derived throughput.
* :func:`trace` and :func:`annotate`: a ``torch.profiler`` trace written
  under a directory, and named ranges in it (recorded only while a
  profiler runs). :func:`start_server` has no CUDA counterpart and
  raises.
* :func:`device_memory_stats`: memory in use and the limit, per device.

The card's timers, which ``chip_smoke.py`` and ``tools/time_*.py`` use:

* :func:`cuda_ms`: a call's device time by CUDA events around many
  back-to-back calls;
* :func:`device_events`, :func:`device_ms` and :func:`kernel_us`: the
  device events of calls under ``torch.profiler``, for kernels shorter
  than the host's enqueue of a call, and their time by kernel name;
* :func:`profile_step`: one call's kernels by device time, and the share of
  its span (first kernel start to last kernel end) in which a kernel ran.

Every function here imports only torch and the standard library.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import deque
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def _sync() -> None:
    """The host's barrier: wait for every queued device operation (nothing
    to wait for without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 1,
           chain: Optional[Callable] = None) -> dict:
    """Mean host time of ``fn(*args)`` in seconds over ``iters`` calls,
    after ``max(warmup, 1)`` calls, with a device barrier before the clock
    starts and before it stops. ``chain`` (``output -> next args tuple``)
    makes every call's input the previous call's output."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*(chain(out) if chain is not None else args))
    _sync()
    return {"mean_s": (time.perf_counter() - t0) / iters, "iters": iters}


def scan_timeit(body: Callable, carry, *invariant, iters: int = 100,
                repeats: int = 3) -> dict:
    """Per-iteration time of ``body(carry, *invariant) -> carry``: chains of
    ``N = iters`` and ``2N`` calls, each ended by a device barrier, read as
    ``(T(2N) − T(N)) / N`` so that the barrier and any fixed cost cancel;
    the median over ``repeats``. Each call takes the previous one's carry,
    so no call can be skipped or reordered."""
    def many(n, c):
        for _ in range(n):
            c = body(c, *invariant)
        _sync()
        return c

    carry = many(2 * iters, many(iters, carry))  # warm both lengths
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        carry = many(iters, carry)
        t1 = time.perf_counter()
        carry = many(2 * iters, carry)
        t2 = time.perf_counter()
        times.append(((t2 - t1) - (t1 - t0)) / iters)
    times.sort()
    return {"mean_s": times[len(times) // 2], "iters": iters}


class StepTimer:
    """Rolling window of step durations (host clock) and throughput. A step
    that queues device work is timed to its end only if it ends in a
    barrier."""

    def __init__(self, window: int = 50, edges_per_step: int = 0,
                 items_per_step: int = 0):
        self.durations: deque[float] = deque(maxlen=window)
        self.edges_per_step = edges_per_step
        self.items_per_step = items_per_step
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is None:
            raise RuntimeError("StepTimer exited without being entered")
        self.durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def mean_step_s(self) -> float:
        return (sum(self.durations) / len(self.durations) if self.durations
                else float("nan"))

    def stats(self) -> dict:
        mean = self.mean_step_s
        out = {"step_time_s": mean,
               "steps_per_s": (1.0 / mean if mean > 0 else 0.0)}
        if self.edges_per_step:
            out["edges_per_s"] = self.edges_per_step / mean
        if self.items_per_step:
            out["items_per_s"] = self.items_per_step / mean
        return out


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: "str | Path" = "gwen_trace") -> Iterator:
    """Capture a ``torch.profiler`` trace (host and, with CUDA, device)
    around a block and write it as a Chrome trace,
    ``<log_dir>/trace_<pid>_<ns>.json``. Yields the profiler."""
    from torch.profiler import profile

    log_dir = Path(log_dir)
    with profile(activities=_activities()) as prof:
        yield prof
        _sync()
    log_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def start_server(port: int = 9999) -> None:
    """The reference starts ``jax.profiler``'s server for live capture from
    TensorBoard. ``torch.profiler`` has no such server: capture a window
    with :func:`trace` instead."""
    raise NotImplementedError(
        "torch.profiler has no live-capture server; use "
        "gwen_tpu_torch.profiling.trace(log_dir) around the steps to capture")


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named range for the profiler's timeline (a context manager). It
    records only while a ``torch.profiler`` is running; otherwise it is one
    shared null context, so a span left in a hot path costs a flag check.
    The program's own spans are named ``gwen.*`` (``docs/torch/bench.md``
    lists them)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def device_memory_stats() -> list[dict]:
    """One dict a device: ``device``, ``bytes_in_use`` (the caching
    allocator's allocated bytes) and ``bytes_limit`` (the device's total
    memory). Without CUDA, the CPU with ``None`` for both, as the reference
    reports a backend without statistics."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1]})
    return out


# --------------------------------------------------------- the card's timers


def cuda_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms: CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn: Callable, iters: int = 1) -> list:
    """The device events (kernels, copies, fills) that ``iters`` calls of
    ``fn()`` run under ``torch.profiler``. The ranges that annotations open
    on the device's timeline (``record_function``, such as the
    optimizer's ``Optimizer.step#...``) overlap the kernels they hold and
    are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def device_ms(fn: Callable, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms: the durations of the device
    events of ``iters`` calls (:func:`device_events`), summed, over
    ``iters``, after ``warmup`` calls. For a kernel shorter than the host's
    enqueue of a call, whose back-to-back CUDA-event time
    (:func:`cuda_ms`) measures the host. Raises where the trace holds no
    device event."""
    for _ in range(warmup):
        fn()
    us = sum(ev.time_range.elapsed_us() for ev in device_events(fn, iters))
    if not us:
        raise AssertionError("the profiler saw no device kernel")
    return us / iters / 1e3


def kernel_us(fn: Callable, iters: int = 1) -> dict:
    """The device time of ``iters`` calls of ``fn()`` by kernel name (µs),
    under ``torch.profiler``."""
    out: dict = {}
    for ev in device_events(fn, iters):
        out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return out


def profile_step(step: Callable) -> dict:
    """One ``step()`` under ``torch.profiler``: ``kernels_us`` (device µs
    by kernel name), ``busy_ms`` (the time in which at least one device
    event ran: kernels that overlap count once), ``span_ms`` (first event
    start to last event end) and ``busy_share``. Where the trace holds no
    device event, ``kernels_us`` is empty and the rest ``nan``."""
    by_name, ranges = {}, []
    for ev in device_events(step):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
        ranges.append((ev.time_range.start, ev.time_range.end))
    if not by_name:
        return {"kernels_us": {}, "busy_ms": math.nan, "span_ms": math.nan,
                "busy_share": math.nan}
    ranges.sort()
    busy, (lo, hi) = 0.0, ranges[0]
    for start, end in ranges[1:]:
        if start > hi:
            busy, lo = busy + (hi - lo), start
        hi = max(hi, end)
    busy += hi - lo
    span = hi - ranges[0][0]
    return {"kernels_us": by_name, "busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "busy_share": busy / span}
