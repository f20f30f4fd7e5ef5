"""What the readers of the program's spans and counters read, kept from a
traced window: its events with their links (``spans.Linked``) and the
program's kernel-load counter as the window opened.

The harness hands a reader a ``Run``, whose ``Trace`` holds device time by
kernel name and no events. :func:`install`, which each reader of program
spans calls when its file is loaded (before the window), puts two
wrappers on the harness's own names:

* ``capture`` profiles the block as ``trace.capture`` does, but keeps each
  event as a :class:`spans.Linked`, whose first five fields are
  ``trace.Event``'s, so ``reduce`` reads what it read before. It reads the
  kernel-load counter as the block opens.
* ``reduce`` returns what it returned, and keeps the events beside the
  ``Trace`` it made, with the harness's range names.

A reader finds its run's events by that ``Trace`` (``run.trace``): the tap
keeps the last window profiled, as the harness does (the second where the
first was short). The events are reduced to a ``spans.SpanTrace`` once, on
the first read, and standard error gets the unattributed share, the spans'
``layers`` and the idle gaps by span.

The counter is read from the loaded program (``gwen_tpu_torch.ops``
``kernel_loads``); a program without it reads ``None``, and so do its
readers. ``port`` stays the only module of the benchmark that imports the
program.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from portbench import harness, spans
from portbench.trace import Capture


@dataclass
class Kept:
    """One profiled window: its ``Trace``, its events until they are
    reduced, the harness's range names and the counter at its start."""

    trace: object
    events: Optional[list]
    ranges: set
    loads: Optional[dict]
    spans: Optional[spans.SpanTrace] = None


_opened: dict = {}
_last: Optional[Kept] = None


def program_kernel_loads() -> Optional[dict]:
    """The loaded program's ``{name: {"count", "seconds"}}``, or ``None``."""
    read = getattr(sys.modules.get("gwen_tpu_torch.ops"), "kernel_loads", None)
    return read() if callable(read) else None


@contextlib.contextmanager
def capture(device: torch.device):
    """``trace.capture``, its events with their links."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    out = Capture()
    _opened["loads"] = program_kernel_loads()
    with profile(activities=acts) as prof:
        yield out
    results = getattr(prof.profiler, "kineto_results", None)
    raw = results.events() if results is not None else []
    if raw:
        out.events, out.source = [spans.from_kineto(ev) for ev in raw], "raw"
    else:
        out.events, out.source = [spans.from_function_event(ev) for ev in prof.events()], "parsed"


def _keeping(reduce):
    def kept_reduce(events, range_names):
        global _last
        tr = reduce(events, range_names)
        _last = Kept(tr, events, set(range_names), _opened.pop("loads", None))
        return tr
    kept_reduce.tapped = True
    return kept_reduce


def install() -> None:
    """Put the two wrappers on the harness, once a process."""
    if getattr(harness.reduce, "tapped", False):
        return
    harness.capture = capture
    harness.reduce = _keeping(harness.reduce)


def kept(run) -> Optional[Kept]:
    """What the tap kept of ``run``'s window, or ``None``."""
    k = _last
    return k if k is not None and run.trace is not None and k.trace is run.trace else None


def span_trace(run) -> Optional[spans.SpanTrace]:
    """``run``'s window by program span, reduced on the first call."""
    k = kept(run)
    if k is None:
        return None
    if k.spans is None:
        t0 = time.perf_counter()
        k.spans, k.events = spans.attribute(k.events, k.ranges), None
        _report(k.spans, time.perf_counter() - t0)
    return k.spans


def kernel_loads(run) -> Optional[dict]:
    k = kept(run)
    return k.loads if k is not None else None


def _report(sp: spans.SpanTrace, seconds: float) -> None:
    print(f"# spans: {100 * sp.unattributed_share():.3f} % of {sp.device_s:.3f} device s "
          f"unattributed, {sum(sp.opened.values())} program spans, launch times of "
          f"{sp.runtime_timed} of {sp.launched} device events from runtime calls; "
          f"reduced in {seconds:.1f} s", file=sys.stderr)
    worst = sorted(sp.unattributed_by.items(), key=lambda kv: -kv[1])[:5]
    if worst:
        print("# spans: unattributed, by launch: " + "; ".join(
            f"{name} {s:.4f} s" for name, s in worst), file=sys.stderr)
    print(f"# spans: layers {json.dumps(sp.layers())}", file=sys.stderr)
    print(f"# spans: idle_by_span {json.dumps(sp.top_idle())}", file=sys.stderr, flush=True)
