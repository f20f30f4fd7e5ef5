"""One run of one cell: set-up, the measured window (traced or not), the
metrics its files read, then the check against the plain reference.

Set-up is everything from the process's start to the window's first call:
the program's graph build, the weights and inputs drawn from the seed,
and the warm-up of the cell's own shapes (the first run in a checkout also
builds the kernels). The window runs for ``seconds``. The check runs after
the window has closed, its peak memory has been read and the program's
state is freed.
"""

from __future__ import annotations

import gc
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

from portbench import checks, port
from portbench.roofline import Op, peaks
from portbench.spec import Spec
from portbench.trace import Trace, capture, reduce
from portbench.window import Recorder, Window

ROOT = Path(__file__).resolve().parents[1]
_IMPORTED = time.perf_counter()


class TraceShort(RuntimeError):
    """The device trace holds fewer launches than the window must have
    made, twice."""


@dataclass
class Run:
    """What a metric's reader reads."""

    workload: str
    cfg: dict
    mix: dict
    window: Window
    ops: list[Op]
    setup_s: float
    peak_bytes: int
    peaks: Optional[dict] = None
    trace: Optional[Trace] = None


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``), or since this module was imported where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            age = float(f.read().split()[0]) - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        age = -1.0
    return age if 0 <= age < 3600 else time.perf_counter() - _IMPORTED


def power_limit_w(index: int) -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(index)], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _traced_window(driver, seconds: float, device: torch.device, expected: dict,
                   patterns: dict, notes: list[str]) -> tuple[Window, Trace]:
    """The window under the profiler, again once if its trace holds fewer
    launches of a family than the window's completed work must contain."""
    for attempt in (1, 2):
        rec = Recorder(True)
        with capture(device) as cap:
            win = driver.window(seconds, rec)
        tr = reduce(cap.events, rec.names)
        short = [f"{fam}: {tr.launches(patterns[fam])} launches of {need}"
                 for fam, need in expected(win).items()
                 if fam in patterns and tr.launches(patterns[fam]) < need]
        if tr.span_s <= 0:
            short.append(f"the window's own range is missing ({tr.events} events)")
        if not short:
            notes.append(f"trace: {tr.events} profiler events ({cap.source})")
            return win, tr
        notes.append(f"trace short (attempt {attempt}): " + "; ".join(short))
    raise TraceShort("; ".join(short))


def expected_launches(driver) -> Callable[[Window], dict]:
    """Each operator family's call count in a window's completed work: at
    least one launch of the family's kernels a call."""
    def count(win: Window) -> dict:
        out: dict = {}
        for op in driver.ops(win):
            if op.family != "matmul":
                out[op.family] = out.get(op.family, 0) + 1
        return out
    return count


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, root: Path = ROOT,
             config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None) -> tuple[dict, list[str]]:
    """Run the cell once; returns the result line's object (``checks``
    last) and the notes for standard error."""
    spec = Spec.load(root)
    cell = spec.workload(workload)
    cfg = spec.config(cell["config"], config_overrides)
    mix = spec.traffic(cell["traffic"], traffic_overrides)
    metrics = spec.per_layer(workload) if traced else spec.end_to_end(workload)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    driver = spec.driver(mix["driver"])(cfg, mix, device)

    t0 = time.perf_counter()
    program = port.build_graph(cfg, device)
    t1 = time.perf_counter()
    driver.start(seed, program)
    setup_s = process_age()
    t2 = time.perf_counter()
    notes = [f"set-up {setup_s:.2f} s: before the graph {setup_s - (t2 - t0):.2f} s, graph "
             f"{t1 - t0:.2f} s, weights, inputs and warm-up {t2 - t1:.2f} s"]
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tr = None
    if traced:
        patterns = {fam: pats for r in readers.values()
                    for fam, pats in getattr(r, "FAMILIES", {}).items()}
        win, tr = _traced_window(driver, seconds, device, expected_launches(driver),
                                 patterns, notes)
    else:
        win = driver.window(seconds, Recorder(False))
    window_peak = _peak(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    try:
        card = peaks(kind)
    except KeyError:
        card = None
        notes.append(f"no published peaks for {kind!r}: no share of a peak is read")
    run = Run(workload, cfg, mix, win, driver.ops(win), setup_s, window_peak, card, tr)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    notes.append(f"window: {win.attempted} attempted, {win.failed} failed, "
                 f"{len(win.units)} completed in {win.seconds} s")

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    judged = checks.judge(driver.check(), spec.limits(workload))
    notes.append(f"check against the reference: {time.perf_counter() - t0:.1f} s")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell["chips"] if device.type == "cuda" else 0,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w(device.index or 0)
    out = {"correct": win.failed == 0 and all(c["ok"] for c in judged.values()),
           "attempted": win.attempted, "failed": win.failed,
           "metrics": values, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.span_s
        out["breakdown"] = {"device_ops": tr.top_kernels(), "idle_gaps": tr.top_idle()}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in judged.items()}
    return out, notes
