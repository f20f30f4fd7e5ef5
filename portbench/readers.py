"""Arithmetic shared by the metrics' readers (``metrics/<name>.py``). Each
returns ``None`` where the run holds nothing for it to read."""

from __future__ import annotations

import math
from typing import Optional

from portbench.roofline.epd import useful_flops

GIB = 2 ** 30
# Kernel names of each operator family, as the device trace shows them.
AGG = {"agg": ("dense_rows_kernel", "dense_row1_kernel", "packed_rows_kernel",
               "packed_row1_kernel", "tile_walk_kernel", "tile_list_kernel",
               "ell_spmm_kernel")}
ATTN = {"attn_fwd": ("attn_fwd_kernel",),
        "attn_bwd": ("attn_dq_kernel", "attn_dkdv_kernel")}
LN = {"ln_fwd": ("ln_fwd",), "ln_bwd": ("ln_bwd",)}


def roofline_pct(run, families: dict) -> Optional[float]:
    """The families' calls' least time on the card (the larger of bytes
    over the memory rate and operations over the bf16 rate, summed) over
    the device time of the kernels their names match, in %."""
    if run.trace is None or run.peaks is None:
        return None
    ops = [op for op in run.ops if op.family in families]
    seconds = run.trace.seconds(tuple(p for pats in families.values() for p in pats))
    if not ops or seconds <= 0:
        return None
    pk = run.peaks
    bound = sum(max(op.bytes / pk["hbm_bytes_per_s"], op.flops / pk["bf16_flops_per_s"])
                for op in ops)
    return 100.0 * bound / seconds


def mfu_pct(run) -> Optional[float]:
    """The window's useful operations over its seconds times the card's
    bf16 peak, in %."""
    if run.peaks is None or not run.ops:
        return None
    return 100.0 * useful_flops(run.ops) / (run.window.seconds * run.peaks["bf16_flops_per_s"])


def idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.span_s)


def median_dispatch_ms(run) -> Optional[float]:
    d = sorted(run.window.dispatch_s)
    if not d:
        return None
    mid = len(d) // 2
    return 1e3 * (d[mid] if len(d) % 2 else 0.5 * (d[mid - 1] + d[mid]))


def peak_gib(run) -> Optional[float]:
    return run.peak_bytes / GIB if run.peak_bytes else None


def percentile_ms(run, q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile of the requests' latencies."""
    lat = sorted(u["latency_s"] for u in run.window.units if "latency_s" in u)
    if not lat:
        return None
    return 1e3 * lat[max(math.ceil(q / 100.0 * len(lat)) - 1, 0)]


def per_second(run, key) -> Optional[float]:
    """``key(unit)`` summed over the window's completed units, over its
    seconds."""
    total = sum(key(u) for u in run.window.units)
    return total / run.window.seconds if total else None
