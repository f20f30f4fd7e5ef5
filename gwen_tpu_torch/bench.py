"""``python -m gwen_tpu_torch bench``: the port's counterpart of the
reference's ``bench.py``, its measurement of its own main path on the
card.

Prints ONE JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline"}``: the edges/s of the aggregation (the hand-written SpMM
kernel of the chosen layout, with its escape edges) on the icosphere mesh,
against the scatter-add baseline on the same device, ``aggregate_segment``
(``index_add_``) on a float32 x over the COO graph. Then, on stderr, a
``# mesh`` comment line (the same call's device time under
``torch.profiler`` beside the chained reading) and a ``# train-step:`` line
with the extras: the unbatched EPD train step (latent 256, 4 process steps,
bf16, Adam at 1e-4) and, on the diag layouts, the fused windowed-attention
aggregation at the same level. ``--extra-out PATH`` also writes the extras
to ``PATH``; nothing is written otherwise.

The environment knobs are the reference's: ``GWEN_BENCH_LEVELS`` (7 ≈ 164k
nodes / 1.15M edges with self-loops), ``GWEN_BENCH_FEATURES`` (256),
``GWEN_BENCH_ITERS`` (50), ``GWEN_BENCH_KERNEL`` (``diag_packed``; also
``diag``, ``sliding``, ``sdense``, anything else blocked-ELL),
``GWEN_BENCH_DTYPE`` (``bf16``, else float32), ``GWEN_BENCH_WINDOW``
(384), ``GWEN_BENCH_BASELINE`` (1; 0 skips it: ``vs_baseline`` null),
``GWEN_BENCH_TRAIN`` (1) and ``GWEN_BENCH_ATTN`` (1).

Each time is :func:`gwen_tpu_torch.profiling.scan_timeit`'s: a chain of
calls, each on the previous one's output, read by the difference method.
The mesh is ordered and its layouts built on the host, in memory (the
reference caches its ordered mesh in the temporary directory; the port
keeps no such file, so no ordering from other code can stand in for its
own), and moved to the device once. Without CUDA the entry point
raises unless the caller asks for ``device="cpu"``, where every kernel runs
its plain version.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from gwen_tpu_torch.graph import (
    DiagWindowGraph,
    apply_order,
    build_graph,
    diag_transpose_tables,
    icosphere_edges,
    kd_patch_order,
    rcm_order,
    to_block_ell,
    to_diag_window,
    to_sliding_dense,
    to_windowed_dense,
)
from gwen_tpu_torch.ops import aggregate_segment
from gwen_tpu_torch.ops.attention import windowed_attention
from gwen_tpu_torch.ops.spmm_cuda import (
    spmm_block_ell,
    spmm_diag_window,
    spmm_sliding_dense,
    spmm_windowed_dense,
)
from gwen_tpu_torch.profiling import device_ms, scan_timeit
from gwen_tpu_torch.train import TrainState, make_optimizer

LATENT, PROCESS_STEPS, LR = 256, 4, 1e-4
DIAG_KERNELS = ("diag", "diag_packed")


def knobs() -> dict:
    """The reference's environment knobs, with its defaults."""
    env = os.environ.get
    return {"levels": int(env("GWEN_BENCH_LEVELS", "7")),
            "feats": int(env("GWEN_BENCH_FEATURES", "256")),
            "iters": int(env("GWEN_BENCH_ITERS", "50")),
            "kernel": env("GWEN_BENCH_KERNEL", "diag_packed"),
            "dtype": (torch.bfloat16 if env("GWEN_BENCH_DTYPE", "bf16") == "bf16"
                      else torch.float32),
            "window": int(env("GWEN_BENCH_WINDOW", "384")),
            "baseline": env("GWEN_BENCH_BASELINE", "1") == "1",
            "train": env("GWEN_BENCH_TRAIN", "1") == "1",
            "attn": env("GWEN_BENCH_ATTN", "1") == "1"}


def _build(levels: int, ordering: str = "rcm"):
    """The icosphere's COO graph (self-loops, GCN weights) under
    ``ordering`` (``kd`` patches for the diag layouts, else RCM), and its
    node count."""
    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n) if ordering == "kd" else rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    return build_graph(s, r, n), n


def aggregation_graph(g_coo, kernel: str, dtype: torch.dtype, window: int):
    """The layout ``kernel`` names and its aggregation: the diag window
    (packed on ``diag_packed``) with ``spmm_diag_window`` (B1 or packed B1,
    the escapes through B3), ``sliding`` with ``spmm_sliding_dense`` (B3),
    ``sdense`` with ``spmm_windowed_dense`` (B11), anything else blocked-ELL
    with ``spmm_block_ell`` (B12). On the host."""
    if kernel in DIAG_KERNELS:
        return (to_diag_window(g_coo, window_size=window, dtype=dtype,
                               packed=kernel == "diag_packed"), spmm_diag_window)
    if kernel == "sliding":
        return to_sliding_dense(g_coo, dtype=dtype), spmm_sliding_dense
    if kernel == "sdense":
        return to_windowed_dense(g_coo, dtype=dtype), spmm_windowed_dense
    return to_block_ell(g_coo), spmm_block_ell


def timed_input(graph, x: torch.Tensor) -> torch.Tensor:
    """The aggregation's chained input: on the diag layouts x pre-padded to
    ``num_padded_nodes`` rows, as the model keeps its chain (the same
    math); x itself on the others."""
    if not isinstance(graph, DiagWindowGraph):
        return x
    return torch.cat([x, x.new_zeros(graph.num_padded_nodes - x.shape[0],
                                     x.shape[1])])


def chain_s(agg, graph, x: torch.Tensor, iters: int) -> float:
    """Seconds per call of ``agg(graph, ·)`` chained on its own output
    (:func:`scan_timeit`), without autograd."""
    with torch.no_grad():
        return scan_timeit(lambda c, g: agg(g, c), x, graph, iters=iters)["mean_s"]


def epd_state(feats: int, device, compute_dtype: torch.dtype = torch.bfloat16,
              seed: int = 0) -> TrainState:
    """The bench's EPD model (``feats`` channels in and out, latent 256, 4
    process steps) with Adam at 1e-4, as a train state."""
    from gwen_tpu_torch.nn import EncodeProcessDecode

    model = EncodeProcessDecode(
        feats, feats, device=device, latent_size=LATENT,
        process_steps=PROCESS_STEPS, compute_dtype=compute_dtype,
        generator=torch.Generator().manual_seed(seed))
    return TrainState(model, make_optimizer(model.parameters(), LR))


def epd_loss(model, graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The bench's loss: the MSE of the prediction against ``y``."""
    return torch.mean((model(graph, x) - y) ** 2)


def train_step(state: TrainState, graph, x: torch.Tensor,
               y: torch.Tensor) -> TrainState:
    """One Adam step on :func:`epd_loss`; the state is the chain's carry."""
    epd_loss(state.model, graph, x, y).backward()
    state.optimizer.step(state.model.parameters())
    state.step += 1
    return state


def attention_aggregation(graph, x: torch.Tensor) -> torch.Tensor:
    """The fused windowed-attention aggregation the bench times: x as q, k
    and v on a graph with its transpose tables."""
    return windowed_attention(graph, x, x, x)


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bench: CUDA is not available; pass --device cpu to run the "
            "plain versions on the CPU")
    return dev


def _rounded(v: float, nd: int) -> Optional[float]:
    return round(v, nd) if v == v else None


def main(device: str = "cuda", extra_out: Optional[str] = None) -> None:
    """Run the bench and print its lines (see the module docstring)."""
    dev = resolve_device(device)
    k = knobs()
    levels, feats, iters, kernel, dtype = (k["levels"], k["feats"], k["iters"],
                                           k["kernel"], k["dtype"])
    g_host, n = _build(levels, "kd" if kernel in DIAG_KERNELS else "rcm")
    edges = g_host.num_edges  # includes self-loops
    x32 = torch.randn(n, feats, generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    x = x32.to(dtype)
    graph_host, agg = aggregation_graph(g_host, kernel, dtype, k["window"])
    graph, g_coo = graph_host.to(dev), g_host.to(dev)

    xb = timed_input(graph, x)
    t_agg = chain_s(agg, graph, xb, iters)
    eps_agg = edges / t_agg
    dev_ms = (device_ms(lambda: agg(graph, xb), iters=iters)
              if dev.type == "cuda" else math.nan)
    if k["baseline"]:
        t_seg = chain_s(aggregate_segment, g_coo, x32, max(iters // 4, 5))
    else:
        t_seg = math.nan
    eps_seg = edges / t_seg
    headline = {"metric": "spmm_edges_per_sec_per_chip",
                "value": round(eps_agg, 1), "unit": "edges/s",
                "vs_baseline": _rounded(eps_agg / eps_seg, 3)}
    print(json.dumps(headline), flush=True)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    dev_txt = (f"{dev_ms:.3f} ms device time under torch.profiler"
               if dev_ms == dev_ms else "device time not measured")
    print(f"# mesh L{levels}: {n} nodes, {edges} edges (incl self-loops), "
          f"F={feats}, kernel={kernel}, dtype={str(dtype).split('.')[-1]}; "
          f"kernel {t_agg * 1e3:.3f} ms/iter ({eps_agg / 1e9:.2f} Gedge/s; "
          f"{dev_txt}), index_add-segment-f32 {t_seg * 1e3:.3f} ms/iter "
          f"({eps_seg / 1e9:.2f} Gedge/s), device={name}",
          file=sys.stderr, flush=True)

    if not k["train"]:
        return
    state = epd_state(feats, dev)
    t_step = scan_timeit(train_step, state, graph, x, x * 0.9,
                         iters=max(iters // 4, 5))["mean_s"]
    extra = {
        "metric": "epd_train_step_ms",
        "level": levels, "nodes": n, "edges": edges,
        "latent": LATENT, "process_steps": PROCESS_STEPS, "kernel": kernel,
        "value": round(t_step * 1e3, 3), "unit": "ms",
        "train_edges_per_s": round(edges * PROCESS_STEPS * 3 / t_step, 1),
        "agg_ms": round(t_agg * 1e3, 3),
        "agg_edges_per_s": round(eps_agg, 1),
        "vs_segment_baseline": _rounded(eps_agg / eps_seg, 3),
        "backend": dev.type,
        "ts": time.time(),
    }
    del state
    if kernel in DIAG_KERNELS and k["attn"]:
        tg = diag_transpose_tables(graph_host).to(dev)
        t_attn = chain_s(attention_aggregation, tg, x, iters)
        extra["attn_agg_ms"] = round(t_attn * 1e3, 3)
        extra["attn_agg_edges_per_s"] = round(edges / t_attn, 1)
    if extra_out:
        Path(extra_out).write_text(json.dumps(extra) + "\n")
    print(f"# train-step: {json.dumps(extra)}", file=sys.stderr, flush=True)
