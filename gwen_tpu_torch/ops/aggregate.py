"""Sparse neighbourhood aggregation.

Counterpart of ``gwen_tpu.ops.aggregate`` for the containers the serving
path uses. Semantics for every backend::

    out[r, :] = sum over edges e with receivers[e] == r
                of weights[e] * x[senders[e], :]

* :func:`aggregate_segment` — gather + ``index_add_``: the baseline, any
  device.
* :func:`aggregate_diag_window_reference` and
  :func:`aggregate_sliding_dense_reference` — vectorised plain-torch
  versions of the windowed layouts (escapes through the ELL gather).
* ``backend="auto"`` on a windowed layout goes through
  :mod:`gwen_tpu_torch.ops.spmm_cuda` (the hand-written kernels on CUDA
  tensors, their plain versions on CPU tensors); ``backend="plain"`` takes
  the same composite through the kernels' plain versions on any device.
"""

from __future__ import annotations

import torch

from gwen_tpu_torch.graph.graph import DiagWindowGraph, Graph, SlidingDenseGraph
from gwen_tpu_torch.ops import spmm_cuda

Tensor = torch.Tensor


def aggregate_segment(graph: Graph, x: Tensor) -> Tensor:
    """Gather-scale-scatter with ``index_add_`` over the node axis."""
    if x.shape[-2] != graph.num_nodes:
        raise ValueError(
            f"x has {x.shape[-2]} node rows, graph has {graph.num_nodes} nodes"
        )
    xm = x.movedim(-2, 0)  # (N, ..., F)
    w = graph.weights.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    msgs = xm[graph.senders] * w
    out = torch.zeros_like(xm).index_add_(0, graph.receivers, msgs)
    return out.movedim(0, -2)


def _window_reference(graph, x: Tensor) -> Tensor:
    """Plain-torch reference of a windowed layout: per block,
    ``S_b @ x[ws_b : ws_b + W]``, all blocks in one batched product (rows
    past x read as zero), then the escape edges through the ELL gather and
    a scatter-add."""
    out_rows = spmm_cuda._check_rows(graph, x)
    n, f = x.shape
    nb, w = graph.num_blocks, graph.window_size
    src = graph.num_src_rows
    xp = x.new_zeros(src, f)
    rows = min(n, src)
    xp[:rows] = x[:rows]
    idx = graph.window_start.long()[:, None] + torch.arange(w, device=x.device)
    win = xp[idx]  # (nb, W, F)
    s = graph.s_mat.to(x.dtype).reshape(nb, graph.block_size, w)
    out = torch.bmm(s, win).reshape(nb * graph.block_size, f)[:out_rows]
    return spmm_cuda._sliding_escape_add(graph, x, out)


def aggregate_sliding_dense_reference(graph: SlidingDenseGraph,
                                      x: Tensor) -> Tensor:
    """Plain-torch reference for the banded layout, escapes included."""
    return _window_reference(graph, x)


def aggregate_diag_window_reference(graph: DiagWindowGraph,
                                    x: Tensor) -> Tensor:
    """Plain-torch reference for the diag-window layout. Escapes take the
    ELL gather whether or not the graph has an esc2 contraction (the same
    operator, another order of summation)."""
    return _window_reference(graph, x)


def aggregate(graph, x: Tensor, backend: str = "auto") -> Tensor:
    """Dispatch aggregation by graph container and backend: ``"auto"``
    runs the windowed kernels (on CUDA tensors), ``"plain"`` the same
    composite with the kernels' plain versions, anything else the plain
    references above."""
    if isinstance(graph, DiagWindowGraph):
        if backend in ("auto", "plain"):
            return spmm_cuda.spmm_diag_window(graph, x, plain=backend == "plain")
        return aggregate_diag_window_reference(graph, x)
    if isinstance(graph, SlidingDenseGraph):
        if backend in ("auto", "plain"):
            return spmm_cuda.spmm_sliding_dense(graph, x,
                                                plain=backend == "plain")
        return aggregate_sliding_dense_reference(graph, x)
    if isinstance(graph, Graph):
        return aggregate_segment(graph, x)
    raise TypeError(
        f"no aggregation for {type(graph).__name__} yet: the port's slice 1 "
        "covers Graph, DiagWindowGraph and SlidingDenseGraph; the other "
        "layouts (dense, block-ELL, block tiles, packed, halo) come with "
        "slices 5-7 (ROADMAP queue A)")
