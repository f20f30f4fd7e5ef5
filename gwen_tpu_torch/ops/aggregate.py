"""Sparse neighbourhood aggregation.

Counterpart of ``gwen_tpu.ops.aggregate``, for every container it takes.
Semantics for every backend::

    out[r, :] = sum over edges e with receivers[e] == r
                of weights[e] * x[senders[e], :]

* :func:`aggregate_segment` — gather + ``index_add_``: the baseline, any
  device.
* :func:`aggregate_dense` — ``adj @ x`` for the dense adjacency of a small
  graph (the member graph): a plain matrix product, outside any kernel, as
  in the reference.
* :func:`aggregate_diag_window_reference`,
  :func:`aggregate_sliding_dense_reference` and
  :func:`aggregate_sliding_packed_reference` — vectorised plain-torch
  versions of the windowed layouts (escapes through the ELL gather; the
  packed layouts with their rank-1 scales outside the product, as the
  reference's plain versions).
* :func:`aggregate_windowed_dense_reference` and
  :func:`aggregate_block_ell_reference` — the same for the windowed-dense
  and blocked-ELL layouts (no escapes; the source array may be longer than
  the output, as on a partition's halo-extended rows), and
  :func:`aggregate_block_tiles_reference` for the block-tile layout.
* A :class:`~gwen_tpu_torch.graph.graph.MultiLevelGraph` sums its
  subgraphs' aggregations, each dispatched on its own container; a
  :class:`~gwen_tpu_torch.graph.graph.SlidingRank1Graph` is ``a ⊙ K(a ⊙
  x)`` with K the banded product on its int8 S01.
* A :class:`~gwen_tpu_torch.parallel.halo.HaloGraph` or ``HaloDiagGraph``
  (one rank's partition) goes to
  :func:`~gwen_tpu_torch.parallel.halo.aggregate_halo`.
* ``backend="auto"`` on a windowed layout goes through
  :mod:`gwen_tpu_torch.ops.spmm_cuda` (the hand-written kernels on CUDA
  tensors, their plain versions on CPU tensors); ``backend="plain"`` takes
  the same composite through the kernels' plain versions on any device.
"""

from __future__ import annotations

import torch

from gwen_tpu_torch.graph.graph import (
    BlockEllGraph,
    BlockTileGraph,
    DenseGraph,
    DiagWindowGraph,
    Graph,
    MultiLevelGraph,
    SlidingDenseGraph,
    SlidingPackedGraph,
    SlidingRank1Graph,
    WindowedDenseGraph,
    window_mask,
)
from gwen_tpu_torch.ops import spmm_cuda
from gwen_tpu_torch.ops.cuda_lib import fit_rows
from gwen_tpu_torch.profiling import annotate

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


def aggregate_dense(graph: DenseGraph, x: Tensor) -> Tensor:
    """Dense normalized-adjacency product, ``(N, N) @ (..., N, F)``."""
    return torch.matmul(graph.adj.to(x.dtype), x)


def _window_product(graph, x: Tensor, s_mat: Tensor) -> Tensor:
    """Per block, ``S_b @ x[ws_b : ws_b + W]``, all blocks in one batched
    product (rows past x read as zero), cut to the output rows."""
    out_rows = spmm_cuda._check_rows(graph, x)
    lead, (n, f) = x.shape[:-2], x.shape[-2:]
    nb, w = graph.num_blocks, graph.window_size
    src = graph.num_src_rows
    xp = x.new_zeros(*lead, src, f)
    rows = min(n, src)
    xp[..., :rows, :] = x[..., :rows, :]
    idx = graph.window_start.long()[:, None] + torch.arange(w, device=x.device)
    win = xp[..., idx, :]  # (..., nb, W, F)
    s = s_mat.to(x.dtype).reshape(nb, graph.block_size, w)
    out = torch.matmul(s, win).reshape(*lead, nb * graph.block_size, f)
    return out[..., :out_rows, :]


def _rank1_reference(graph, x: Tensor, col: Tensor, row: Tensor) -> Tensor:
    """The packed layouts as the reference's plain versions compute them:
    ``row ⊙ (S01 (col ⊙ x) + escapes)``, each scale rounded to x's type
    and each product rounded in it; the escape tables carry ``a_s``."""
    xs = x * col[: x.shape[-2]].to(x.dtype)[:, None]
    out = _window_product(graph, xs, window_mask(graph))
    out = spmm_cuda._sliding_escape_add(graph, x, out)
    return out * row[: out.shape[-2]].to(out.dtype)[:, None]


def aggregate_sliding_dense_reference(graph: SlidingDenseGraph,
                                      x: Tensor) -> Tensor:
    """Plain-torch reference for the banded layout, escapes included
    (through the ELL gather and a scatter-add)."""
    return spmm_cuda._sliding_escape_add(
        graph, x, _window_product(graph, x, graph.s_mat))


def aggregate_sliding_packed_reference(graph: SlidingPackedGraph,
                                       x: Tensor) -> Tensor:
    """Plain-torch reference for the bit-packed banded layout:
    ``a ⊙ S01·(a ⊙ x)`` with the scales outside, as the reference's
    ``spmm_sliding_packed``."""
    return _rank1_reference(graph, x, graph.col_scale, graph.row_scale)


def aggregate_diag_window_reference(graph: DiagWindowGraph,
                                    x: Tensor) -> Tensor:
    """Plain-torch reference for the diag-window layout, weighted or
    packed. Escapes take the ELL gather whether or not the graph has an
    esc2 contraction (the same operator, another order of summation)."""
    if graph.s_pack is not None:
        return _rank1_reference(graph, x, graph.r1_col, graph.r1_row)
    return spmm_cuda._sliding_escape_add(
        graph, x, _window_product(graph, x, graph.s_mat))


def aggregate_windowed_dense_reference(graph: WindowedDenseGraph,
                                       x: Tensor) -> Tensor:
    """Plain-torch reference for the windowed-dense layout: every block's
    tile product in one batched matmul, in x's type."""
    n_pad = graph.num_padded_nodes
    out = _window_product(graph, _pad_src(graph, x), graph.s_mat)
    return out[..., :x.shape[-2] if graph.num_src_rows == n_pad else n_pad, :]


def aggregate_block_ell_reference(graph: BlockEllGraph, x: Tensor) -> Tensor:
    """Plain-torch reference for the blocked-ELL layout: gather every slot's
    source row and contract with the weights, in x's type."""
    n_pad = graph.num_padded_nodes
    xp = _pad_src(graph, x)
    idx = (graph.nbr.long() + graph.window_start.long().repeat_interleave(
        graph.block_size)[:, None])
    out = torch.einsum("nd,...ndf->...nf", graph.nbr_weight.to(x.dtype),
                       xp[..., idx, :])
    return out[..., :x.shape[-2] if graph.num_src_rows == n_pad else n_pad, :]


def aggregate_block_tiles_reference(graph: BlockTileGraph, x: Tensor) -> Tensor:
    """Plain-torch reference for the block-tile layout: the absolute source
    row of every slot (its tile's base plus the within-tile index), one
    gather and a contraction with the weights, in x's type. Slots of
    inactive tiles carry weight 0."""
    n_pad, block = graph.num_padded_nodes, graph.block_size
    xp = _pad_src(graph, x)
    flat = graph.tnbr.shape[1]
    slot_tile = torch.arange(flat, device=x.device) // graph.tile_degree
    blk = torch.arange(n_pad, device=x.device) // block
    idx = (graph.tile_idx.long()[blk[:, None], slot_tile[None, :]] * block
           + graph.tnbr.long())
    out = torch.einsum("nk,...nkf->...nf", graph.tw.to(x.dtype),
                       xp[..., idx, :])
    return out[..., :x.shape[-2] if graph.num_src_rows == n_pad else n_pad, :]


def aggregate_sliding_rank1_reference(graph: SlidingRank1Graph,
                                      x: Tensor) -> Tensor:
    """Plain-torch reference for the int8 rank-1 banded layout: ``a ⊙
    S01·(a ⊙ x)`` with the scales outside the banded product."""
    xs = x * graph.col_scale[: x.shape[-2], None].to(x.dtype)
    out = aggregate_sliding_dense_reference(graph.core, xs)
    return out * graph.row_scale[: out.shape[-2], None].to(out.dtype)


def _pad_src(graph, x: Tensor) -> Tensor:
    """x zero-padded to the layout's source rows (after the row check)."""
    spmm_cuda._check_rows(graph, x)
    return fit_rows(x, graph.num_src_rows)


def aggregate(graph, x: Tensor, backend: str = "auto") -> Tensor:
    """Dispatch aggregation by graph container and backend: ``"auto"``
    runs the windowed kernels (on CUDA tensors), ``"plain"`` the same
    composite with the kernels' plain versions, anything else the plain
    references above. One span ``gwen.op.aggregate`` under a profiler,
    whatever the container holds."""
    with annotate("gwen.op.aggregate"):
        return _dispatch(graph, x, backend)


def _dispatch(graph, x: Tensor, backend: str) -> Tensor:
    # Late import: the halo composite runs this module's layouts locally.
    from gwen_tpu_torch.parallel.halo import HaloDiagGraph, HaloGraph, aggregate_halo

    plain = backend == "plain"
    kernels = backend in ("auto", "plain")
    if isinstance(graph, MultiLevelGraph):
        out = _dispatch(graph.subgraphs[0], x, backend)
        for sub in graph.subgraphs[1:]:
            out = out + _dispatch(sub, x, backend)
        return out
    if isinstance(graph, DenseGraph):
        return aggregate_dense(graph, x)
    if isinstance(graph, (HaloGraph, HaloDiagGraph)):
        return aggregate_halo(graph, x, backend=backend)
    if isinstance(graph, WindowedDenseGraph):
        if kernels:
            return spmm_cuda.spmm_windowed_dense(graph, x, plain=plain)
        return aggregate_windowed_dense_reference(graph, x)
    if isinstance(graph, BlockEllGraph):
        if kernels:
            return spmm_cuda.spmm_block_ell(graph, x, plain=plain)
        return aggregate_block_ell_reference(graph, x)
    if isinstance(graph, DiagWindowGraph):
        if kernels:
            return spmm_cuda.spmm_diag_window(graph, x, plain=plain)
        return aggregate_diag_window_reference(graph, x)
    if isinstance(graph, SlidingRank1Graph):
        if kernels:
            return spmm_cuda.spmm_sliding_rank1(graph, x, plain=plain)
        return aggregate_sliding_rank1_reference(graph, x)
    if isinstance(graph, SlidingDenseGraph):
        if kernels:
            return spmm_cuda.spmm_sliding_dense(graph, x, plain=plain)
        return aggregate_sliding_dense_reference(graph, x)
    if isinstance(graph, SlidingPackedGraph):
        if kernels:
            return spmm_cuda.spmm_sliding_packed(graph, x, plain=plain)
        return aggregate_sliding_packed_reference(graph, x)
    if isinstance(graph, BlockTileGraph):
        if kernels:
            return spmm_cuda.spmm_block_tiles(graph, x, plain=plain)
        return aggregate_block_tiles_reference(graph, x)
    if isinstance(graph, Graph):
        return aggregate_segment(graph, x)
    raise TypeError(f"no aggregation for graph type {type(graph).__name__}")
