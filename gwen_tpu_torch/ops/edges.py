"""The two operators of message passing on COO edges, each with its own
backward: :func:`gather_join` gathers the sender and receiver rows of
every edge and joins them to the edge's latent, and :func:`edge_sum` sums
the edges into their receivers. Both take the edges and their segment
tables from a :class:`~gwen_tpu_torch.graph.graphcast.BipartiteGraph`.

Both sums (:func:`edge_sum`'s forward, :func:`gather_join`'s backward)
are :func:`segment_sum`: each receiver's contiguous span of the
receiver-sorted edges (``receiver_offsets``), or each sender's span of
the stable sender-sorted permutation (``sender_order``,
``sender_offsets``), summed in float32 in edge order and returned in the
operand's type. On a CUDA tensor that is one launch of the hand-written
kernel of ``csrc/edge_sum.cu``, which reads the operand in place (the
join's cotangent is read as two slices), with no atomics, so the sums
repeat bit for bit; on a CPU tensor it is the plain version
(:func:`segment_sum_plain`). There is no fallback. Under a profiler the
operators are the spans ``gwen.op.gather`` and ``gwen.op.edge_sum``,
their backward ``gwen.op.gather.bwd`` and ``gwen.op.edge_sum.bwd``.

Leading axes before the node or edge axis (``-2``) are batch axes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gwen_tpu_torch.graph.graphcast import BipartiteGraph
from gwen_tpu_torch.ops import cuda_lib
from gwen_tpu_torch.ops.cuda_lib import DTYPE_CODE, INT, LONG, PTR, CudaLib
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor

# (src, offsets, order, out, row_stride, batch_stride, num_rows, num_edges,
#  f, batch, dtype, stream)
LIB = CudaLib("edge_sum.cu",
              gwen_segment_sum=[PTR] * 4 + [LONG, LONG, INT, LONG, INT, INT, INT, PTR])


def segment_sum_plain(src: Tensor, offsets: Tensor,
                      order: Optional[Tensor] = None) -> Tensor:
    """Plain version of :func:`segment_sum`: ``index_add_`` of the edges,
    in ``order``, into a zeroed float32 buffer by segment, cast once."""
    rows = offsets.shape[0] - 1
    segment = torch.repeat_interleave(torch.arange(rows, device=src.device),
                                      (offsets[1:] - offsets[:-1]).long())
    edges = src if order is None else src.index_select(-2, order)
    out = src.new_zeros(*src.shape[:-2], rows, src.shape[-1], dtype=torch.float32)
    return out.index_add_(-2, segment, edges.float()).to(src.dtype)


def segment_sum(src: Tensor, offsets: Tensor, order: Optional[Tensor] = None) -> Tensor:
    """``(..., rows, F)`` in ``src``'s type: row ``r`` is the float32 sum of
    the edge rows ``src[..., order[j], :]`` (``order`` absent: ``j``) over
    ``j`` in ``offsets[r]:offsets[r + 1]``, for ``src`` ``(..., E, F)`` and
    the int32 tables ``offsets`` ``(rows + 1,)`` and ``order`` ``(E,)``.
    ``src`` may be a slice of a wider tensor: its last axis must be
    contiguous. Launches are counted in ``segment_sum.launches``."""
    if not cuda_lib.on_cuda(src, "segment sum"):
        return segment_sum_plain(src, offsets, order)
    if src.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_sum takes float32 or bfloat16, not {src.dtype}")
    tables = (offsets,) if order is None else (offsets, order)
    for t in tables:
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != src.device):
            raise ValueError(f"segment tables must be contiguous 1-d int32 on {src.device}")
    if src.dim() < 2 or src.stride(-1) != 1 or (order is not None
                                               and order.shape[0] != src.shape[-2]):
        raise ValueError(f"src {tuple(src.shape)} with strides {src.stride()} does not "
                         "fit: (..., E, F), the last axis contiguous, E the order's length")
    rows, (edges, f) = offsets.shape[0] - 1, src.shape[-2:]
    # A view for a slice with one leading axis or none.
    flat = src.reshape(math.prod(src.shape[:-2]), edges, f)
    out = torch.empty(*src.shape[:-2], rows, f, dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    rc = LIB().gwen_segment_sum(
        flat.data_ptr(), offsets.data_ptr(), None if order is None else order.data_ptr(),
        out.data_ptr(), flat.stride(1), flat.stride(0), rows, edges, f, flat.shape[0],
        DTYPE_CODE[src.dtype], torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("segment sum", rc)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


class _EdgeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e: Tensor, graph: BipartiteGraph) -> Tensor:
        ctx.graph = graph
        return segment_sum(e, graph.receiver_offsets)

    @staticmethod
    def backward(ctx, g: Tensor):
        with annotate("gwen.op.edge_sum.bwd"):
            return g.index_select(-2, ctx.graph.receivers), None


def edge_sum(e: Tensor, graph: BipartiteGraph) -> Tensor:
    """``(..., num_receivers, F)``: each receiver's sum over its edges of
    ``e`` ``(..., E, F)``, accumulated in float32."""
    with annotate("gwen.op.edge_sum"):
        return _EdgeSum.apply(e, graph)


class _GatherJoin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e: Tensor, xs: Tensor, xr: Tensor, graph: BipartiteGraph) -> Tensor:
        ctx.graph = graph
        ctx.widths = e.shape[-1], xs.shape[-1]
        return torch.cat([e, xs.index_select(-2, graph.senders),
                          xr.index_select(-2, graph.receivers)], dim=-1)

    @staticmethod
    def backward(ctx, g: Tensor):
        with annotate("gwen.op.gather.bwd"):
            graph, (fe, fs) = ctx.graph, ctx.widths
            need_e, need_s, need_r, _ = ctx.needs_input_grad
            de = g[..., :fe] if need_e else None
            ds = (segment_sum(g[..., fe:fe + fs], graph.sender_offsets, graph.sender_order)
                  if need_s else None)
            dr = segment_sum(g[..., fe + fs:], graph.receiver_offsets) if need_r else None
            return de, ds, dr, None


def gather_join(e: Tensor, xs: Tensor, xr: Tensor, graph: BipartiteGraph) -> Tensor:
    """``[e, xs[senders], xr[receivers]]`` joined on the feature axis:
    ``(..., E, Fe + Fs + Fr)`` from the edge latent ``e`` ``(..., E, Fe)``
    and the sender and receiver node sets ``(..., Ns, Fs)``,
    ``(..., Nr, Fr)`` (the same tensor on a square graph)."""
    with annotate("gwen.op.gather"):
        return _GatherJoin.apply(e, xs, xr, graph)
