"""The two operators of message passing on COO edges, each with its own
backward: :func:`gather_join` gathers the sender and receiver rows of
every edge and joins them to the edge's latent, and :func:`edge_sum` sums
the edges into their receivers.

Both sums (:func:`edge_sum`'s forward, :func:`gather_join`'s backward)
accumulate in float32, ``CHUNK_EDGES`` edges a pass (``index_add_`` into a
float32 buffer; a pass's float32 copy of the edges is its only
temporary), and return the operand's dtype. Under a profiler the
operators are the spans ``gwen.op.gather`` and ``gwen.op.edge_sum``, their
backward ``gwen.op.gather.bwd`` and ``gwen.op.edge_sum.bwd``.

Leading axes before the node or edge axis (``-2``) are batch axes.
"""

from __future__ import annotations

import torch

from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor
CHUNK_EDGES = 1 << 18


def _sum_into(src: Tensor, index: Tensor, num_rows: int) -> Tensor:
    """float32 ``out[..., index[e], :] += src[..., e, :]`` over ``num_rows``
    rows."""
    out = src.new_zeros(*src.shape[:-2], num_rows, src.shape[-1], dtype=torch.float32)
    for lo in range(0, index.shape[0], CHUNK_EDGES):
        hi = lo + CHUNK_EDGES
        out.index_add_(-2, index[lo:hi], src[..., lo:hi, :].float())
    return out


class _EdgeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e: Tensor, receivers: Tensor, num_rows: int) -> Tensor:
        ctx.save_for_backward(receivers)
        return _sum_into(e, receivers, num_rows).to(e.dtype)

    @staticmethod
    def backward(ctx, g: Tensor):
        with annotate("gwen.op.edge_sum.bwd"):
            (receivers,) = ctx.saved_tensors
            return g.index_select(-2, receivers), None, None


def edge_sum(e: Tensor, receivers: Tensor, num_rows: int) -> Tensor:
    """``(..., num_rows, F)``: each receiver's sum over its edges of
    ``e`` ``(..., E, F)``, accumulated in float32."""
    with annotate("gwen.op.edge_sum"):
        return _EdgeSum.apply(e, receivers, num_rows)


class _GatherJoin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e: Tensor, xs: Tensor, senders: Tensor, xr: Tensor,
                receivers: Tensor) -> Tensor:
        ctx.save_for_backward(senders, receivers)
        ctx.shapes = e.shape[-1], xs.shape[-2], xs.shape[-1], xr.shape[-2]
        return torch.cat([e, xs.index_select(-2, senders),
                          xr.index_select(-2, receivers)], dim=-1)

    @staticmethod
    def backward(ctx, g: Tensor):
        with annotate("gwen.op.gather.bwd"):
            senders, receivers = ctx.saved_tensors
            fe, ns, fs, nr = ctx.shapes
            need_e, need_s, _, need_r, _ = ctx.needs_input_grad
            de = g[..., :fe] if need_e else None
            ds = (_sum_into(g[..., fe:fe + fs], senders, ns).to(g.dtype)
                  if need_s else None)
            dr = (_sum_into(g[..., fe + fs:], receivers, nr).to(g.dtype)
                  if need_r else None)
            return de, ds, None, dr, None


def gather_join(e: Tensor, xs: Tensor, senders: Tensor, xr: Tensor,
                receivers: Tensor) -> Tensor:
    """``[e, xs[senders], xr[receivers]]`` joined on the feature axis:
    ``(..., E, Fe + Fs + Fr)`` from the edge latent ``e`` ``(..., E, Fe)``
    and the sender and receiver node sets ``(..., Ns, Fs)``,
    ``(..., Nr, Fr)`` (the same tensor on a square graph)."""
    with annotate("gwen.op.gather"):
        return _GatherJoin.apply(e, xs, senders, xr, receivers)
