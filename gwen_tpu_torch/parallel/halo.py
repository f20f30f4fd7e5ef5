"""Halo-exchange aggregation and attention over a partitioned mesh graph:
counterpart of ``gwen_tpu.parallel.halo`` on ``torch.distributed``.

Nodes are ordered for locality and split into contiguous, equal-size
partitions, one per rank of the *graph* process group. Every cross-partition
edge reaches at most ``halo`` rows into the two neighbouring partitions, so
one ring exchange per aggregation delivers all remote source rows.

:class:`HaloGraph` and :class:`HaloDiagGraph` are one rank's view: tables
whose source indices are relative to the halo-extended local array
``[left-halo | local | right-halo]``, and the process group the exchange
runs over (``None`` for a single partition: the halos are then zero rows
and nothing is sent). :func:`aggregate_halo` does the exchange and the
local product (the kernels of :mod:`gwen_tpu_torch.ops.spmm_cuda` on CUDA
tensors, their plain versions on CPU tensors), and
:func:`gwen_tpu_torch.ops.aggregate.aggregate` dispatches to it, so models
do not know they are partitioned.

Collectives run inside ``forward`` and ``backward`` of autograd Functions:
every rank of the group must reach them in the same order, so every rank
runs the same model on the same batch shape, and a backward pass is either
taken by all ranks or by none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from gwen_tpu_torch.graph.graph import (
    BlockEllGraph,
    DiagWindowGraph,
    SlidingDenseGraph,
    WindowedDenseGraph,
    _to,
)
from gwen_tpu_torch.ops import spmm_cuda

Tensor = torch.Tensor


@dataclass(frozen=True)
class HaloGraph:
    """One rank's partition in the blocked-ELL, windowed-dense or banded
    layout (built by :func:`gwen_tpu_torch.parallel.apply.local_graph` from
    the stacked tables of ``partition_graph``).

    ``s_mat`` is ``None`` for the blocked-ELL path (kernel B12). With
    ``sliding`` set it is the banded matrix ``(n_local, window_size)`` with
    monotone starts in ``window_start`` (kernels B3/B10); otherwise the
    windowed-dense matrix with the ELL tables' starts (kernel B11).
    """

    nbr: Tensor  # (n_local, D) int32, window-relative into ext space
    nbr_weight: Tensor  # (n_local, D) float32
    window_start: Tensor  # (n_local // block,) int32 into ext space
    group: Optional[dist.ProcessGroup]
    halo: int
    n_local: int
    block_size: int
    window_size: int
    num_edges: int
    s_mat: Optional[Tensor] = None
    sliding: bool = False

    @property
    def num_nodes(self) -> int:  # model-facing row count per rank
        return self.n_local

    @property
    def ext_rows(self) -> int:
        return self.n_local + 2 * self.halo

    def _layout(self, **kw) -> dict:
        return dict(window_start=self.window_start, num_nodes=self.n_local,
                    num_edges=self.num_edges, block_size=self.block_size,
                    num_src_rows=self.ext_rows, **kw)

    def local_block_ell(self) -> BlockEllGraph:
        return BlockEllGraph(**self._layout(
            nbr=self.nbr, nbr_weight=self.nbr_weight,
            window_size=self.window_size))

    def local_windowed_dense(self) -> WindowedDenseGraph:
        return WindowedDenseGraph(**self._layout(s_mat=self.s_mat))

    def local_sliding_dense(self) -> SlidingDenseGraph:
        return SlidingDenseGraph(**self._layout(
            s_mat=self.s_mat, window_size=self.window_size))

    def to(self, device) -> "HaloGraph":
        return _to(self, device)


@dataclass(frozen=True)
class HaloDiagGraph:
    """One rank's partition of the GLOBAL diag-window layout.

    ``local`` is the rank's slice as a :class:`DiagWindowGraph` over the
    halo-extended rows: S ``(n_local, W)``, window starts relative to the
    extended array, ``num_src_rows = ext_rows``; with transpose tables it
    carries the attention kernels' neighbour lists (sources as extended
    rows). Its ``escape`` holds only ``rows`` (the rank's escape receivers,
    local and sorted) and its ``esc_ptr`` their per-block ranges: the fix
    rows come from the *global* contraction, not from local edge lists.
    Each rank extracts its slice of the U boundary-skeleton rows
    (``loc_idx``), one ``all_gather`` over the graph group rebuilds the
    compacted x (``idx2``), the banded product on the replicated c2 graph
    ``esc2`` (kernels B3/B10) runs on every rank, and ``back_loc`` reads
    the rank's fix rows back in receiver order for B1/B4 to place.
    """

    local: DiagWindowGraph
    group: Optional[dist.ProcessGroup]
    halo: int
    n_local: int
    loc_idx: Optional[Tensor] = None  # (U_pp,) int64 local rows to extract
    back_loc: Optional[Tensor] = None  # (k,) int64 c2 row per local fix row
    idx2: Optional[Tensor] = None  # (U,) int64 gathered-layout row per c2 row
    esc2: Optional[SlidingDenseGraph] = None

    @property
    def num_nodes(self) -> int:
        return self.n_local

    @property
    def ext_rows(self) -> int:
        return self.n_local + 2 * self.halo

    @property
    def block_size(self) -> int:
        return self.local.block_size

    @property
    def window_size(self) -> int:
        return self.local.window_size

    @property
    def t_max(self) -> int:
        return self.local.t_max

    def to(self, device) -> "HaloDiagGraph":
        return _to(self, device)


# ------------------------------------------------------------ halo exchange


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _ring(group) -> tuple[int, int]:
    """Global ranks of this rank's left and right neighbours in ``group``."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    return (dist.get_global_rank(group, (me - 1) % n),
            dist.get_global_rank(group, (me + 1) % n))


def _swap(to_left: Tensor, to_right: Tensor, group) -> tuple[Tensor, Tensor]:
    """Send ``to_left`` to the left neighbour and ``to_right`` to the right
    one; return what the left and the right neighbour sent here. The tags
    keep the two directions apart where both neighbours are one rank."""
    left, right = _ring(group)
    to_left, to_right = to_left.contiguous(), to_right.contiguous()
    from_left, from_right = torch.empty_like(to_right), torch.empty_like(to_left)
    ops = [dist.P2POp(dist.isend, to_right, right, group, tag=0),
           dist.P2POp(dist.isend, to_left, left, group, tag=1),
           dist.P2POp(dist.irecv, from_left, left, group, tag=0),
           dist.P2POp(dist.irecv, from_right, right, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def _exchange(x: Tensor, halo: int, group) -> Tensor:
    """``[left-halo | x | right-halo]`` along the node axis (-2): the left
    neighbour's last ``halo`` rows and the right neighbour's first. One
    partition (or ``halo == 0``): zero halos, nothing sent."""
    if halo == 0 or _world(group) == 1:
        pad = x.new_zeros(*x.shape[:-2], halo, x.shape[-1])
        return torch.cat([pad, x, pad], dim=-2)
    from_left, from_right = _swap(x[..., :halo, :], x[..., -halo:, :], group)
    return torch.cat([from_left, x, from_right], dim=-2)


class _HaloExchange(torch.autograd.Function):
    """The ring exchange with its adjoint: the cotangents of the halo rows
    go back to the ranks that own them and add to theirs."""

    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        return _exchange(x, halo, group)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        # My left halo is the left neighbour's last rows, my right halo the
        # right neighbour's first: each side gets its cotangent back.
        from_left, from_right = _swap(g[..., :h, :], g[..., -h:, :], ctx.group)
        gx = g[..., h:-h, :].clone()
        gx[..., :h, :] += from_left
        gx[..., -h:, :] += from_right
        return gx, None, None


def halo_exchange(x: Tensor, halo: int, group=None) -> Tensor:
    """Bidirectional ring exchange of boundary rows over ``group``; returns
    ``[left-halo | x | right-halo]`` along the node axis (-2).
    Differentiable: the backward sends the halo cotangents back to their
    owners (a collective too, which every rank of the group must reach).
    The ring wraps, so the first and last partitions receive rows that no
    edge references."""
    if halo == 0 or _world(group) == 1:
        return _exchange(x, halo, group)
    return _HaloExchange.apply(x, halo, group)


# ------------------------------------------------------------ aggregation


def _gather_rows(x: Tensor, group) -> Tensor:
    """``all_gather`` over ``group``, concatenated along the node axis."""
    if _world(group) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_world(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-2)


def _diag_halo_fix(graph: HaloDiagGraph, x: Tensor, plain: bool) -> Optional[Tensor]:
    """Escape fix rows of this rank's receivers, in receiver order: extract
    the local boundary-skeleton rows, ``all_gather`` over the graph group,
    the banded c2 contraction (replicated), gather this rank's slice back.
    Every rank of a graph with escapes takes part, whether or not it holds
    a receiver."""
    if graph.esc2 is None:
        return None
    xc_all = _gather_rows(x.index_select(-2, graph.loc_idx), graph.group)
    xc2 = xc_all.index_select(-2, graph.idx2)
    if plain:
        b3 = spmm_cuda.sliding_spmm_plain
    else:
        b3 = spmm_cuda.sliding_spmm_b if x.dim() == 3 else spmm_cuda.sliding_spmm
    if graph.back_loc.numel() == 0:
        return None
    return b3(graph.esc2, xc2).index_select(-2, graph.back_loc).contiguous()


def _aggregate_halo_impl(graph, x: Tensor, plain: bool) -> Tensor:
    """Exchange, local product, local rows. ``x`` is ``(n_local, F)`` or
    ``(B, n_local, F)`` as the kernels take it."""
    x_ext = _exchange(x, graph.halo, graph.group)
    batched = x.dim() == 3
    if isinstance(graph, HaloDiagGraph):
        fix = _diag_halo_fix(graph, x, plain)
        if plain:
            b1 = spmm_cuda.diag_window_spmm_plain
        else:
            b1 = spmm_cuda.diag_window_spmm_b if batched else spmm_cuda.diag_window_spmm
        out = b1(graph.local, x_ext, fix)
    elif graph.sliding:
        if plain:
            b3 = spmm_cuda.sliding_spmm_plain
        else:
            b3 = spmm_cuda.sliding_spmm_b if batched else spmm_cuda.sliding_spmm
        out = b3(graph.local_sliding_dense(), x_ext)
    elif graph.s_mat is not None:
        b11 = (spmm_cuda.windowed_dense_spmm_plain if plain
               else spmm_cuda.windowed_dense_spmm)
        out = b11(graph.local_windowed_dense(), x_ext)
    else:
        b12 = spmm_cuda.block_ell_spmm_plain if plain else spmm_cuda.block_ell_spmm
        out = b12(graph.local_block_ell(), x_ext)
    return out[..., : graph.n_local, :]


class _HaloAggregation(torch.autograd.Function):
    """The composite (exchange, local product, crop) is, globally,
    multiplication by the padded normalized adjacency, which is symmetric
    for the undirected GCN-normalized graphs this package builds: its
    x-gradient is the same halo aggregation on the cotangent. The backward
    lives here, on the composite, because the local scatter matrix is
    ``(n_local × ext_rows)``, not square: the kernels' own symmetric
    backward holds only for square operators."""

    @staticmethod
    def forward(ctx, x, graph, plain):
        ctx.graph, ctx.plain = graph, plain
        return _aggregate_halo_impl(graph, x, plain)

    @staticmethod
    def backward(ctx, g):
        return _aggregate_halo_impl(ctx.graph, g.contiguous(), ctx.plain), None, None


def aggregate_halo(graph, x: Tensor, backend: str = "auto") -> Tensor:
    """Exchange halos, aggregate locally, return the local rows, on
    ``(..., n_local, F)`` with any leading axes and any F. ``backend``
    ``"auto"`` runs the kernels (on CUDA tensors), anything else their plain
    versions on the same path. Differentiable in x through one Function
    whose forward and backward each run the same collectives."""
    if x.shape[-2] != graph.n_local:
        raise ValueError(f"x has {x.shape[-2]} rows, partition has {graph.n_local}")
    xf, lead, f = spmm_cuda._fold(x)
    out = _HaloAggregation.apply(xf, graph, backend != "auto")
    return spmm_cuda._unfold(out, lead, f)


# ------------------------------------------------------------ attention


def attend_halo(graph: HaloDiagGraph, q: Tensor, k: Tensor, v: Tensor, *,
                scale: Optional[float] = None, backend: str = "auto",
                pack: bool = False) -> Tensor:
    """Windowed attention over a partitioned diag layout.

    Each destination's in-window neighbourhood lies inside the
    halo-extended local array (halo = window), so partitioned attention is
    two ring exchanges (K, V) and the local attention kernels (B5; backward
    B6, B7) on the extended K/V with the partition's transpose tables and
    neighbour lists. There is no escape term: windowed attention excludes
    out-of-window edges by definition, as on the global layout. The
    kernels' backward gives dK and dV on the extended rows and the
    exchange's backward routes the halo cotangents to their owners.

    ``pack=True`` (two 64-lane sub-heads in a 128-wide item) needs ``f =
    128`` and an explicit scale.
    """
    from gwen_tpu_torch.ops.attention import windowed_attention

    if q.shape[-2] != graph.n_local:
        raise ValueError(
            f"q has {q.shape[-2]} rows, partition has {graph.n_local}")
    if pack and q.shape[-1] != 128:
        raise ValueError(
            f"pack=True expects lane-packed (..., N, 128) q/k/v with two "
            f"sub-heads at lanes [0, 64) and [64, 128); got f={q.shape[-1]}")
    if pack and scale is None:
        raise ValueError("pack=True needs an explicit scale "
                         "(1/sqrt(dh) of the true head width)")
    if graph.t_max == 0:
        raise ValueError(
            "attend_halo needs transpose tables: build the rank's graph with "
            "local_graph(..., transpose_tables=True)")
    k_ext = halo_exchange(k, graph.halo, graph.group)
    v_ext = halo_exchange(v, graph.halo, graph.group)
    return windowed_attention(graph.local, q, k_ext, v_ext, scale=scale,
                              backend=backend, pack=pack)

