"""GraphCast (Lam et al. 2023, arXiv:2212.12794): an encoder from the
latitude-longitude grid to the multimesh, a processor of interaction
layers that carry latents on the mesh's edges, and a decoder back to the
grid, on the graphs of :mod:`gwen_tpu_torch.graph.graphcast`.

Every MLP is Linear → SiLU → Linear → LayerNorm, its hidden and output
width the latent width ``L``:

* embed: the grid nodes' ``channels_in`` inputs, the mesh nodes' 3
  features and each graph's 4 edge features, five MLPs;
* grid2mesh: each edge ``e′ = MLP([e, vG_s, vM_r])``; each mesh node
  ``vM ← vM + MLP([vM, Σ e′])``; each grid node ``vG ← vG + MLP(vG)``;
* ``process_steps`` processor layers on the multimesh, weights not
  shared: each edge ``e ← e + MLP([e, vM_s, vM_r])``, then each mesh node
  ``vM ← vM + MLP([vM, Σ e])`` over the new ``e``;
* mesh2grid: each edge ``e′ = MLP([e, vM_s, vG_r])``; each grid node
  ``vG ← vG + MLP([vG, Σ e′])``;
* output: Linear → SiLU → Linear, ``L → L → channels_out``, no LayerNorm.

The gathers and the sums over each receiver's edges are
:func:`~gwen_tpu_torch.ops.edges.gather_join` and
:func:`~gwen_tpu_torch.ops.edges.edge_sum` (float32 accumulation, one
segment-sum kernel a sum on the card); each
product is :func:`core.linear`; a LayerNorm with its residual is the
fused kernel (:func:`fused_residual_layernorm`), one without is
``F.layer_norm`` on the compute dtype. Parameters are float32, cast to
``compute_dtype`` where used.

``remat`` (:func:`~gwen_tpu_torch.nn.gnn.parse_block_remat`) names the
blocks that keep only their inputs and are recomputed in the backward:
``g2m`` (grid2mesh with its edge embedding), ``mesh`` (each processor
layer), ``m2g`` (mesh2grid with its edge embedding). A recomputed block
runs its backward inside its spans.

Under a profiler a forward opens ``gwen.encoder`` (the embedders and
grid2mesh, which is ``gwen.graphcast.grid2mesh``), one ``gwen.process``
a processor layer and ``gwen.decoder`` (mesh2grid, which is
``gwen.graphcast.mesh2grid``, and the output). :data:`calls` counts the
gather and edge-sum calls by block, recomputed calls apart.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gwen_tpu_torch.graph.graphcast import (
    BipartiteGraph,
    GraphCastGraphs,
    build_graphcast_graphs,
)
from gwen_tpu_torch.nn import core
from gwen_tpu_torch.nn.gnn import parse_block_remat
from gwen_tpu_torch.ops.edges import edge_sum, gather_join
from gwen_tpu_torch.ops.fused_ln import fused_residual_layernorm
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor
BLOCKS = ("g2m", "mesh", "m2g")
LN_EPS = 1e-6

#: ``"<block>.<gather|edge_sum>"`` calls, and ``"….recomputed"`` for those
#: made again in a backward.
calls: dict[str, int] = {}
_recomputing = [False]


def _count(block: str, op: str) -> None:
    key = f"{block}.{op}" + (".recomputed" if _recomputing[0] else "")
    calls[key] = calls.get(key, 0) + 1


def mlp_init(d_in: int, latent: int, generator: torch.Generator, device
             ) -> nn.ModuleDict:
    """``{"mlp": {layer_0, layer_1}, "norm"}``: ``d_in → L → L`` and the
    LayerNorm."""
    return nn.ModuleDict({"mlp": core.mlp_init([d_in, latent, latent], generator, device),
                          "norm": core.layer_norm_init(latent, device)})


def layer_norm(params, h: Tensor) -> Tensor:
    """LayerNorm over the last axis in ``h.dtype`` with float32 statistics,
    the scale and offset cast to ``h.dtype``."""
    with annotate("gwen.op.layer_norm"):
        return F.layer_norm(h, (h.shape[-1],), params["scale"].to(h.dtype),
                            params["bias"].to(h.dtype), LN_EPS)


def mlp_apply(params, x: Tensor, residual: Optional[Tensor] = None) -> Tensor:
    """Linear → SiLU → Linear → LayerNorm, plus ``residual`` if given."""
    h = core.mlp_apply(params["mlp"], x, activation=F.silu)
    if residual is None:
        return layer_norm(params["norm"], h)
    return fused_residual_layernorm(params["norm"], h, residual, eps=LN_EPS)


class _Recompute(torch.autograd.Function):
    """``fn(*inputs)`` keeping only its inputs: the forward runs without a
    graph; the backward, inside ``spans``, runs it again with one and
    differentiates it (the reentrant form of ``torch.utils.checkpoint``;
    the parameters ``fn`` closes over take their gradients there)."""

    @staticmethod
    def forward(ctx, fn, spans, *inputs):
        ctx.fn, ctx.spans = fn, spans
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with contextlib.ExitStack() as stack:
            for name in ctx.spans:
                stack.enter_context(annotate(name))
            _recomputing[0] = True
            try:
                with torch.enable_grad():
                    out = ctx.fn(*inputs)
            finally:
                _recomputing[0] = False
            out = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(out, grads) if g is not None and o.requires_grad]
            torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        return (None, None, *[t.grad if n else None for t, n in zip(inputs, need)])


class GraphCast(nn.Module):
    """GraphCast on ``(B, grid nodes, channels_in)`` or ``(grid nodes,
    channels_in)`` fields, returning ``channels_out`` per grid node; the
    graphs (:class:`GraphCastGraphs`) come with each call.

    Parameters are drawn on the CPU from ``generator`` (weights
    Glorot-uniform, biases zero, LayerNorms one and zero), then placed on
    ``device``."""

    def __init__(self, channels_in: int, channels_out: int, *, device,
                 latent_size: int = 512, process_steps: int = 16,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 remat: "bool | str" = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.process_steps = process_steps
        self.compute_dtype = compute_dtype
        self._remat = parse_block_remat(remat, BLOCKS)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        L = latent_size

        def mlp(d_in):
            return mlp_init(d_in, L, gen, device)

        self.grid_embed = mlp(channels_in)
        self.mesh_embed = mlp(3)
        self.mesh_edge_embed = mlp(4)
        self.g2m_edge_embed = mlp(4)
        self.m2g_edge_embed = mlp(4)
        self.grid2mesh = nn.ModuleDict({"edge": mlp(3 * L), "mesh_node": mlp(2 * L),
                                        "grid_node": mlp(L)})
        for i in range(process_steps):
            self.add_module(f"process_{i}", nn.ModuleDict({"edge": mlp(3 * L),
                                                           "node": mlp(2 * L)}))
        self.mesh2grid = nn.ModuleDict({"edge": mlp(3 * L), "grid_node": mlp(2 * L)})
        self.output = core.mlp_init([L, L, channels_out], gen, device)

    # ------------------------------------------------------------ blocks
    def _embed(self, params, feats: Tensor, batch: int) -> Tensor:
        """A static ``(N, k)`` feature set embedded to ``(batch, N, L)``."""
        h = mlp_apply(params, feats.to(self.compute_dtype))
        return h.unsqueeze(0).expand(batch, *h.shape).contiguous()

    def _interact(self, block: str, params, g: BipartiteGraph, e: Tensor,
                  xs: Tensor, xr: Tensor, residual: bool) -> tuple[Tensor, Tensor]:
        """The edge update and each receiver's sum over its edges:
        ``(e′, Σ e′)``."""
        _count(block, "gather")
        joined = gather_join(e, xs, xr, g)
        e = mlp_apply(params, joined, e if residual else None)
        _count(block, "edge_sum")
        return e, edge_sum(e, g)

    def _grid2mesh(self, graphs: GraphCastGraphs, vg: Tensor, vm: Tensor):
        with annotate("gwen.graphcast.grid2mesh"):
            p, g = self.grid2mesh, graphs.grid2mesh
            e = self._embed(self.g2m_edge_embed, g.edge_features, vg.shape[0])
            _, agg = self._interact("g2m", p["edge"], g, e, vg, vm, residual=False)
            vm = mlp_apply(p["mesh_node"], torch.cat([vm, agg], dim=-1), vm)
            vg = mlp_apply(p["grid_node"], vg, vg)
            return vg, vm

    def _process(self, i: int, graphs: GraphCastGraphs, e: Tensor, vm: Tensor):
        with annotate("gwen.process"):
            p, g = getattr(self, f"process_{i}"), graphs.mesh
            e, agg = self._interact("mesh", p["edge"], g, e, vm, vm, residual=True)
            vm = mlp_apply(p["node"], torch.cat([vm, agg], dim=-1), vm)
            return e, vm

    def _mesh2grid(self, graphs: GraphCastGraphs, vm: Tensor, vg: Tensor) -> Tensor:
        with annotate("gwen.graphcast.mesh2grid"):
            p, g = self.mesh2grid, graphs.mesh2grid
            e = self._embed(self.m2g_edge_embed, g.edge_features, vg.shape[0])
            _, agg = self._interact("m2g", p["edge"], g, e, vm, vg, residual=False)
            return mlp_apply(p["grid_node"], torch.cat([vg, agg], dim=-1), vg)

    def _block(self, name: str, spans: tuple[str, ...], fn, *inputs):
        if name in self._remat:
            return _Recompute.apply(fn, spans, *inputs)
        return fn(*inputs)

    # ----------------------------------------------------------- forward
    def forward(self, graphs: GraphCastGraphs, x: Tensor) -> Tensor:
        single = x.dim() == 2
        xb = x.unsqueeze(0) if single else x
        b = xb.shape[0]
        with annotate("gwen.encoder"):
            vg = mlp_apply(self.grid_embed, xb.to(self.compute_dtype))
            vm = self._embed(self.mesh_embed, graphs.mesh_features, b)
            e = self._embed(self.mesh_edge_embed, graphs.mesh.edge_features, b)
            vg, vm = self._block(
                "g2m", ("gwen.encoder", "gwen.graphcast.grid2mesh"),
                lambda vg, vm: self._grid2mesh(graphs, vg, vm), vg, vm)
        for i in range(self.process_steps):
            e, vm = self._block(
                "mesh", ("gwen.process",),
                lambda e, vm, i=i: self._process(i, graphs, e, vm), e, vm)
        with annotate("gwen.decoder"):
            vg = self._block(
                "m2g", ("gwen.decoder", "gwen.graphcast.mesh2grid"),
                lambda vm, vg: self._mesh2grid(graphs, vm, vg), vm, vg)
            y = core.mlp_apply(self.output, vg, activation=F.silu)
        y = y.to(x.dtype)
        return y[0] if single else y


def graphcast_graphs(config) -> GraphCastGraphs:
    """The graphs of a configuration with ``model.architecture
    "graphcast"``: ``graph.grid_lat × graph.grid_lon``, the multimesh to
    level ``graph.refine``, the grid2mesh radius ``graph.g2m_radius``."""
    g = config.graph
    return build_graphcast_graphs(g.grid_lat, g.grid_lon, g.refine, g.g2m_radius)


def graphcast_from_config(config, device, generator: Optional[torch.Generator] = None
                          ) -> GraphCast:
    """The model of a configuration with ``model.architecture
    "graphcast"``: ``model.channels_in``, ``channels_out``,
    ``latent_size``, ``process_steps`` and ``compute_dtype``, and
    ``train.remat``."""
    m = config.model
    if m.architecture != "graphcast":
        raise ValueError(f"model.architecture is {m.architecture!r}, not 'graphcast'")
    dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
    return GraphCast(m.channels_in, m.channels_out, device=device,
                     latent_size=m.latent_size, process_steps=m.process_steps,
                     compute_dtype=dtype, remat=config.train.remat,
                     generator=generator)
