"""GenCast's denoiser (Price et al. 2025, arXiv:2312.15796): GraphCast's
grid encoder and decoder (:class:`~gwen_tpu_torch.nn.graphcast.GridBlocks`)
around a graph transformer on the finest mesh, every LayerNorm conditioned
on the noise level, on the graphs of :mod:`gwen_tpu_torch.graph.gencast`.

With ``L`` the latent width and ``σ`` each sample's noise level:

* noise embedding: ``c = MLP(Fourier(ln σ / 4))``, the Fourier features
  ``sin`` and ``cos`` of ``2π f_k ln σ / 4`` at :data:`FREQUENCIES`
  frequencies ``f_k`` log-spaced from 1 to :data:`BASE_PERIOD`, then
  Linear → GELU → Linear, ``2·FREQUENCIES → 32 →`` :data:`COND_SIZE`;
* every norm is conditional: ``LN_c(x) = LN(x)·(1 + s) + o`` with ``(s,
  o) = W c + b``, the scale and offset of all :attr:`GenCast.norms` taken
  from one product (``norm_cond``), once a step
  (:func:`~gwen_tpu_torch.ops.fused_ln.cond_layernorm`);
* the grid side as GraphCast's (Linear → SiLU → Linear → ``LN_c``
  MLPs): the grid inputs, the mesh nodes' 3 features and each grid graph's
  4 edge features embedded; grid2mesh; mesh2grid; the output MLP, no norm;
* ``process_steps`` pre-norm transformer layers on the mesh, weights not
  shared: ``x ← x + Wo·MHA(LN_c(x))`` with ``heads`` heads over each
  node's k-hop neighbour list
  (:func:`~gwen_tpu_torch.nn.attention.graph_attention_apply` on a
  :class:`~gwen_tpu_torch.graph.graph.NeighbourListGraph`: kernels
  B5–B7 on the products' strided rows), then ``x ← x + W2·GELU(W1·
  LN_c(x))``, ``L → ffn_size → L``.

The model is the network ``F`` of EDM's ``D(x̃; σ) = c_skip x̃ + c_out F(
c_in x̃, cond, σ)``: its input is ``[c_in x̃, conditioning]`` per grid
node, and :func:`~gwen_tpu_torch.train.tasks.gencast_denoising_loss_fn`
draws σ and the noise and applies the rest.

Remat (:func:`~gwen_tpu_torch.nn.gnn.parse_block_remat`): ``g2m``,
``mesh`` (each transformer layer), ``m2g``; a recomputed block takes the
norms' scales and offsets as an input, so their gradients reach the
noise embedding. Spans under a profiler: ``gwen.gencast.condition`` (the
noise embedding and the norms' scales and offsets), then GraphCast's
``gwen.encoder``/``gwen.graphcast.grid2mesh``, one ``gwen.process`` a
transformer layer, ``gwen.decoder``/``gwen.graphcast.mesh2grid``.
:data:`attn_pairs` counts the (row, source) pairs attended, each head and
each recomputed layer included.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gwen_tpu_torch.graph.gencast import GenCastGraphs, build_gencast_graphs
from gwen_tpu_torch.nn import core
from gwen_tpu_torch.nn.attention import graph_attention_apply, graph_attention_init
from gwen_tpu_torch.nn.gnn import parse_block_remat
from gwen_tpu_torch.nn.graphcast import BLOCKS, LN_EPS, GridBlocks, mlp_apply
from gwen_tpu_torch.ops.fused_ln import cond_layernorm
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor
FREQUENCIES = 32
BASE_PERIOD = 16.0
NOISE_HIDDEN = 32
COND_SIZE = 16
GRID_NORMS = ("grid_embed", "mesh_embed", "g2m_edge_embed", "m2g_edge_embed",
              "grid2mesh.edge", "grid2mesh.mesh_node", "grid2mesh.grid_node",
              "mesh2grid.edge", "mesh2grid.grid_node")

#: (row, source) pairs attended, summed over heads, samples and calls.
attn_pairs = 0


def norm_names(layers: int) -> tuple[str, ...]:
    """The conditional norms in ``norm_cond``'s order: the grid MLPs', then
    each layer's ``attn_norm`` and ``ffn_norm``."""
    return GRID_NORMS + tuple(f"layer_{i}.{n}" for i in range(layers)
                              for n in ("attn_norm", "ffn_norm"))


def fourier_features(sigma: Tensor) -> Tensor:
    """``(B,)`` noise levels → ``(B, 2·FREQUENCIES)`` float32: ``sin`` then
    ``cos`` of ``2π f_k ln σ / 4``."""
    freqs = BASE_PERIOD ** (torch.arange(FREQUENCIES, device=sigma.device,
                                         dtype=torch.float32) / (FREQUENCIES - 1))
    ang = (2 * math.pi) * (torch.log(sigma.float()) / 4)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class GenCast(GridBlocks, nn.Module):
    """GenCast's denoiser network on ``(B, grid nodes, channels_in)``
    inputs and ``(B,)`` noise levels, returning ``(B, grid nodes,
    channels_out)``; the graphs (:class:`GenCastGraphs`) come with each
    call.

    Parameters are drawn on the CPU from ``generator`` (weights
    Glorot-uniform, biases zero), then placed on ``device``; float32,
    cast to ``compute_dtype`` where used (the noise embedding and the
    norms' scales and offsets stay float32)."""

    def __init__(self, channels_in: int, channels_out: int, *, device,
                 latent_size: int = 512, process_steps: int = 16, heads: int = 4,
                 ffn_size: int = 2048, compute_dtype: torch.dtype = torch.bfloat16,
                 remat: "bool | str" = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.process_steps, self.heads = process_steps, heads
        self.compute_dtype = compute_dtype
        self._remat = parse_block_remat(remat, BLOCKS)
        self.norms = norm_names(process_steps)
        self._norm_at = {n: i for i, n in enumerate(self.norms)}
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        L = latent_size

        def mlp(d_in):
            return nn.ModuleDict({"mlp": core.mlp_init([d_in, L, L], gen, device)})

        self.noise = core.mlp_init([2 * FREQUENCIES, NOISE_HIDDEN, COND_SIZE], gen, device)
        self.grid_embed = mlp(channels_in)
        self.mesh_embed = mlp(3)
        self.g2m_edge_embed = mlp(4)
        self.m2g_edge_embed = mlp(4)
        self.grid2mesh = nn.ModuleDict({"edge": mlp(3 * L), "mesh_node": mlp(2 * L),
                                        "grid_node": mlp(L)})
        for i in range(process_steps):
            self.add_module(f"layer_{i}", nn.ModuleDict({
                "attn": graph_attention_init(L, heads, gen, device),
                "ffn": core.mlp_init([L, ffn_size, L], gen, device)}))
        self.mesh2grid = nn.ModuleDict({"edge": mlp(3 * L), "grid_node": mlp(2 * L)})
        self.output = core.mlp_init([L, L, channels_out], gen, device)
        # One (COND_SIZE → L) scale and one offset product a norm, side by
        # side, each Glorot-uniform over its own fans.
        w = core.glorot_uniform((COND_SIZE, 2 * len(self.norms), L), gen, device)
        self.norm_cond = nn.ParameterDict({
            "w": nn.Parameter(w.reshape(COND_SIZE, -1)),
            "b": nn.Parameter(torch.zeros(2 * len(self.norms) * L, device=device))})

    # ------------------------------------------------------------ blocks
    def condition(self, sigma: Tensor) -> Tensor:
        """Every norm's scale ``1 + s`` and offset ``o`` for noise levels
        ``sigma`` ``(B,)``: ``(norms, 2, B, L)`` float32."""
        with annotate("gwen.gencast.condition"):
            c = core.mlp_apply(self.noise, fourier_features(sigma), activation=F.gelu)
            so = core.linear_apply(self.norm_cond, c)
            so = so.view(len(sigma), len(self.norms), 2, -1).permute(1, 2, 0, 3)
            return torch.stack([1 + so[:, 0], so[:, 1]], dim=1)

    def _conds(self, cond: Tensor):
        """``name → (scale, offset)`` over :meth:`condition`'s tensor."""
        return lambda name: (cond[self._norm_at[name], 0], cond[self._norm_at[name], 1])

    def _layer(self, i: int, graphs: GenCastGraphs, x: Tensor, cond) -> Tensor:
        global attn_pairs
        with annotate("gwen.process"):
            p = getattr(self, f"layer_{i}")
            a = cond_layernorm(x, *cond(f"layer_{i}.attn_norm"), eps=LN_EPS)
            attn_pairs += x.shape[0] * self.heads * graphs.mesh.num_pairs
            x = x + graph_attention_apply(p["attn"], graphs.mesh, a, heads=self.heads)
            h = cond_layernorm(x, *cond(f"layer_{i}.ffn_norm"), eps=LN_EPS)
            return x + core.mlp_apply(p["ffn"], h, activation=F.gelu)

    # ----------------------------------------------------------- forward
    def forward(self, graphs: GenCastGraphs, x: Tensor, sigma: Tensor) -> Tensor:
        single = x.dim() == 2
        xb = x.unsqueeze(0) if single else x
        sigma = sigma.reshape(-1)
        b = xb.shape[0]
        cond = self.condition(sigma)
        at = self._conds(cond)
        with annotate("gwen.encoder"):
            vg = mlp_apply(self.grid_embed, xb.to(self.compute_dtype), cond=at("grid_embed"))
            vm = self._embed(self.mesh_embed, graphs.mesh_features, b, at("mesh_embed"))
            vg, vm = self._block(
                "g2m", ("gwen.encoder", "gwen.graphcast.grid2mesh"),
                lambda vg, vm, c: self._grid2mesh(graphs, vg, vm, self._conds(c)),
                vg, vm, cond)
        for i in range(self.process_steps):
            vm = self._block(
                "mesh", ("gwen.process",),
                lambda vm, c, i=i: self._layer(i, graphs, vm, self._conds(c)), vm, cond)
        with annotate("gwen.decoder"):
            vg = self._block(
                "m2g", ("gwen.decoder", "gwen.graphcast.mesh2grid"),
                lambda vm, vg, c: self._mesh2grid(graphs, vm, vg, self._conds(c)),
                vm, vg, cond)
            y = core.mlp_apply(self.output, vg, activation=F.silu)
        y = y.to(x.dtype)
        return y[0] if single else y


def gencast_graphs(config, device="cpu") -> GenCastGraphs:
    """The graphs of a configuration with ``model.architecture
    "gencast"``: ``graph.grid_lat × graph.grid_lon``, the level-``graph.
    refine`` mesh, ``graph.g2m_radius`` and ``graph.k_hop``; the neighbour
    lists built on ``device``."""
    g = config.graph
    return build_gencast_graphs(g.grid_lat, g.grid_lon, g.refine, g.g2m_radius,
                                g.k_hop, device)


def gencast_from_config(config, device, generator: Optional[torch.Generator] = None
                        ) -> GenCast:
    """The model of a configuration with ``model.architecture
    "gencast"``: ``model.channels_in``, ``channels_out``, ``latent_size``,
    ``process_steps`` (transformer layers), ``attn_heads``, ``ffn_size``
    and ``compute_dtype``, and ``train.remat``."""
    m = config.model
    if m.architecture != "gencast":
        raise ValueError(f"model.architecture is {m.architecture!r}, not 'gencast'")
    dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
    return GenCast(m.channels_in, m.channels_out, device=device,
                   latent_size=m.latent_size, process_steps=m.process_steps,
                   heads=m.attn_heads, ffn_size=m.ffn_size, compute_dtype=dtype,
                   remat=config.train.remat, generator=generator)


__all__ = ["GenCast", "attn_pairs", "fourier_features", "gencast_from_config",
           "gencast_graphs", "norm_names"]
