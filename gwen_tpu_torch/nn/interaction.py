"""Interaction-network (edge-MLP) message passing: counterpart of
``gwen_tpu.nn.interaction``.

Messages are computed per edge by an MLP over ``[sender, receiver]``
features and sum-aggregated onto the receivers, followed by a node-update
MLP, a LayerNorm and the residual. It runs on the COO graph only (gather,
dense products, ``index_add``); padding edges are gated out by their zero
weights. Per-edge MLPs touch E × latent activations: use the GCN processor
where throughput dominates.
"""

from __future__ import annotations

import torch
from torch import nn

from gwen_tpu_torch.graph.graph import Graph
from gwen_tpu_torch.nn import core

Tensor = torch.Tensor


def interaction_init(latent: int, mlp_layers: int, generator: torch.Generator,
                     device) -> nn.ModuleDict:
    """Parameters as the reference's tree: ``edge_mlp`` and ``node_mlp``
    (``[2·latent] + [latent]·mlp_layers``) and ``norm``."""
    dims = [2 * latent] + [latent] * mlp_layers
    return nn.ModuleDict({
        "edge_mlp": core.mlp_init(dims, generator, device),
        "node_mlp": core.mlp_init(dims, generator, device),
        "norm": core.layer_norm_init(latent, device),
    })


def interaction_apply(params, graph: Graph, x: Tensor) -> Tensor:
    """One interaction step on ``(..., N, latent)``: residual node update
    from edge-MLP messages."""
    if not isinstance(graph, Graph):
        raise TypeError(
            "interaction processor needs a COO Graph (segment path); got "
            f"{type(graph).__name__}")
    gate = (graph.weights != 0).to(x.dtype)  # padding edges contribute 0
    src = x.index_select(-2, graph.senders)
    dst = x.index_select(-2, graph.receivers)
    msgs = core.mlp_apply(params["edge_mlp"], torch.cat([src, dst], dim=-1))
    msgs = msgs * gate[:, None]
    agg = torch.zeros_like(x).index_add(-2, graph.receivers, msgs)
    upd = core.mlp_apply(params["node_mlp"], torch.cat([x, agg], dim=-1))
    upd = core.layer_norm_apply(params["norm"], upd)
    return x + upd
