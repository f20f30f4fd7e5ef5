"""Counterpart of ``gwen_tpu.nn.gnn.EncodeProcessDecode`` (GCN processor).

Encoder MLP → K GCN processor steps ``h ← h + LayerNorm(Â·relu(h)·W + b)``
→ decoder MLP. The per-step tail runs through the fused residual-LayerNorm
kernel, and on a :class:`DiagWindowGraph` the node state is held at
``num_padded_nodes`` rows through the process loop, so every aggregation
takes the pre-padded path (no zero-padded copy of the state per call). Pad
rows carry finite values that no real row reads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gwen_tpu_torch.graph.graph import DiagWindowGraph
from gwen_tpu_torch.nn import core
from gwen_tpu_torch.nn.layers import gcn_apply, gcn_init
from gwen_tpu_torch.ops.fused_ln import fused_residual_layernorm

Tensor = torch.Tensor


class EncodeProcessDecode(nn.Module):
    """Encoder MLP → K GCN processor steps (residual + LayerNorm) → decoder.

    Parameters are named as the reference's param tree (``encoder.layer_0.w``,
    ``process_0.gcn.w``, ``process_0.norm.scale``, ...) and drawn on the CPU
    from ``generator``, then placed on ``device``. ``backend="auto"`` runs
    the aggregations and the LayerNorm tail through the kernel wrappers,
    ``"plain"`` through the kernels' plain versions on the same path, and
    any other value through the plain references.
    """

    def __init__(self, channels_in: int, channels_out: int, *,
                 device, latent_size: int = 256, process_steps: int = 4,
                 mlp_layers: int = 2, residual: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 backend: str = "auto", processor: str = "gcn",
                 remat: "bool | str" = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if processor != "gcn":
            raise ValueError(
                f"processor={processor!r} is not ported yet: the port's "
                "slice 1 serves the GCN processor; interaction comes with "
                "slice 4 and attention with slice 3")
        if remat:
            raise ValueError(
                f"remat={remat!r} is a training policy; the remat ladder "
                "comes with slice 2 of the port")
        self.latent_size = latent_size
        self.process_steps = process_steps
        self.residual = residual
        self.compute_dtype = compute_dtype
        self.backend = backend
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        L = latent_size
        self.encoder = core.mlp_init([channels_in] + [L] * mlp_layers, gen, device)
        for i in range(process_steps):
            self.add_module(f"process_{i}", nn.ModuleDict({
                "gcn": gcn_init(L, L, gen, device),
                "norm": core.layer_norm_init(L, device),
            }))
        self.decoder = core.mlp_init([L] * mlp_layers + [channels_out], gen, device)

    def _norm_residual(self, norm_params, m: Tensor, h: Tensor) -> Tensor:
        if self.residual:
            return fused_residual_layernorm(norm_params, m, h,
                                            backend=self.backend)
        return core.layer_norm_apply(norm_params, m)

    def forward(self, graph, x: Tensor) -> Tensor:
        h = x.to(self.compute_dtype)
        h = core.mlp_apply(self.encoder, h)

        pad_rows = 0
        if (self.latent_size % 128 == 0 and isinstance(graph, DiagWindowGraph)
                and h.shape[-2] == graph.num_nodes):
            pad_rows = graph.num_padded_nodes - graph.num_nodes
            if pad_rows > 0:
                h = torch.cat([h, h.new_zeros(pad_rows, h.shape[-1])], dim=-2)

        for i in range(self.process_steps):
            p = getattr(self, f"process_{i}")
            m = gcn_apply(p["gcn"], graph, torch.relu(h), backend=self.backend)
            h = self._norm_residual(p["norm"], m, h)
        if pad_rows > 0:
            h = h[..., : h.shape[-2] - pad_rows, :]
        h = core.mlp_apply(self.decoder, torch.relu(h))
        return h.to(x.dtype)
