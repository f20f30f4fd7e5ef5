"""Windowed graph-attention processor: counterpart of
``gwen_tpu.nn.attention``.

Messages are attention-weighted over each node's in-window mesh
neighbourhood on a :class:`DiagWindowGraph` built with transpose tables
(:func:`gwen_tpu_torch.ops.attention.windowed_attention`). Parameters are
the reference's: ``wq``, ``wk``, ``wv`` and ``wo``, each a linear
``{"w": (latent, latent), "b": (latent,)}``, so ``params_from_jax`` loads
``process_i.attn.wq.w`` unchanged.

The projections emit ``(H, ..., N, dh)``, heads in front, and the heads
fold with the batch into the kernels' item axis; the output projection
contracts heads and head width together. The reference's ``pack`` option
(lane-packing head pairs into 128-lane TPU tiles) is accepted and changes
nothing: it is bit-exact against no packing there, and on the H100 each
head runs at its own width.
"""

from __future__ import annotations

import torch
from torch import nn

from gwen_tpu_torch.graph.graph import DiagWindowGraph
from gwen_tpu_torch.nn import core
from gwen_tpu_torch.ops.attention import windowed_attention

Tensor = torch.Tensor


def graph_attention_init(latent: int, heads: int, generator: torch.Generator,
                         device) -> nn.ModuleDict:
    if latent % heads:
        raise ValueError(f"latent {latent} not divisible by heads {heads}")
    return nn.ModuleDict({name: core.linear_init(latent, latent, generator,
                                                 device)
                          for name in ("wq", "wk", "wv", "wo")})


def graph_attention_apply(params, graph, x: Tensor, heads: int = 2,
                          backend: str = "auto",
                          pack: "bool | None" = None) -> Tensor:
    """Multi-head windowed attention over mesh neighbourhoods. ``x`` is
    ``(..., N, latent)``; each head attends with its ``latent/heads``-wide
    slice, and the output projection mixes the heads. ``backend`` is the
    model's: ``"auto"`` (kernels), ``"plain"``, or any other value for the
    plain reference path. ``pack`` is accepted for the reference's
    signature and ignored (see the module docstring)."""
    del pack
    if not isinstance(graph, DiagWindowGraph):
        raise TypeError(
            "attention processor needs a DiagWindowGraph (diag-window "
            "layout with transpose tables); the partitioned HaloDiagGraph "
            f"comes with slice 6 of the port; got {type(graph).__name__}"
        )
    backend = backend if backend in ("auto", "plain") else "reference"
    latent = x.shape[-1]
    dh = latent // heads
    x2 = x.reshape(-1, latent)

    def proj(p):  # (M, latent) → (H, ..., N, dh)
        y = x2 @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
        return y.reshape(-1, heads, dh).transpose(0, 1).reshape(
            heads, *x.shape[:-1], dh)

    oh = windowed_attention(graph, proj(params["wq"]), proj(params["wk"]),
                            proj(params["wv"]), backend=backend)
    wo = params["wo"]
    out = (oh.reshape(heads, -1, dh).transpose(0, 1).reshape(-1, latent)
           @ wo["w"].to(x.dtype) + wo["b"].to(x.dtype))
    return out.reshape(x.shape)
