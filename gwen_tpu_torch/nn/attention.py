"""Windowed graph-attention processor: counterpart of
``gwen_tpu.nn.attention``.

Messages are attention-weighted over each node's in-window mesh
neighbourhood on a :class:`DiagWindowGraph` built with transpose tables
(:func:`gwen_tpu_torch.ops.attention.windowed_attention`), over each
node's whole neighbour list on a :class:`NeighbourListGraph` (GenCast's
k-hop neighbourhoods), or, on one rank
of a partitioned mesh, on a ``HaloDiagGraph``
(:func:`gwen_tpu_torch.parallel.halo.attend_halo`: K and V take a halo
exchange first). Parameters are
the reference's: ``wq``, ``wk``, ``wv`` and ``wo``, each a linear
``{"w": (latent, latent), "b": (latent,)}``, so ``params_from_jax`` loads
``process_i.attn.wq.w`` unchanged.

Each projection's ``(M, H·dh)`` product is handed to the attention as a
view, ``(..., N, H, dh)`` with the head axis moved in front, ``(H, ...,
N, dh)``: the heads fold with the batch into the kernels' items, and the
kernels read each head's ``dh`` values at its offset in the product's rows
(see :mod:`~gwen_tpu_torch.ops.attention_cuda`). The attention output takes
the same layout, so it is the ``(M, H·dh)`` buffer that the output
projection reads, heads and head width contracted together; in the
backward the cotangents pass the same way. No copy runs between the
products and the kernels in either direction; a copy the wrappers would
make is counted in ``attention_cuda.operand_copies``. The reference's ``pack`` option
(lane-packing head pairs into 128-lane TPU tiles) is accepted and changes
nothing: it is bit-exact against no packing there, and on the H100 each
head runs at its own width.

Each of the four products, with its bias, is :func:`core.linear` (the
bias in the product's epilogue; the span ``gwen.op.linear`` under a
profiler).
"""

from __future__ import annotations

import torch
from torch import nn

from gwen_tpu_torch.graph.graph import DiagWindowGraph, NeighbourListGraph
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
    # Late import: the halo path attends through this package's operators.
    from gwen_tpu_torch.parallel.halo import HaloDiagGraph, attend_halo

    if not isinstance(graph, (DiagWindowGraph, NeighbourListGraph, HaloDiagGraph)):
        raise TypeError(
            "attention processor needs a DiagWindowGraph (diag-window "
            "layout with transpose tables), a NeighbourListGraph or, "
            f"partitioned, a HaloDiagGraph; got {type(graph).__name__}"
        )
    backend = backend if backend in ("auto", "plain") else "reference"
    latent = x.shape[-1]
    dh = latent // heads
    x2 = x.reshape(-1, latent)

    def proj(p):  # (M, latent) → a view (H, ..., N, dh) of the product
        y = core.linear_apply(p, x2)
        return y.view(*x.shape[:-1], heads, dh).movedim(-2, 0)

    attend = attend_halo if isinstance(graph, HaloDiagGraph) else windowed_attention
    oh = attend(graph, proj(params["wq"]), proj(params["wk"]),
                proj(params["wv"]), backend=backend)
    # (H, ..., N, dh) → (M, latent): a view where oh is in the products'
    # layout, as the kernels write it.
    o2 = oh.movedim(0, -2).reshape(-1, latent)
    return core.linear_apply(params["wo"], o2).reshape(x.shape)
