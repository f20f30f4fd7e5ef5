"""Counterpart of ``gwen_tpu.nn.gnn.EncodeProcessDecode`` (GCN and
attention processors).

Encoder MLP → K processor steps → decoder MLP, on ``(N, F)`` or batched
``(..., N, F)`` node fields. A GCN step is ``h ← h + LayerNorm(Â·relu(h)·W
+ b)``, an attention step ``h ← h + LayerNorm(attn(relu(h)))`` with the
windowed multi-head attention of :mod:`gwen_tpu_torch.nn.attention`. The
per-step tail runs through the fused residual-LayerNorm kernels. For the
GCN processor on a :class:`DiagWindowGraph` the node state is held at
``num_padded_nodes`` rows through the process loop, so every aggregation
takes the pre-padded path (no zero-padded copy of the state per call); pad
rows carry finite values that no real row reads. The attention processor
keeps the state at ``N`` rows, as the reference does: its kernels read
only real rows.

``remat`` is the reference's ladder, built on ``torch.utils.checkpoint``:

* ``False`` — save everything;
* ``"save_agg"`` / ``"save_agg:K"`` — keep each step's aggregation output
  (for the first K steps) and recompute only the dense ops around it, so
  the backward never re-runs the aggregation kernel; the other steps
  recompute in full. For attention the kept tensor is the attention
  block's output ``m`` (the reference's ``checkpoint_name``); the block is
  recomputed in the backward, whose weight gradient of ``wo`` needs the
  attention output before it;
* ``True`` — recompute every step in full from its input;
* ``"nested:G"`` — checkpoint groups of G steps whose steps are
  themselves checkpointed: ``ceil(steps / G)`` live boundaries, one more
  forward recompute per step.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gwen_tpu_torch.graph.graph import DiagWindowGraph
from gwen_tpu_torch.nn import core
from gwen_tpu_torch.nn.attention import graph_attention_apply, graph_attention_init
from gwen_tpu_torch.nn.layers import gcn_init, gcn_post, gcn_pre
from gwen_tpu_torch.ops.aggregate import aggregate
from gwen_tpu_torch.ops.fused_ln import fused_residual_layernorm

Tensor = torch.Tensor


def parse_remat(remat: "bool | str", process_steps: int
                ) -> tuple[str, int]:
    """``remat`` → ``(kind, k)``: ``("none" | "full", 0)``,
    ``("save_agg", K)`` or ``("nested", G)``. Raises ``ValueError`` on
    anything else, including ``"nested"`` without ``:G`` and ``nested:0``."""
    if remat is False or remat is None:
        return "none", 0
    if remat is True:
        return "full", 0
    if isinstance(remat, str):
        head, _, arg = remat.partition(":")
        if head == "save_agg" and not arg:
            return "save_agg", process_steps
        if head in ("save_agg", "nested") and arg.isdigit():
            k = int(arg)
            if head == "nested" and k < 1:
                raise ValueError(f"remat={remat!r}: the group size G of "
                                 "nested:G must be at least 1")
            return head, k
        if head == "nested":
            raise ValueError(f"remat={remat!r}: nested needs a group size, "
                             "as in 'nested:2'")
    raise ValueError(f"unknown remat policy {remat!r}: use False, True, "
                     "'save_agg', 'save_agg:K' or 'nested:G'")


def pack_mode(mode: "str | bool | None") -> "bool | None":
    """Config ``model.attn_pack`` (``"auto"``/``"on"``/``"off"``, or
    ``"true"``/``"false"``) → the model's ``attn_pack`` (None/True/False),
    as the reference's ``train_mesh._pack_mode``."""
    if mode is None or isinstance(mode, bool):
        return mode
    table = {"auto": None, "on": True, "true": True, "off": False,
             "false": False}
    if str(mode).lower() not in table:
        raise ValueError(f"model.attn_pack must be auto/on/off, got {mode!r}")
    return table[str(mode).lower()]


class EncodeProcessDecode(nn.Module):
    """Encoder MLP → K processor steps (residual + LayerNorm) → decoder.

    Parameters are named as the reference's param tree (``encoder.layer_0.w``,
    ``process_0.gcn.w`` or ``process_0.attn.wq.w``, ``process_0.norm.scale``,
    ...) and drawn on the CPU from ``generator``, then placed on ``device``.
    ``backend="auto"`` runs the aggregations (or attention) and the
    LayerNorm tail through the kernel wrappers, ``"plain"`` through the
    kernels' plain versions on the same path, and any other value through
    the plain references. ``processor`` is ``"gcn"`` or ``"attention"``
    (with ``attn_heads``; ``attn_pack`` is accepted and changes nothing).
    """

    def __init__(self, channels_in: int, channels_out: int, *,
                 device, latent_size: int = 256, process_steps: int = 4,
                 mlp_layers: int = 2, residual: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 backend: str = "auto", processor: str = "gcn",
                 attn_heads: int = 2, attn_pack: "bool | None" = None,
                 remat: "bool | str" = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if processor not in ("gcn", "attention"):
            raise ValueError(
                f"processor={processor!r} is not ported yet: the port runs "
                "the GCN and attention processors; interaction comes with "
                "slice 4")
        self.processor = processor
        self.attn_heads = attn_heads
        self.attn_pack = pack_mode(attn_pack)
        self.remat = remat
        self._remat = parse_remat(remat, process_steps)
        self.latent_size = latent_size
        self.process_steps = process_steps
        self.residual = residual
        self.compute_dtype = compute_dtype
        self.backend = backend
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        L = latent_size
        self.encoder = core.mlp_init([channels_in] + [L] * mlp_layers, gen, device)
        for i in range(process_steps):
            block = (graph_attention_init(L, attn_heads, gen, device)
                     if processor == "attention" else gcn_init(L, L, gen, device))
            self.add_module(f"process_{i}", nn.ModuleDict({
                "attn" if processor == "attention" else "gcn": block,
                "norm": core.layer_norm_init(L, device),
            }))
        self.decoder = core.mlp_init([L] * mlp_layers + [channels_out], gen, device)

    def _norm_residual(self, norm_params, m: Tensor, h: Tensor) -> Tensor:
        if self.residual:
            return fused_residual_layernorm(norm_params, m, h,
                                            backend=self.backend)
        return core.layer_norm_apply(norm_params, m)

    def _attend(self, p, graph, h: Tensor) -> Tensor:
        """The attention block of a step: ``m = attn(relu(h))``."""
        return graph_attention_apply(p["attn"], graph, torch.relu(h),
                                     heads=self.attn_heads,
                                     backend=self.backend,
                                     pack=self.attn_pack)

    def _step(self, p, graph, h: Tensor) -> Tensor:
        if self.processor == "attention":
            m = self._attend(p, graph, h)
        else:
            m = gcn_post(p["gcn"], aggregate(graph, gcn_pre(p["gcn"], torch.relu(h)),
                                             backend=self.backend))
        return self._norm_residual(p["norm"], m, h)

    def _step_save_agg(self, p, graph, h: Tensor) -> Tensor:
        """One step that keeps only its input and its aggregation output:
        the dense ops on either side are recomputed in the backward. An
        attention step keeps ``m`` and recomputes the attention block."""
        if self.processor == "attention":
            m = checkpoint(functools.partial(self._attend, p, graph), h,
                           use_reentrant=False)
            return self._norm_residual(p["norm"], m, h)
        pre = checkpoint(lambda t: gcn_pre(p["gcn"], torch.relu(t)), h,
                         use_reentrant=False)
        a = aggregate(graph, pre, backend=self.backend)
        return checkpoint(
            lambda a, t: self._norm_residual(p["norm"], gcn_post(p["gcn"], a), t),
            a, h, use_reentrant=False)

    def _process(self, graph, h: Tensor) -> Tensor:
        kind, k = self._remat
        steps = [getattr(self, f"process_{i}") for i in range(self.process_steps)]

        def full(p, t):
            return checkpoint(self._step, p, graph, t, use_reentrant=False)

        if kind == "nested":
            def group(ps, t):
                for p in ps:
                    t = full(p, t)
                return t

            for i0 in range(0, len(steps), k):
                h = checkpoint(functools.partial(group, steps[i0:i0 + k]), h,
                               use_reentrant=False)
            return h
        for i, p in enumerate(steps):
            if kind == "save_agg" and i < k:
                h = self._step_save_agg(p, graph, h)
            elif kind in ("save_agg", "full"):
                h = full(p, h)
            else:
                h = self._step(p, graph, h)
        return h

    def forward(self, graph, x: Tensor) -> Tensor:
        h = x.to(self.compute_dtype)
        h = core.mlp_apply(self.encoder, h)

        pad_rows = 0
        if (self.processor == "gcn" and self.latent_size % 128 == 0
                and isinstance(graph, DiagWindowGraph)
                and h.shape[-2] == graph.num_nodes):
            pad_rows = graph.num_padded_nodes - graph.num_nodes
            if pad_rows > 0:
                h = torch.cat([h, h.new_zeros(*h.shape[:-2], pad_rows,
                                              h.shape[-1])], dim=-2)

        h = self._process(graph, h)
        if pad_rows > 0:
            h = h[..., : h.shape[-2] - pad_rows, :]
        h = core.mlp_apply(self.decoder, torch.relu(h))
        return h.to(x.dtype)
