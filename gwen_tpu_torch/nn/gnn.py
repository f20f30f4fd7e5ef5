"""GNN model family: counterpart of ``gwen_tpu.nn.gnn``.

:class:`GCNStack` is the encoder-decoder GCN over the ensemble-member
graph: widths ``ch_in → h → h/2 → h/4 → h/2 → h → ch_out``, ReLU between
the layers and none after the last. :class:`EncodeProcessDecode` is the
mesh-scale model (GCN, attention and interaction processors):

Encoder MLP → K processor steps → decoder MLP, on ``(N, F)`` or batched
``(..., N, F)`` node fields. A GCN step is ``h ← h + LayerNorm(Â·relu(h)·W
+ b)``, an attention step ``h ← h + LayerNorm(attn(relu(h)))`` with the
windowed multi-head attention of :mod:`gwen_tpu_torch.nn.attention`, an
interaction step the edge-MLP message passing of
:mod:`gwen_tpu_torch.nn.interaction` on the COO graph (it carries its own
LayerNorm and residual). The GCN and attention per-step tail runs through
the fused residual-LayerNorm kernels. For the
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
  attention output before it. An interaction step names no tensor to
  keep (as in the reference) and is recomputed in full;
* ``True`` — recompute every step in full from its input;
* ``"nested:G"`` — checkpoint groups of G steps whose steps are
  themselves checkpointed: ``ceil(steps / G)`` live boundaries, one more
  forward recompute per step.

Under a profiler (:func:`gwen_tpu_torch.profiling.annotate`) a forward
opens the spans ``gwen.encoder``, one ``gwen.process`` a step (again for a
step recomputed under ``checkpoint``) and ``gwen.decoder``.
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
from gwen_tpu_torch.nn.interaction import interaction_apply, interaction_init
from gwen_tpu_torch.nn.layers import gcn_apply, gcn_init, gcn_post, gcn_pre
from gwen_tpu_torch.ops.aggregate import aggregate
from gwen_tpu_torch.ops.fused_ln import fused_residual_layernorm
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor


def _width_schedule(ch_in: int, hidden: int, ch_out: int, down: int,
                    up: int) -> list[int]:
    """The reference's width schedule, generalized to depth."""
    downs = [hidden // (2 ** i) for i in range(down)]  # h, h/2, h/4, ...
    ups = [hidden // (2 ** i) for i in reversed(range(up - 1))]  # ..., h/2, h
    return [ch_in] + downs + ups + [ch_out]


class GCNStack(nn.Module):
    """Encoder-decoder GCN on ``(N, F)`` or batched ``(..., N, F)`` node
    features over any graph container :func:`aggregate` takes (the member
    graph is a :class:`~gwen_tpu_torch.graph.graph.DenseGraph`).

    Parameters are named as the reference's param tree (``gcn_0.w``,
    ``gcn_0.b``, ...) and drawn on the CPU from ``generator``, then placed
    on ``device``."""

    def __init__(self, channels_in: int, channels_out: int, *, device,
                 hidden_feats: int = 1024, down_layers: int = 3,
                 up_layers: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 backend: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = _width_schedule(channels_in, hidden_feats, channels_out,
                                      down_layers, up_layers)
        self.compute_dtype = compute_dtype
        self.backend = backend
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for i in range(len(self.widths) - 1):
            self.add_module(f"gcn_{i}", gcn_init(self.widths[i],
                                                 self.widths[i + 1], gen, device))

    def forward(self, graph, x: Tensor) -> Tensor:
        h = x.to(self.compute_dtype)
        n = len(self.widths) - 1
        for i in range(n):
            h = gcn_apply(getattr(self, f"gcn_{i}"), graph, h,
                          backend=self.backend)
            if i < n - 1:  # no activation after the final layer
                h = torch.relu(h)
        return h.to(x.dtype)


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


def parse_block_remat(remat: "bool | str", blocks: tuple[str, ...]
                      ) -> frozenset[str]:
    """The ladder for a model made of named blocks (GraphCast's ``g2m``,
    ``mesh``, ``m2g``): the blocks recomputed in the backward. ``False``
    → none, ``True`` → every block, ``"blocks:a+b"`` → the blocks named.
    Raises ``ValueError`` on anything else or on an unknown block."""
    if remat is False or remat is None:
        return frozenset()
    if remat is True:
        return frozenset(blocks)
    if isinstance(remat, str) and remat.startswith("blocks:"):
        names = frozenset(n for n in remat[len("blocks:"):].split("+") if n)
        if names and names <= set(blocks):
            return names
    raise ValueError(f"unknown remat policy {remat!r}: use False, True or "
                     f"'blocks:' with names from {'+'.join(blocks)}")


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
    kernels' plain versions on the same path, ``"segment"`` the aggregation
    through its plain reference with the LayerNorm tail still on its
    kernels, and any other value everything through the plain references.
    ``processor`` is ``"gcn"``, ``"attention"`` (with ``attn_heads``;
    ``attn_pack`` is accepted and changes nothing) or
    ``"interaction"`` (COO graph only).
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
        if processor not in ("gcn", "attention", "interaction"):
            raise ValueError(f"unknown processor {processor!r}: use 'gcn', "
                             "'attention' or 'interaction'")
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
            if processor == "interaction":
                self.add_module(f"process_{i}",
                                interaction_init(L, mlp_layers, gen, device))
                continue
            block = (graph_attention_init(L, attn_heads, gen, device)
                     if processor == "attention" else gcn_init(L, L, gen, device))
            self.add_module(f"process_{i}", nn.ModuleDict({
                "attn" if processor == "attention" else "gcn": block,
                "norm": core.layer_norm_init(L, device),
            }))
        self.decoder = core.mlp_init([L] * mlp_layers + [channels_out], gen, device)

    def _norm_residual(self, norm_params, m: Tensor, h: Tensor) -> Tensor:
        if self.residual:
            # "segment" names the aggregation path only: the LayerNorm tail
            # keeps its kernels, as in the reference.
            backend = "auto" if self.backend == "segment" else self.backend
            return fused_residual_layernorm(norm_params, m, h, backend=backend)
        return core.layer_norm_apply(norm_params, m)

    def _attend(self, p, graph, h: Tensor) -> Tensor:
        """The attention block of a step: ``m = attn(relu(h))``."""
        return graph_attention_apply(p["attn"], graph, torch.relu(h),
                                     heads=self.attn_heads,
                                     backend=self.backend,
                                     pack=self.attn_pack)

    def _step(self, p, graph, h: Tensor) -> Tensor:
        with annotate("gwen.process"):
            if self.processor == "interaction":
                return interaction_apply(p, graph, torch.relu(h))
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
        with annotate("gwen.process"):
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
            if (kind == "save_agg" and i < k
                    and self.processor != "interaction"):
                h = self._step_save_agg(p, graph, h)
            elif kind in ("save_agg", "full"):
                h = full(p, h)
            else:
                h = self._step(p, graph, h)
        return h

    def forward(self, graph, x: Tensor) -> Tensor:
        with annotate("gwen.encoder"):
            h = core.mlp_apply(self.encoder, x.to(self.compute_dtype))

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
        with annotate("gwen.decoder"):
            h = core.mlp_apply(self.decoder, torch.relu(h))
        return h.to(x.dtype)
