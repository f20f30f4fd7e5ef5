"""Windowed graph attention: counterpart of ``gwen_tpu.ops.attention_pallas``
for the attention processor.

:func:`windowed_attention` is masked softmax attention over each node's
in-window neighbourhood on a :class:`DiagWindowGraph`: ``out[i] = Σ_j
P[i, j] v[j]`` with ``P = softmax_j(q[i]·k[j]·scale)`` over the sources
``j`` that the mask ``s_mat != 0`` holds in ``i``'s window. Out-of-window
(escape) edges are excluded by definition, as in the reference. Scores and
softmax run in float32; P is cast to v's type before ``P·V``.

Backends:

* ``"auto"`` — one ``torch.autograd.Function``, :class:`_WindowedAttention`,
  around the kernels of :mod:`gwen_tpu_torch.ops.attention_cuda`: forward
  B5, backward B6 (dQ and the per-row stats) then B7 (dK and dV), as the
  reference's ``_attn_fused_bwd``. On CPU tensors the wrappers run their
  plain versions.
* ``"plain"``, ``"reference"``, ``"segment"`` — the plain forward on any
  device, differentiated by autograd: an independent check of the two
  backward kernels.
* ``"unfused"`` (SDDMM, softmax and the transpose SpMM as separate kernel
  passes) waits for slice 3b of the port, with its kernels B8, B9, B9b.
"""

from __future__ import annotations

from typing import Optional

import torch

from gwen_tpu_torch.graph.graph import DiagWindowGraph
from gwen_tpu_torch.ops import attention_cuda

Tensor = torch.Tensor

_BACKENDS = ("auto", "plain", "reference", "segment")


def _require_tables(graph: DiagWindowGraph, who: str) -> None:
    if graph.t_max == 0:
        raise ValueError(
            f"{who} needs transpose tables — build the graph with "
            "to_diag_window(..., transpose_tables=True) or wrap it with "
            "diag_transpose_tables(graph)"
        )


class _WindowedAttention(torch.autograd.Function):
    """Forward B5; backward B6 then B7 on the saved q, k and v (the
    reference's flash-style backward: P is recomputed, never stored)."""

    @staticmethod
    def forward(ctx, q, k, v, graph, scale):
        ctx.save_for_backward(q, k, v)
        ctx.graph, ctx.scale = graph, scale
        return attention_cuda.attention_fwd(graph, q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(v.dtype).contiguous()
        dq, stats = attention_cuda.attention_dq(ctx.graph, q, k, v, g,
                                                ctx.scale)
        dk, dv = attention_cuda.attention_dkdv(ctx.graph, q, k, v, g, stats,
                                               ctx.scale)
        return dq, dk, dv, None, None


def windowed_attention(graph: DiagWindowGraph, q: Tensor, k: Tensor,
                       v: Tensor, *, scale: Optional[float] = None,
                       backend: str = "auto", pack: bool = False) -> Tensor:
    """Masked softmax attention over each node's in-window neighbourhood
    (see the module docstring). ``q`` is ``(..., N, f)`` and ``k``/``v``
    ``(..., N_kv, f)`` with the same leading axes, which fold into one item
    axis for the kernels; the result is shaped like q. ``scale`` defaults to
    ``1/sqrt(f)``.

    ``pack=True`` reads each item as the reference's two lane-packed
    sub-heads (lanes ``[0, 64)`` and ``[64, 128)``, each zero-padded to 64)
    and needs ``f = 128`` and an explicit ``scale``; the port attends each
    sub-head as an ordinary 64-wide head, which is exact.
    """
    if backend == "unfused":
        raise ValueError(
            "backend='unfused' (SDDMM, masked softmax and transpose SpMM as "
            "separate passes, kernels B8, B9 and B9b) comes with slice 3b "
            "of the port; use backend='auto'")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of "
                         f"{_BACKENDS} or 'unfused'")
    if not isinstance(graph, DiagWindowGraph):
        raise TypeError("windowed_attention needs a DiagWindowGraph, got "
                        f"{type(graph).__name__}")
    if backend != "reference":
        _require_tables(graph, "windowed_attention")
    n, f = q.shape[-2:]
    if pack:
        if f != 128:
            raise ValueError(
                f"pack=True expects lane-packed (..., N, 128) q/k/v with "
                f"two sub-heads at lanes [0, 64) and [64, 128); got f={f}")
        if scale is None:
            raise ValueError(
                "pack=True needs an explicit scale (1/sqrt(dh) of the "
                "TRUE head width, not of the packed 128 lanes)")
        return torch.cat([
            windowed_attention(graph, q[..., s], k[..., s], v[..., s],
                               scale=scale, backend=backend)
            for s in (slice(0, 64), slice(64, 128))], dim=-1)
    if scale is None:
        scale = 1.0 / (f ** 0.5)
    if k.shape[:-2] != q.shape[:-2] or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must share their leading axes")
    q3, k3, v3 = (t.reshape(-1, *t.shape[-2:]).contiguous() for t in (q, k, v))
    if backend == "auto":
        out = _WindowedAttention.apply(q3, k3, v3, graph, float(scale))
    else:
        out = attention_cuda.attention_fwd_plain(graph, q3, k3, v3,
                                                 float(scale))
    return out.reshape(q.shape)
