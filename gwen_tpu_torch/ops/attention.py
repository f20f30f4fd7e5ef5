"""Windowed graph attention and the unfused operators under it: counterpart
of ``gwen_tpu.ops.attention_pallas``.

The three operators ride the diag-window layout with transpose tables:

* :func:`diag_sddmm` — the window-relative score tile ``out[i, j] = a[i] ·
  b[ws(i) + j]``, float32 ``(N_pad, W)`` (kernel B8), differentiable in
  ``a`` and ``b``;
* :func:`diag_spmm_t` — the transpose aggregation ``out[j] = Σ_i
  s[i, j − ws(i)] · g[i]`` for a runtime, asymmetric ``s`` (kernels B9 and,
  on 3-d operands, B9b);
* :func:`diag_matvec` — ``S @ X`` with a runtime ``s``, differentiable in
  ``s`` (an SDDMM of the cotangent with ``x``) and in ``x`` (the transpose
  kernel); its forward is kernel B1 on ``s``.

:func:`windowed_attention` is masked softmax attention over each node's
in-window neighbourhood on a :class:`DiagWindowGraph`: ``out[i] = Σ_j
P[i, j] v[j]`` with ``P = softmax_j(q[i]·k[j]·scale)`` over the sources
``j`` that the mask (``s_mat != 0``, or the S01 bits of a packed graph)
holds in ``i``'s window. Out-of-window (escape) edges are excluded by
definition, as in the reference. On a :class:`NeighbourListGraph` (no
window) the sources are the whole of each row's list, and none is
dropped. Scores and softmax run in float32; P is cast to v's type before
``P·V``.

Backends:

* ``"auto"`` — one ``torch.autograd.Function``, :class:`_WindowedAttention`,
  around the kernels of :mod:`gwen_tpu_torch.ops.attention_cuda`: forward
  B5, backward B6 (dQ and the per-row stats) then B7 (dK and dV), as the
  reference's ``_attn_fused_bwd``. On CPU tensors the wrappers run their
  plain versions.
* ``"plain"``, ``"reference"``, ``"segment"`` — the plain forward on any
  device, differentiated by autograd: an independent check of the two
  backward kernels.
* ``"unfused"`` — the same math as separate passes: :func:`diag_sddmm`,
  the masked softmax on the dense score tile in plain torch (the reference
  leaves it to XLA), P cast to v's type, :func:`diag_matvec`; item by item,
  as the reference loops. The backward runs B8, B9 and B1 again through the
  two Functions below. A check on the fused kernels and a path for
  bisecting them; the ``(N_pad, W)`` tiles live in device memory. It needs
  a window: a neighbour-list graph refuses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from gwen_tpu_torch.graph.graph import DiagWindowGraph, NeighbourListGraph, window_mask
from gwen_tpu_torch.ops import attention_cuda, unfused_cuda
from gwen_tpu_torch.ops.cuda_lib import fit_rows
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor

_BACKENDS = ("auto", "unfused", "plain", "reference", "segment")


def _require_tables(graph: DiagWindowGraph, who: str) -> None:
    if not isinstance(graph, DiagWindowGraph):
        raise TypeError(f"{who} needs a DiagWindowGraph, got "
                        f"{type(graph).__name__}")
    if graph.t_max == 0:
        raise ValueError(
            f"{who} needs transpose tables — build the graph with "
            "to_diag_window(..., transpose_tables=True) or wrap it with "
            "diag_transpose_tables(graph)"
        )


def _two_d(name: str, *ts: Tensor) -> None:
    for t in ts:
        if t.dim() != 2:
            raise ValueError(f"{name} takes 2-d operands, as the reference; "
                             f"got shape {tuple(t.shape)}")


class _SDDMM(torch.autograd.Function):
    """Forward B8; backward, with ``ĝ`` the cotangent in b's type:
    ``dA = matvec(ĝ, b)`` (B1) and ``dB = spmm_t(ĝ, a)`` (B9), as the
    reference's ``_sddmm_bwd``."""

    @staticmethod
    def forward(ctx, a, b, graph):
        ctx.save_for_backward(a, b)
        ctx.graph = graph
        return unfused_cuda.sddmm(graph, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gs = g.to(b.dtype).contiguous()
        da = unfused_cuda.matvec(ctx.graph, gs, b)
        db = unfused_cuda.spmm_t(ctx.graph, gs, a)
        return (fit_rows(da, a.shape[-2]).to(a.dtype),
                fit_rows(db, b.shape[-2]).to(b.dtype), None)


class _MatVec(torch.autograd.Function):
    """Forward B1 on the runtime ``s``; backward ``dS = sddmm(g, x)`` (B8)
    cast to s's type and ``dX = spmm_t(s, g)`` (B9), as the reference's
    ``_matvec_bwd``."""

    @staticmethod
    def forward(ctx, s, x, graph):
        ctx.save_for_backward(s, x)
        ctx.graph = graph
        return unfused_cuda.matvec(graph, s, x)

    @staticmethod
    def backward(ctx, g):
        s, x = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        ds = unfused_cuda.sddmm(ctx.graph, g, x)
        dx = unfused_cuda.spmm_t(ctx.graph, s, g)
        return ds.to(s.dtype), fit_rows(dx, x.shape[-2]).to(x.dtype), None


def diag_sddmm(graph: DiagWindowGraph, a: Tensor, b: Tensor) -> Tensor:
    """Window-relative score tile ``out[i, j] = a[i] · b[ws(i) + j]``
    (float32), shape ``(num_padded_nodes, window)``. ``a`` ``(N, f)`` is
    indexed by destination row, ``b`` ``(N_kv, f)`` by source row; rows
    past ``num_padded_nodes`` and ``num_src_rows`` are cut, missing rows
    read as zero. Differentiable in both."""
    _require_tables(graph, "diag_sddmm")
    _two_d("diag_sddmm", a, b)
    return _SDDMM.apply(a[: graph.num_padded_nodes].contiguous(),
                        b[: graph.num_src_rows].contiguous(), graph)


def diag_spmm_t(graph: DiagWindowGraph, s: Tensor, g: Tensor) -> Tensor:
    """Transpose aggregation ``out[j] = Σ_i s[i, j − ws(i)] · g[i]`` over
    the window-relative tile ``s`` ``(N_pad, W)``, the adjoint of
    :func:`diag_matvec` in x: ``(num_src_rows, f)`` in g's type. With 3-d
    ``s`` ``(nb, N_pad, W)`` and ``g`` ``(nb, N, f)`` every item has its own
    tile (kernel B9b). Not differentiable, as in the reference."""
    _require_tables(graph, "diag_spmm_t")
    with torch.no_grad():
        return unfused_cuda.spmm_t(
            graph, s.contiguous(),
            g[..., : graph.num_padded_nodes, :].contiguous())


def diag_matvec(graph: DiagWindowGraph, s: Tensor, x: Tensor) -> Tensor:
    """``S @ X`` with a runtime, differentiable window-relative ``s``
    ``(num_padded_nodes, window)`` and ``x`` ``(N, f)``: ``(num_nodes, f)``
    in x's type. ``dS`` is an SDDMM of the cotangent with ``x``, ``dX`` the
    transpose kernel."""
    _require_tables(graph, "diag_matvec")
    _two_d("diag_matvec", s, x)
    out = _MatVec.apply(s.contiguous(),
                        x[: graph.num_src_rows].contiguous(), graph)
    return out[: graph.num_nodes]


def _unfused_item(graph: DiagWindowGraph, mask: Tensor, q: Tensor, k: Tensor,
                  v: Tensor, scale: float) -> Tensor:
    """One item of the unfused backend: B8, masked softmax, B1 on P."""
    scores = diag_sddmm(graph, q, k) * scale
    logits = torch.where(mask, scores, -1e30)
    p, _, _ = attention_cuda._softmax(logits, mask)
    out = diag_matvec(graph, p.to(v.dtype), v)
    return fit_rows(out, q.shape[-2])


class _WindowedAttention(torch.autograd.Function):
    """Forward B5; backward B6 then B7 on the saved q, k and v (the
    reference's flash-style backward: P is recomputed, never stored). The
    operands are saved and read as the caller's views, and dq, dk and dv
    come back in their layouts (see :mod:`~gwen_tpu_torch.ops.attention_cuda`),
    so nothing is copied around the kernels in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, graph, scale):
        ctx.save_for_backward(q, k, v)
        ctx.graph, ctx.scale = graph, scale
        return attention_cuda.attention_fwd(graph, q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        with annotate("gwen.op.attention.bwd"):
            q, k, v = ctx.saved_tensors
            g = g.to(v.dtype)
            dq, stats = attention_cuda.attention_dq(ctx.graph, q, k, v, g,
                                                    ctx.scale)
            dk, dv = attention_cuda.attention_dkdv(ctx.graph, q, k, v, g,
                                                   stats, ctx.scale)
        return dq, dk, dv, None, None


def windowed_attention(graph: DiagWindowGraph, q: Tensor, k: Tensor,
                       v: Tensor, *, scale: Optional[float] = None,
                       backend: str = "auto", pack: bool = False) -> Tensor:
    """Masked softmax attention over each node's in-window neighbourhood
    (see the module docstring). ``q`` is ``(..., N, f)`` and ``k``/``v``
    ``(..., N_kv, f)`` with the same leading axes, which fold into one item
    axis for the kernels (``"unfused"`` loops over it); the result is shaped
    like q. ``scale`` defaults to
    ``1/sqrt(f)``.

    ``pack=True`` reads each item as the reference's two lane-packed
    sub-heads (lanes ``[0, 64)`` and ``[64, 128)``, each zero-padded to 64)
    and needs ``f = 128`` and an explicit ``scale``; the port attends each
    sub-head as an ordinary 64-wide head, which is exact.

    One span ``gwen.op.attention`` under a profiler. On ``"auto"`` the
    kernels read q, k and v where they lie (any strides; see
    :mod:`~gwen_tpu_torch.ops.attention_cuda`) and the result takes q's
    layout; the other backends fold the leading axes as torch does.
    """
    with annotate("gwen.op.attention"):
        return _attend(graph, q, k, v, scale, backend, pack)


def _attend(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
            scale: Optional[float], backend: str, pack: bool) -> Tensor:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of "
                         f"{_BACKENDS}")
    if isinstance(graph, NeighbourListGraph):
        if backend == "unfused":
            raise ValueError("the unfused backend walks a diag window; a "
                             "NeighbourListGraph has none")
    elif not isinstance(graph, DiagWindowGraph):
        raise TypeError("windowed_attention needs a DiagWindowGraph or a "
                        f"NeighbourListGraph, got {type(graph).__name__}")
    elif backend != "reference":
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
            _attend(graph, q[..., s], k[..., s], v[..., s], scale, backend,
                    False)
            for s in (slice(0, 64), slice(64, 128))], dim=-1)
    if scale is None:
        scale = 1.0 / (f ** 0.5)
    if k.shape[:-2] != q.shape[:-2] or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must share their leading axes")
    if backend == "auto":
        return _WindowedAttention.apply(q, k, v, graph, float(scale))
    q3, k3, v3 = (t.reshape(-1, *t.shape[-2:]) for t in (q, k, v))
    if backend == "unfused":
        mask = window_mask(graph)
        out = torch.stack([_unfused_item(graph, mask, qi, ki, vi, float(scale))
                           for qi, ki, vi in zip(q3, k3, v3)])
    else:
        out = attention_cuda.attention_fwd_plain(graph, q3, k3, v3,
                                                 float(scale))
    return out.reshape(q.shape)
