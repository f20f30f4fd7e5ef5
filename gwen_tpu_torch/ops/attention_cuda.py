"""Windowed graph attention on the H100: hand-written kernels
(``csrc/window_attention.cu``) and their plain PyTorch versions.

Three kernel wrappers, each with a launch count (``.launches``), each
taking ``q`` as ``(N, dh)`` (the unbatched TPU kernel) or ``(nb, N, dh)``
with the heads and batch items folded into ``nb`` (the batched one); one
CUDA kernel serves both forms, with the items as a grid dimension:

* :func:`attention_fwd` — kernels B5 and B5b, replacing
  ``gwen_tpu/ops/attention_pallas.py:_attn_fwd_kernel`` (through
  ``_attn_fwd_impl``) and ``_attn_fwd_kernel_b`` (through
  ``_attn_fwd_impl_b``): masked softmax attention over each destination
  row's in-window sources, P never in memory;
* :func:`attention_dq` — B6 and B6b (``_attn_dq_kernel``,
  ``_attn_dq_kernel_b``): dQ and the per-row stats ``(mx, den, delta)``,
  ``(nb, N, 3)`` float32;
* :func:`attention_dkdv` — B7 and B7b (``_attn_dkdv_kernel``,
  ``_attn_dkdv_kernel_b``): dK and dV, P rebuilt from the stats.

The kernels read the mask (``s_mat != 0``, or the S01 bits of a packed
graph) as the graph's neighbour lists (``attn_nbr``, ``attn_nbr_t``; see
``csrc/window_attention.cu`` for why). On a packed graph the reference's
``mp`` kernels unpack the bits per tile; here the lists are built from the
bits once, when the graph is built, and the kernels do not change. The
plain versions never read those lists: they gather each block's window
from the mask (:func:`~gwen_tpu_torch.graph.graph.window_mask`) and
``window_start`` and compute the reference's dense tile math, vectorised
over blocks, so holding a kernel against its plain version on the card also
checks the lists.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gwen_tpu_torch.graph.graph import DiagWindowGraph, window_mask
from gwen_tpu_torch.ops import cuda_lib
from gwen_tpu_torch.ops.cuda_lib import DTYPE_CODE, FLOAT, INT, PTR, CudaLib, fit_rows

Tensor = torch.Tensor

# Head widths the kernels take (32 lanes × 1, 2, 4, 8 or 16 values); the
# wrappers zero-pad dh up to the next one (zero lanes change no dot product).
LANE_WIDTHS = (32, 64, 128, 256, 512)
_TAIL = [INT] * 5 + [FLOAT, INT, PTR]  # nb, n_q, n_kv, deg, vpt, scale, dtype, stream
LIB = CudaLib("window_attention.cu", gwen_attn_fwd=[PTR] * 5 + _TAIL,
              gwen_attn_dq=[PTR] * 7 + _TAIL, gwen_attn_dkdv=[PTR] * 8 + _TAIL)


# ------------------------------------------------------------ plain versions


def _as3(t: Tensor) -> Tensor:
    return t if t.dim() == 3 else t.unsqueeze(0)


def _tiles(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
           g: Optional[Tensor], scale: float):
    """Every block's tiles at once, float32: q and g rows ``(nb, blocks,
    block, f)``, the k and v windows ``(nb, blocks, W, f)``, the mask
    ``(blocks, block, W)``, the masked logits ``(nb, blocks, block, W)`` and
    the window row index."""
    nb, _, f = q.shape
    blocks, block, w = graph.num_blocks, graph.block_size, graph.window_size
    idx = (graph.window_start.long()[:, None]
           + torch.arange(w, device=q.device)[None, :]).reshape(-1)

    def rows(x):
        return fit_rows(x, graph.num_padded_nodes).float().reshape(
            nb, blocks, block, f)

    def window(x):
        return fit_rows(x, graph.num_src_rows).index_select(1, idx).float(
        ).reshape(nb, blocks, w, f)

    qt, kw, vw = rows(q), window(k), window(v)
    mask = window_mask(graph).reshape(blocks, block, w)
    logits = torch.where(mask, torch.matmul(qt, kw.transpose(-1, -2)) * scale,
                         -1e30)
    return qt, None if g is None else rows(g), kw, vw, mask, idx, logits


def _softmax(logits: Tensor, mask: Tensor):
    """The reference's ``_tile_softmax`` after the scores: ``(p, mx, den)``
    with ``den == 0`` on rows with no source (p 0 there, no NaN). ``mx``
    carries no gradient: softmax does not depend on it."""
    mx = logits.amax(-1, keepdim=True).detach()
    e = torch.exp(logits - mx) * mask
    den = e.sum(-1, keepdim=True)
    return e / torch.where(den == 0, 1.0, den), mx, den


def _unfold(t: Tensor, graph: DiagWindowGraph, rows: int, like: Tensor) -> Tensor:
    """``(nb, blocks, block, c)`` tiles → ``(nb, rows, c)`` (or 2-D like
    ``like``)."""
    out = t.reshape(t.shape[0], graph.num_padded_nodes, t.shape[-1])[:, :rows]
    return out if like.dim() == 3 else out[0]


def attention_fwd_plain(graph: DiagWindowGraph, q: Tensor, k: Tensor,
                        v: Tensor, scale: float) -> Tensor:
    """Plain version of B5/B5b; differentiable, so autograd through it is
    an independent check of the two backward kernels."""
    _, _, _, vw, mask, _, logits = _tiles(graph, _as3(q), _as3(k), _as3(v),
                                          None, scale)
    p, _, _ = _softmax(logits, mask)
    out = torch.matmul(p.to(v.dtype).float(), vw)
    return _unfold(out, graph, q.shape[-2], q).to(v.dtype)


def attention_dq_plain(graph: DiagWindowGraph, q: Tensor, k: Tensor,
                       v: Tensor, g: Tensor, scale: float
                       ) -> tuple[Tensor, Tensor]:
    """Plain version of B6/B6b: ``(dq, stats)``, stats ``(..., N, 3)``
    float32 holding ``(mx, den, delta)`` per destination row."""
    _, gt, kw, vw, mask, _, logits = _tiles(graph, _as3(q), _as3(k), _as3(v),
                                            _as3(g), scale)
    p, mx, den = _softmax(logits, mask)
    dp = torch.matmul(gt, vw.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    dl = p * (dp - delta) * scale
    dq = torch.matmul(dl.to(k.dtype).float(), kw)
    n = q.shape[-2]
    stats = torch.cat([mx, den, delta], dim=-1)
    return (_unfold(dq, graph, n, q).to(q.dtype), _unfold(stats, graph, n, q))


def attention_dkdv_plain(graph: DiagWindowGraph, q: Tensor, k: Tensor,
                         v: Tensor, g: Tensor, stats: Tensor, scale: float
                         ) -> tuple[Tensor, Tensor]:
    """Plain version of B7/B7b: ``(dk, dv)``, P rebuilt from the stats of
    :func:`attention_dq_plain` as the reference's ``_attn_dkdv_tile`` does,
    each block's window contribution added into the source rows."""
    q3 = _as3(q)
    qt, gt, kw, vw, mask, idx, logits = _tiles(graph, q3, _as3(k), _as3(v),
                                               _as3(g), scale)
    st = fit_rows(_as3(stats), graph.num_padded_nodes).reshape(
        *qt.shape[:-1], 3)
    mx, den, delta = st[..., 0:1], st[..., 1:2], st[..., 2:3]
    p = torch.exp(logits - mx) * mask / torch.where(den == 0, 1.0, den)
    dl = p * (torch.matmul(gt, vw.transpose(-1, -2)) - delta) * scale
    nb, f = q3.shape[0], q3.shape[-1]

    def scatter(tile):  # (nb, blocks, W, f) → (nb, src, f)
        out = tile.new_zeros(nb, graph.num_src_rows, f)
        return out.index_add_(1, idx, tile.reshape(nb, -1, f))

    dk = scatter(torch.matmul(dl.to(q.dtype).float().transpose(-1, -2), qt))
    dv = scatter(torch.matmul(p.to(g.dtype).float().transpose(-1, -2), gt))
    n_kv = k.shape[-2]
    dk, dv = fit_rows(dk, n_kv).to(k.dtype), fit_rows(dv, n_kv).to(v.dtype)
    return (dk, dv) if q.dim() == 3 else (dk[0], dv[0])


# ------------------------------------------------------------ kernel wrappers


def _lanes(f: int) -> int:
    for width in LANE_WIDTHS:
        if f <= width:
            return width
    raise ValueError(f"head width {f} is over the kernels' {LANE_WIDTHS[-1]}")


def check_operands(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                   g: Optional[Tensor] = None) -> None:
    """Raise on anything the kernels do not take: ``q`` (and ``g``)
    ``(N, dh)`` or ``(nb, N, dh)``; ``k`` and ``v`` ``(N_kv, dh)`` or
    ``(nb, N_kv, dh)`` with q's items; all float32 or all bfloat16,
    contiguous, on one device, with the graph's neighbour lists;
    ``N ≤ N_pad``, ``N_kv ≤ num_src_rows``, dh at most 512."""
    if q.dim() not in (2, 3):
        raise ValueError(f"q must be (N, dh) or (nb, N, dh); got shape "
                         f"{tuple(q.shape)} (fold other leading axes)")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"the attention kernels take float32 or bfloat16, "
                        f"not {q.dtype}")
    if graph.attn_nbr is None:
        raise ValueError("the attention kernels need the graph's neighbour "
                         "lists: build it with transpose_tables=True")
    if v.shape != k.shape or k.shape[:-2] != q.shape[:-2] or (
            k.dim() != q.dim() or k.shape[-1] != q.shape[-1]) or (
            g is not None and g.shape != q.shape):
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
            + ("" if g is None else f", g {tuple(g.shape)} (like q)"))
    ts = (q, k, v) if g is None else (q, k, v, g)
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"operands must share q's type {q.dtype}")
    if q.shape[-2] > graph.num_padded_nodes or k.shape[-2] > graph.num_src_rows:
        raise ValueError(
            f"q has {q.shape[-2]} rows and k {k.shape[-2]}; the graph holds "
            f"{graph.num_padded_nodes} destination and {graph.num_src_rows} "
            "source rows")
    _lanes(q.shape[-1])
    for t in (*ts, graph.attn_nbr, graph.attn_nbr_t):
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("windowed-attention operands must be contiguous")


def _lane_pad(t: Tensor) -> Tensor:
    """``t`` as ``(nb, rows, width)``, zero-padded to the kernels' lane
    width."""
    t = _as3(t)
    width = _lanes(t.shape[-1])
    return t if width == t.shape[-1] else F.pad(t, (0, width - t.shape[-1]))


def _args(q: Tensor, k: Tensor, table: Tensor, scale: float) -> list:
    """The launch's shared trailing arguments."""
    q3, k3 = _as3(q), _as3(k)
    return [q3.shape[0], q3.shape[1], k3.shape[1], table.shape[1],
            _lanes(q.shape[-1]) // 32, float(scale), DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream]


def _cut(t: Tensor, f: int, like: Tensor) -> Tensor:
    """Kernel output ``(nb, rows, width)`` → the caller's head width and
    rank."""
    t = t[..., :f] if t.shape[-1] != f else t
    return t if like.dim() == 3 else t[0]


def attention_fwd(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                  scale: float) -> Tensor:
    """Kernels B5 (``q`` 2-D) and B5b (3-D): the attention output, shaped
    like q, in q's type."""
    if not cuda_lib.on_cuda(q, "windowed-attention"):
        return attention_fwd_plain(graph, q, k, v, scale)
    check_operands(graph, q, k, v)
    qp, kp, vp = _lane_pad(q), _lane_pad(k), _lane_pad(v)
    out = torch.empty_like(qp)
    rc = LIB().gwen_attn_fwd(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                             graph.attn_nbr.data_ptr(), out.data_ptr(),
                             *_args(q, k, graph.attn_nbr, scale))
    if rc != 0:
        raise cuda_lib.launch_failed("B5", rc)
    attention_fwd.launches += 1
    return _cut(out, q.shape[-1], q)


def attention_dq(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                 g: Tensor, scale: float) -> tuple[Tensor, Tensor]:
    """Kernels B6/B6b: ``(dq, stats)`` for the output cotangent ``g``
    (shaped like q, in v's type); stats ``(..., N, 3)`` float32."""
    if not cuda_lib.on_cuda(q, "windowed-attention"):
        return attention_dq_plain(graph, q, k, v, g, scale)
    check_operands(graph, q, k, v, g)
    qp, kp, vp, gp = _lane_pad(q), _lane_pad(k), _lane_pad(v), _lane_pad(g)
    dq = torch.empty_like(qp)
    stats = torch.empty(*qp.shape[:-1], 3, dtype=torch.float32,
                        device=q.device)
    rc = LIB().gwen_attn_dq(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                            gp.data_ptr(), graph.attn_nbr.data_ptr(),
                            dq.data_ptr(), stats.data_ptr(),
                            *_args(q, k, graph.attn_nbr, scale))
    if rc != 0:
        raise cuda_lib.launch_failed("B6", rc)
    attention_dq.launches += 1
    return _cut(dq, q.shape[-1], q), stats if q.dim() == 3 else stats[0]


def attention_dkdv(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                   g: Tensor, stats: Tensor, scale: float
                   ) -> tuple[Tensor, Tensor]:
    """Kernels B7/B7b: ``(dk, dv)``, shaped like k, from the stats of
    :func:`attention_dq`."""
    if not cuda_lib.on_cuda(q, "windowed-attention"):
        return attention_dkdv_plain(graph, q, k, v, g, stats, scale)
    check_operands(graph, q, k, v, g)
    if (stats.dtype != torch.float32 or stats.shape != (*q.shape[:-1], 3)
            or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be contiguous float32 "
                         f"{(*q.shape[:-1], 3)} on {q.device}")
    qp, kp, vp, gp = _lane_pad(q), _lane_pad(k), _lane_pad(v), _lane_pad(g)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    rc = LIB().gwen_attn_dkdv(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                              gp.data_ptr(), stats.data_ptr(),
                              graph.attn_nbr_t.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(),
                              *_args(q, k, graph.attn_nbr_t, scale))
    if rc != 0:
        raise cuda_lib.launch_failed("B7", rc)
    attention_dkdv.launches += 1
    return _cut(dk, k.shape[-1], q), _cut(dv, v.shape[-1], q)


attention_fwd.launches = 0
attention_dq.launches = 0
attention_dkdv.launches = 0
