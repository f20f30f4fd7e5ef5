"""Windowed graph attention on the H100: hand-written kernels
(``csrc/window_attention.cu``) and their plain PyTorch versions.

Three kernel wrappers, each with a launch count (``.launches``), each
taking ``q`` as ``(N, dh)`` (the unbatched TPU kernel) or ``(nb, N, dh)``
with the heads and batch items folded into ``nb`` (the batched one), or
with more leading axes, the first one and the rest merged into two item
axes; one CUDA kernel serves every form, with the items as a grid
dimension:

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
``csrc/window_attention.cu`` for why). A
:class:`~gwen_tpu_torch.graph.graph.NeighbourListGraph` (GenCast's k-hop
neighbourhoods, hundreds of sources a row) has only the lists, and the
kernels read them as they are. On a packed graph the reference's
``mp`` kernels unpack the bits per tile; here the lists are built from the
bits once, when the graph is built, and the kernels do not change. The
plain versions never read those lists: they gather each block's window
from the mask (:func:`~gwen_tpu_torch.graph.graph.window_mask`) and
``window_start`` and compute the reference's dense tile math, vectorised
over blocks, so holding a kernel against its plain version on the card also
checks the lists. On a neighbour-list graph the plain versions gather
each row's sources from its list instead (:func:`_list_tiles`), a pass of
rows at a time, so they run at the published sizes.

Operands are strided: a kernel takes two layouts of three strides each
(the two item axes and the row), q's, which g and the outputs out and dq
share, and k's, which v, dk and dv share. So the kernels read q, k, v and
the output cotangent, and write the output and dq, dk, dv, where the
projections keep them: a head's ``dh`` values at its offset in the
``(..., N, H·dh)`` rows of the product (``nn/attention.py`` passes such
views, heads first). A contiguous ``(nb, N, dh)`` operand is the case of
one item axis and row stride ``dh``. An output is allocated in its
operand's layout. A wrapper copies an operand only where the kernels
cannot take it in place — a head width below its lane width
(zero-padded), a row whose values are not consecutive, a row start that is
not 16-byte aligned, leading axes that do not merge into two, v in another
layout than k or g than q — and counts each copy in
:data:`operand_copies`; the attention cells make none.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from gwen_tpu_torch.graph.graph import DiagWindowGraph, NeighbourListGraph, window_mask
from gwen_tpu_torch.ops import cuda_lib
from gwen_tpu_torch.ops.cuda_lib import DTYPE_CODE, FLOAT, INT, LONG, PTR, CudaLib, fit_rows

Tensor = torch.Tensor

# Head widths the kernels take (32 lanes × 1, 2, 4, 8 or 16 values); the
# wrappers zero-pad dh up to the next one (zero lanes change no dot product).
LANE_WIDTHS = (32, 64, 128, 256, 512)
# layouts, nb, inner, n_q, n_kv, deg, vpt, scale, dtype, stream
_TAIL = [PTR] + [INT] * 6 + [FLOAT, INT, PTR]
LIB = CudaLib("window_attention.cu", gwen_attn_fwd=[PTR] * 5 + _TAIL,
              gwen_attn_dq=[PTR] * 7 + _TAIL, gwen_attn_dkdv=[PTR] * 8 + _TAIL)
# Float32 elements a pass of the list-based plain versions gathers (each of
# the k and v tiles): ~0.5 GB.
_LIST_PASS = 1 << 27


# ------------------------------------------------------------ plain versions


def _as3(t: Tensor) -> Tensor:
    """``(..., rows, f)`` → ``(items, rows, f)``."""
    return t.reshape(-1, *t.shape[-2:])


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
    """``(nb, blocks, block, c)`` tiles → ``(..., rows, c)`` with the
    leading axes of ``like``."""
    out = t.reshape(t.shape[0], graph.num_padded_nodes, t.shape[-1])[:, :rows]
    return out.reshape(*like.shape[:-2], rows, t.shape[-1])


def _list_passes(graph: NeighbourListGraph, q3: Tensor):
    """The row ranges of the list-based plain versions' passes over
    ``q3``'s rows."""
    nb, n, f = q3.shape
    step = max(1, _LIST_PASS // max(1, nb * graph.max_degree * f))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def _list_tiles(graph: NeighbourListGraph, q3: Tensor, k3: Tensor, v3: Tensor,
                g3: Optional[Tensor], scale: float, lo: int, hi: int):
    """Rows ``lo:hi`` of a neighbour-list graph, float32: q and g rows
    ``(nb, r, f)``, each row's k and v sources ``(nb, r, D, f)`` (k and v
    rows past theirs read as zero, as the kernels read them), the mask
    ``(r, D)`` of real list entries, the masked logits ``(nb, r, D)`` and
    the source rows (0 where masked)."""
    nbr = graph.attn_nbr[lo:hi].long()
    mask = nbr >= 0
    idx = nbr.clamp_min(0)
    qt = q3[:, lo:hi].float()
    kw = fit_rows(k3, graph.num_src_rows)[:, idx].float()
    vw = fit_rows(v3, graph.num_src_rows)[:, idx].float()
    logits = torch.where(mask, torch.matmul(kw, qt[..., None])[..., 0] * scale, -1e30)
    gt = None if g3 is None else g3[:, lo:hi].float()
    return qt, gt, kw, vw, mask, idx, logits


def _list_fwd(graph: NeighbourListGraph, q: Tensor, k: Tensor, v: Tensor,
              scale: float) -> Tensor:
    q3, k3, v3 = _as3(q), _as3(k), _as3(v)
    outs = []
    for lo, hi in _list_passes(graph, q3):
        _, _, _, vw, mask, _, logits = _list_tiles(graph, q3, k3, v3, None, scale, lo, hi)
        p, _, _ = _softmax(logits, mask)
        outs.append(torch.matmul(p.to(v.dtype).float()[..., None, :], vw)[..., 0, :])
    return torch.cat(outs, 1).reshape(q.shape).to(v.dtype)


def _list_dq(graph: NeighbourListGraph, q: Tensor, k: Tensor, v: Tensor,
             g: Tensor, scale: float) -> tuple[Tensor, Tensor]:
    q3, k3, v3, g3 = _as3(q), _as3(k), _as3(v), _as3(g)
    dqs, stats = [], []
    for lo, hi in _list_passes(graph, q3):
        _, gt, kw, vw, mask, _, logits = _list_tiles(graph, q3, k3, v3, g3, scale, lo, hi)
        p, mx, den = _softmax(logits, mask)
        dp = torch.matmul(vw, gt[..., None])[..., 0]
        delta = (dp * p).sum(-1, keepdim=True)
        dl = p * (dp - delta) * scale
        dqs.append(torch.matmul(dl.to(k.dtype).float()[..., None, :], kw)[..., 0, :])
        stats.append(torch.cat([mx, den, delta], dim=-1))
    return (torch.cat(dqs, 1).reshape(q.shape).to(q.dtype),
            torch.cat(stats, 1).reshape(*q.shape[:-1], 3))


def _list_dkdv(graph: NeighbourListGraph, q: Tensor, k: Tensor, v: Tensor,
               g: Tensor, stats: Tensor, scale: float) -> tuple[Tensor, Tensor]:
    q3, k3, v3, g3 = _as3(q), _as3(k), _as3(v), _as3(g)
    st3 = _as3(stats)
    nb, f = q3.shape[0], q3.shape[-1]
    dk = q3.new_zeros(nb, graph.num_src_rows, f, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for lo, hi in _list_passes(graph, q3):
        qt, gt, _, vw, mask, idx, logits = _list_tiles(graph, q3, k3, v3, g3, scale, lo, hi)
        st = st3[:, lo:hi]
        mx, den, delta = st[..., 0:1], st[..., 1:2], st[..., 2:3]
        p = torch.exp(logits - mx) * mask / torch.where(den == 0, 1.0, den)
        dl = p * (torch.matmul(vw, gt[..., None])[..., 0] - delta) * scale
        flat = idx.reshape(-1)
        dk.index_add_(1, flat, (dl.to(q.dtype).float()[..., None] * qt[..., None, :]
                                ).reshape(nb, -1, f))
        dv.index_add_(1, flat, (p.to(g.dtype).float()[..., None] * gt[..., None, :]
                                ).reshape(nb, -1, f))
    n_kv = k.shape[-2]
    return (fit_rows(dk, n_kv).to(k.dtype).reshape(k.shape),
            fit_rows(dv, n_kv).to(v.dtype).reshape(v.shape))


def attention_fwd_plain(graph: DiagWindowGraph, q: Tensor, k: Tensor,
                        v: Tensor, scale: float) -> Tensor:
    """Plain version of B5/B5b; differentiable, so autograd through it is
    an independent check of the two backward kernels."""
    if isinstance(graph, NeighbourListGraph):
        return _list_fwd(graph, q, k, v, scale)
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
    if isinstance(graph, NeighbourListGraph):
        return _list_dq(graph, q, k, v, g, scale)
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
    if isinstance(graph, NeighbourListGraph):
        return _list_dkdv(graph, q, k, v, g, stats, scale)
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
    return dk.reshape(k.shape), dv.reshape(v.shape)


# ------------------------------------------------------------ kernel wrappers


def _lanes(f: int) -> int:
    for width in LANE_WIDTHS:
        if f <= width:
            return width
    raise ValueError(f"head width {f} is over the kernels' {LANE_WIDTHS[-1]}")


def check_operands(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                   g: Optional[Tensor] = None) -> None:
    """Raise on anything the kernels do not take: ``q`` (and ``g``)
    ``(..., N, dh)``; ``k`` and ``v`` ``(..., N_kv, dh)`` with q's leading
    axes; all float32 or all bfloat16, on one device, with the graph's
    neighbour lists; ``N ≤ N_pad``, ``N_kv ≤ num_src_rows``, dh at most
    512; each row's values consecutive and each row start 16-byte aligned,
    at any strides, with v in k's layout and g in q's (the kernels address
    each pair through one set of strides). The wrappers check the operands
    as :func:`_operands` hands them to the kernels, having copied those the
    kernels cannot address in place."""
    if q.dim() < 2:
        raise ValueError(f"q must be (..., N, dh); got shape {tuple(q.shape)}")
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
    if not (graph.attn_nbr.is_contiguous() and graph.attn_nbr_t.is_contiguous()):
        raise ValueError("the graph's neighbour lists must be contiguous")
    if not all(_in_place(t) for t in ts):
        raise ValueError("windowed-attention operands need consecutive row "
                         "values and 16-byte aligned row starts; strides "
                         + ", ".join(str(t.stride()) for t in ts))
    if not (_same_layout(v, k) and (g is None or _same_layout(g, q))):
        raise ValueError("v must have k's strides and g q's; strides "
                         + ", ".join(str(t.stride()) for t in ts))


def _same_layout(a: Tensor, b: Tensor) -> bool:
    """Whether ``a`` and ``b`` have one shape and the same strides on
    every axis longer than one."""
    return a.shape == b.shape and all(
        sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


def _in_place(t: Tensor) -> bool:
    """Whether the kernels address ``t``'s rows where they lie: a row's
    values consecutive, every row start 16-byte aligned, the row stride
    under 2**31 elements (the kernels' 32-bit row stride)."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and t.stride(-2) < 2**31
            and all(s * size % 16 == 0
                    for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def _operand(t: Tensor) -> Tensor:
    """``t`` ``(..., rows, f)`` as the kernels take it, ``(n0, n1, rows,
    width)``: the first leading axis, then the others merged, at the lane
    width. A view of ``t`` where its strides allow; else a copy, counted in
    :data:`operand_copies` (a head width under its lane width, zero-padded;
    leading axes that do not merge; a row whose values are not consecutive
    or whose start is not 16-byte aligned)."""
    global operand_copies
    if t.dim() < 2:
        raise ValueError(f"operands must be (..., rows, dh); got shape "
                         f"{tuple(t.shape)}")
    lead = t.shape[:-2]
    shape = (lead[0] if lead else 1, math.prod(lead[1:]), *t.shape[-2:])
    width = _lanes(t.shape[-1])
    try:
        t4 = t.view(shape)
    except RuntimeError:  # leading axes whose strides do not merge
        t4 = None
    if t4 is not None and width == t.shape[-1] and _in_place(t4):
        return t4
    operand_copies += 1
    t4 = t.reshape(shape)
    return (t4.contiguous() if width == t.shape[-1]
            else F.pad(t4, (0, width - t.shape[-1])))


def _empty(like: Tensor) -> Tensor:
    """An uninitialised tensor with the shape and strides of ``like``."""
    return torch.empty_strided(like.shape, like.stride(), dtype=like.dtype,
                               device=like.device)


def _operands(q: Tensor, k: Tensor, v: Tensor, g: Optional[Tensor] = None
              ) -> list:
    """``q``, ``k``, ``v`` (and ``g``) as the kernels take them: each
    through :func:`_operand`, then ``v`` in k's layout and ``g`` in q's (a
    copy, counted in :data:`operand_copies`, where the strides differ)."""
    global operand_copies
    ts = [_operand(t) for t in ((q, k, v) if g is None else (q, k, v, g))]
    for at, like in ((2, 1), (3, 0)):  # v as k, g as q
        if at < len(ts) and ts[at].shape == ts[like].shape and not _same_layout(
                ts[at], ts[like]):
            operand_copies += 1
            ts[at] = _empty(ts[like]).copy_(ts[at])
    return ts


def _launch(entry, name: str, table: Tensor, q: Tensor, k: Tensor,
            scale: float, pointers: list) -> None:
    """One launch of ``entry`` on the kernel operands ``q`` and ``k``
    ``(n0, n1, rows, width)``: its pointers, the layouts (item, item and
    row strides) of q, which g and the q-side outputs share, and of k,
    which v and dk, dv share, then the shared trailing arguments."""
    layouts = (LONG * 6)(*q.stride()[:3], *k.stride()[:3])
    rc = entry(*pointers, layouts, q.shape[0] * q.shape[1], q.shape[1],
               q.shape[2], k.shape[2], table.shape[1], q.shape[3] // 32,
               float(scale), DTYPE_CODE[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed(name, rc)


def _result(t: Tensor, like: Tensor) -> Tensor:
    """Kernel output ``(n0, n1, rows, width)`` → the shape of ``like`` (a
    view)."""
    f = like.shape[-1]
    return (t[..., :f] if t.shape[-1] != f else t).view(like.shape)


def attention_fwd(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                  scale: float) -> Tensor:
    """Kernels B5 (``q`` 2-D) and B5b (more axes): the attention output,
    shaped like q, in q's type and, where q's rows are read in place, in
    q's layout."""
    if not cuda_lib.on_cuda(q, "windowed-attention"):
        return attention_fwd_plain(graph, q, k, v, scale)
    qk, kk, vk = _operands(q, k, v)
    check_operands(graph, qk, kk, vk)
    out = _empty(qk)
    _launch(LIB().gwen_attn_fwd, "B5", graph.attn_nbr, qk, kk, scale,
            [qk.data_ptr(), kk.data_ptr(), vk.data_ptr(),
             graph.attn_nbr.data_ptr(), out.data_ptr()])
    attention_fwd.launches += 1
    return _result(out, q)


def attention_dq(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                 g: Tensor, scale: float) -> tuple[Tensor, Tensor]:
    """Kernels B6/B6b: ``(dq, stats)`` for the output cotangent ``g``
    (shaped like q, in v's type); dq in q's layout where q is read in
    place, stats ``(..., N, 3)`` float32, contiguous."""
    if not cuda_lib.on_cuda(q, "windowed-attention"):
        return attention_dq_plain(graph, q, k, v, g, scale)
    qk, kk, vk, gk = _operands(q, k, v, g)
    check_operands(graph, qk, kk, vk, gk)
    dq = _empty(qk)
    stats = torch.empty(*qk.shape[:-1], 3, dtype=torch.float32,
                        device=q.device)
    _launch(LIB().gwen_attn_dq, "B6", graph.attn_nbr, qk, kk, scale,
            [qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), gk.data_ptr(),
             graph.attn_nbr.data_ptr(), dq.data_ptr(), stats.data_ptr()])
    attention_dq.launches += 1
    return _result(dq, q), stats.view(*q.shape[:-1], 3)


def attention_dkdv(graph: DiagWindowGraph, q: Tensor, k: Tensor, v: Tensor,
                   g: Tensor, stats: Tensor, scale: float
                   ) -> tuple[Tensor, Tensor]:
    """Kernels B7/B7b: ``(dk, dv)``, shaped like k and, where k and v are
    read in place, in their layouts, from the stats of
    :func:`attention_dq`."""
    if not cuda_lib.on_cuda(q, "windowed-attention"):
        return attention_dkdv_plain(graph, q, k, v, g, stats, scale)
    if (stats.dtype != torch.float32 or stats.shape != (*q.shape[:-1], 3)
            or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be contiguous float32 "
                         f"{(*q.shape[:-1], 3)} on {q.device}")
    qk, kk, vk, gk = _operands(q, k, v, g)
    check_operands(graph, qk, kk, vk, gk)
    dk, dv = _empty(kk), _empty(kk)
    _launch(LIB().gwen_attn_dkdv, "B7", graph.attn_nbr_t, qk, kk, scale,
            [qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), gk.data_ptr(),
             stats.data_ptr(), graph.attn_nbr_t.data_ptr(), dk.data_ptr(),
             dv.data_ptr()])
    attention_dkdv.launches += 1
    return _result(dk, k), _result(dv, v)


attention_fwd.launches = 0
attention_dq.launches = 0
attention_dkdv.launches = 0
# Operands the wrappers copied because the kernels could not read them in
# place (see _operand).
operand_copies = 0
