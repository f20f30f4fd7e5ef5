"""The unfused attention operators on the diag-window layout: hand-written
Hopper kernels (``csrc/window_unfused.cu``) and their plain PyTorch
versions.

Three wrappers, each taking 2-d operands (the unbatched TPU kernel) or 3-d
ones with the items in front (the batched one; one CUDA kernel serves both,
with the items as a grid axis):

* :func:`sddmm` — kernel B8, replacing
  ``gwen_tpu/ops/attention_pallas.py:_sddmm_kernel`` (through
  ``_sddmm_impl``): the window-relative score tile ``out[i, j] = a[i] ·
  b[ws(i) + j]``, float32 ``(N_pad, W)``;
* :func:`spmm_t` — kernels B9 and B9b, replacing ``_spmm_t_kernel`` and
  ``_spmm_t_kernel_b`` (through ``_spmm_t_impl`` and ``_spmm_t_impl_b``):
  the transpose aggregation ``out[j] = Σ_i s[i, j − ws(i)] · g[i]`` for a
  runtime, asymmetric tile ``s``, ``(num_src_rows, f)`` in g's type; one
  launch count for both forms;
* :func:`matvec` — ``S @ X`` with a runtime ``s`` and no escapes, the
  forward of ``diag_matvec``: kernel B1 of
  :mod:`gwen_tpu_torch.ops.spmm_cuda` launched on ``s`` (it counts as a B1
  launch there); no kernel of its own, as in the reference
  (``_matvec_impl`` calls ``_diag_impl``).

The kernels fix the block at 128 rows and rely on window starts and the
window being multiples of it (checked when the graph's transpose tables
are built, :func:`~gwen_tpu_torch.graph.graph.diag_transpose_tables`); the
plain versions take any block. Their bf16 forms are tile products on the
tensor cores fed by a ring of asynchronous copies; their shared memory is
bounded whatever f is (B8 keeps a's rows resident up to 256 features and
streams them beside b above; B9 walks f in 128-feature slices), so there
is no size-dependent guard to get wrong.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gwen_tpu_torch.graph.graph import DiagWindowGraph
from gwen_tpu_torch.ops import cuda_lib, spmm_cuda
from gwen_tpu_torch.ops.cuda_lib import DTYPE_CODE, INT, PTR, CudaLib, fit_rows

Tensor = torch.Tensor

BLOCK = 128  # destination rows per graph block of the kernels
LIB = CudaLib(
    "window_unfused.cu",
    # (a, b, window_start, out, nb, num_blocks, window, f, a_rows, b_rows,
    #  dtype, stream)
    gwen_sddmm=[PTR] * 4 + [INT] * 7 + [PTR],
    # (s, g, window_start, t_lo, t_cnt, out, nb, num_blocks, ns_blocks,
    #  window, f, g_rows, dtype, stream)
    gwen_spmm_t=[PTR] * 6 + [INT] * 7 + [PTR],
)


# ------------------------------------------------------------ plain versions


def _window_rows(graph: DiagWindowGraph, device) -> Tensor:
    """The source row of every window column of every block, flat
    ``(num_blocks * W,)``."""
    return (graph.window_start.long()[:, None]
            + torch.arange(graph.window_size, device=device)).reshape(-1)


def sddmm_plain(graph: DiagWindowGraph, a: Tensor, b: Tensor) -> Tensor:
    """Plain version of :func:`sddmm` (the reference's
    ``diag_sddmm_reference``, vectorised over blocks): float32
    ``(..., N_pad, W)`` from ``a`` ``(..., ≤ N_pad, f)`` and ``b``
    ``(..., ≤ num_src_rows, f)``; missing rows read as zero."""
    blocks, block, w = graph.num_blocks, graph.block_size, graph.window_size
    lead, f = a.shape[:-2], a.shape[-1]
    at = fit_rows(a, graph.num_padded_nodes).float().reshape(
        *lead, blocks, block, f)
    bw = fit_rows(b, graph.num_src_rows).index_select(
        -2, _window_rows(graph, a.device)).float().reshape(*lead, blocks, w, f)
    return torch.matmul(at, bw.transpose(-1, -2)).reshape(
        *lead, graph.num_padded_nodes, w)


def spmm_t_plain(graph: DiagWindowGraph, s: Tensor, g: Tensor) -> Tensor:
    """Plain version of :func:`spmm_t` (``diag_spmm_t_reference``,
    vectorised): ``(..., num_src_rows, f)`` in g's type from ``s``
    ``(..., N_pad, W)`` (cast to g's type first) and ``g``
    ``(..., ≤ N_pad, f)``; products and the sum over blocks in float32,
    rounded once."""
    blocks, block, w = graph.num_blocks, graph.block_size, graph.window_size
    lead, f = g.shape[:-2], g.shape[-1]
    st = s.to(g.dtype).float().reshape(*lead, blocks, block, w)
    gt = fit_rows(g, graph.num_padded_nodes).float().reshape(
        *lead, blocks, block, f)
    tile = torch.matmul(st.transpose(-1, -2), gt)  # (..., blocks, W, f)
    out = tile.new_zeros(*lead, graph.num_src_rows, f)
    out = out.index_add(-2, _window_rows(graph, g.device),
                        tile.reshape(*lead, blocks * w, f))
    return out.to(g.dtype)


def matvec_plain(graph: DiagWindowGraph, s: Tensor, x: Tensor) -> Tensor:
    """Plain version of :func:`matvec` (``diag_matvec_reference`` at
    ``N_pad`` rows): ``s`` cast to x's type, float32 products, ``(N_pad,
    f)`` in x's type."""
    return spmm_cuda.window_spmm_plain(s, graph.window_start, x,
                                       graph.num_src_rows)


# ------------------------------------------------------------ kernel wrappers


def _check(graph: DiagWindowGraph, name: str, first: Tensor, second: Tensor,
           first_rows: int, second_rows: int, tables: bool) -> None:
    """Raise on operands the kernels do not take: both 2-d or both 3-d with
    the same items, float32 or bfloat16 alike, contiguous, on the device of
    the graph's tables, at most ``first_rows`` and ``second_rows`` rows, on
    a graph of 128-row blocks whose window is a multiple of 128."""
    if first.dim() not in (2, 3) or second.dim() != first.dim() or (
            first.shape[:-2] != second.shape[:-2]):
        raise ValueError(f"{name}: operands must both be 2-d or both 3-d "
                         f"with the same items; got {tuple(first.shape)} and "
                         f"{tuple(second.shape)}")
    if second.dtype not in DTYPE_CODE or first.dtype != second.dtype:
        raise TypeError(f"{name}: operands must both be float32 or both "
                        f"bfloat16; got {first.dtype} and {second.dtype}")
    if first.shape[-2] > first_rows or second.shape[-2] > second_rows:
        raise ValueError(f"{name}: operands of {first.shape[-2]} and "
                         f"{second.shape[-2]} rows; the graph allows "
                         f"{first_rows} and {second_rows}")
    if graph.block_size != BLOCK or graph.window_size % BLOCK:
        raise ValueError(f"{name}: the kernel takes {BLOCK}-row blocks and a "
                         f"window that is a multiple of {BLOCK}; the graph has "
                         f"block {graph.block_size}, window {graph.window_size}")
    ts = [first, second, graph.window_start]
    if tables:
        if graph.t_max == 0:
            raise ValueError(f"{name} needs the graph's transpose tables "
                             "(diag_transpose_tables)")
        ts += [graph.t_lo, graph.t_cnt]
    for t in ts:
        if t.device != first.device:
            raise ValueError(f"{name}: operand on {t.device}, expected "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _vec_pad(t: Tensor) -> Tensor:
    """``t`` with its last axis zero-padded to the kernels' 16-byte vector
    (zero features change no product)."""
    vec = 16 // t.element_size()
    rest = t.shape[-1] % vec
    return t if rest == 0 else F.pad(t, (0, vec - rest))


def sddmm(graph: DiagWindowGraph, a: Tensor, b: Tensor) -> Tensor:
    """Kernel B8: ``out[i, j] = a[i] · b[ws(i) + j]``, float32
    ``(N_pad, W)`` (or ``(nb, N_pad, W)`` for 3-d operands). ``a`` holds at
    most ``N_pad`` destination rows and ``b`` at most ``num_src_rows``
    source rows; missing rows read as zero."""
    if not cuda_lib.on_cuda(a, "SDDMM or transpose-SpMM"):
        return sddmm_plain(graph, a, b)
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"B8: feature widths {a.shape[-1]} and {b.shape[-1]}")
    _check(graph, "B8", a, b, graph.num_padded_nodes, graph.num_src_rows,
           tables=False)
    ap, bp = _vec_pad(a), _vec_pad(b)
    nb = a.shape[0] if a.dim() == 3 else 1
    out = torch.empty(*a.shape[:-2], graph.num_padded_nodes,
                      graph.window_size, dtype=torch.float32, device=a.device)
    rc = LIB().gwen_sddmm(
        ap.data_ptr(), bp.data_ptr(), graph.window_start.data_ptr(),
        out.data_ptr(), nb, graph.num_blocks, graph.window_size, ap.shape[-1],
        a.shape[-2], b.shape[-2], DTYPE_CODE[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("B8", rc)
    sddmm.launches += 1
    return out


def spmm_t(graph: DiagWindowGraph, s: Tensor, g: Tensor) -> Tensor:
    """Kernels B9 (2-d) and B9b (3-d, ``s`` and ``g`` both per item):
    ``out[j] = Σ_i s[i, j − ws(i)] · g[i]``, ``(num_src_rows, f)`` in g's
    type. ``s`` is ``(N_pad, W)`` and is cast to g's type first; ``g``
    holds at most ``N_pad`` rows."""
    if s.shape[-2:] != (graph.num_padded_nodes, graph.window_size):
        raise ValueError(
            f"B9: s must be (..., {graph.num_padded_nodes}, "
            f"{graph.window_size}); got {tuple(s.shape)}")
    if not cuda_lib.on_cuda(g, "SDDMM or transpose-SpMM"):
        return spmm_t_plain(graph, s, g)
    s = s.to(g.dtype)
    _check(graph, "B9", s, g, graph.num_padded_nodes, graph.num_padded_nodes,
           tables=True)
    gp = _vec_pad(g)
    f = g.shape[-1]
    ns_blocks = graph.t_lo.shape[0]
    if ns_blocks * BLOCK != graph.num_src_rows:
        raise ValueError(f"B9: {graph.num_src_rows} source rows are not "
                         f"{ns_blocks} blocks of {BLOCK}")
    nb = g.shape[0] if g.dim() == 3 else 1
    out = torch.empty(*g.shape[:-2], graph.num_src_rows, gp.shape[-1],
                      dtype=g.dtype, device=g.device)
    rc = LIB().gwen_spmm_t(
        s.data_ptr(), gp.data_ptr(), graph.window_start.data_ptr(),
        graph.t_lo.data_ptr(), graph.t_cnt.data_ptr(), out.data_ptr(), nb,
        graph.num_blocks, ns_blocks, graph.window_size, gp.shape[-1],
        g.shape[-2], DTYPE_CODE[g.dtype],
        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("B9", rc)
    spmm_t.launches += 1
    return out if gp.shape[-1] == f else out[..., :f]


def matvec(graph: DiagWindowGraph, s: Tensor, x: Tensor) -> Tensor:
    """``S @ X`` for a runtime window-relative ``s`` ``(N_pad, W)`` (cast to
    x's type) and ``x`` ``(≤ num_src_rows, f)``: ``(N_pad, f)`` in x's
    type. Kernel B1 on CUDA."""
    if not cuda_lib.on_cuda(x, "SDDMM or transpose-SpMM"):
        return matvec_plain(graph, s, x)
    f = x.shape[-1]
    xp = _vec_pad(x)
    out = spmm_cuda.window_matvec(s.to(x.dtype), graph, xp)
    return out if xp.shape[-1] == f else out[..., :f]


sddmm.launches = 0
spmm_t.launches = 0
