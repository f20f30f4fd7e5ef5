"""Windowed SpMM for the diag-window and banded layouts, weighted,
int8 rank-1 and bit-packed, for the windowed-dense and blocked-ELL layouts
of the partitioned path, and for the block-tile layout: hand-written Hopper
kernels (``csrc/window_spmm.cu``) and their plain PyTorch versions.

Eleven kernel wrappers (and :func:`window_matvec`, which counts as B1),
each with a launch count (``.launches``):

* :func:`diag_window_spmm` — kernel B1, replacing
  ``gwen_tpu/ops/spmm_pallas.py:_diag_kernel`` (through ``_diag_impl``):
  per destination block ``b``, ``S_b @ x[ws_b : ws_b + W]`` in float32,
  plus the escape fix rows of the block added in-kernel. A row gather
  (B11's, with an escape epilogue): one warp per destination row lists the
  nonzeros of its S row, then gathers their source rows, eight in flight,
  and adds the row's fix row before the single rounding.
* :func:`sliding_spmm` — kernel B3, replacing
  ``gwen_tpu/ops/spmm_pallas.py:_sliding_kernel`` (through
  ``_sliding_impl``): the same banded product with a start per block and no
  escapes. The reference keeps x in a VMEM ring buffer; the math is
  ``out_b = Σ_{s ∈ [ws_b, ws_b + W)} S_b[:, s − ws_b] x[s]``. The dense
  row gather's batch-1 walk at every window width (the esc2 contraction's
  384 columns, an RCM band's 1,664).
* :func:`diag_window_spmm_b` — kernel B4, replacing ``_diag_kernel_b``
  (through ``_diag_impl_b``): B1 on ``(B, N, F)``, the same row gather with
  the batch inside the warp.
* :func:`sliding_spmm_b` — kernel B10, replacing ``_sliding_kernel_b``
  (through ``_sliding_impl_b``): B3 on ``(B, N, F)``, B11's row gather at
  every window width, the batch inside the warp.
* :func:`diag_window_spmm_packed` and :func:`diag_window_spmm_packed_b` —
  the packed form of B1 and B4 (the ``packed`` branch of ``_diag_kernel``
  and ``_diag_kernel_b``): the set bits of S01 walked in the kernel, each
  weighted by its column scale ``a_s`` rounded to x's type; the row scale
  ``a_r`` after the escape rows are added. Both are B13's row gather over
  the set bits, with the same escape epilogue.
* :func:`sliding_packed_spmm` — kernel B13, replacing
  ``_sliding_packed_kernel`` (through ``_sliding_packed_impl``): the packed
  product on :class:`SlidingPackedGraph`, no escapes. The reference scales
  outside (``a ⊙ K01(a ⊙ x)``, x rounded after its scale); the port folds
  both scales into the kernel as packed B1 does (one rounding, and no pass
  over x or the output for them). A row gather: one warp per destination
  row walks the set bits of its 1,792-column window (at L7) and gathers
  only those source rows, for every batch item at once.
* :func:`windowed_dense_spmm` — kernel B11, replacing ``_sdense_kernel``
  (through ``_sdense_impl``): the dense scatter-matrix product with an
  absolute start per block. A row gather: each warp streams its S row once
  and gathers the source rows of its nonzeros for every batch item.
* :func:`block_ell_spmm` — kernel B12, replacing ``_kernel`` (through
  ``_spmm_impl``): the blocked-ELL gather-scale-sum.
* :func:`block_tiles_spmm` — kernel B14, replacing ``_tile_kernel``
  (through ``_spmm_tiles_impl``): the block-tile (BSR) product as a
  gather-scale-sum over the slots of each block's active tiles.
* :func:`sliding_rank1_spmm` — the int8 rank-1 form of B3 and B10
  (``spmm_pallas.spmm_sliding_rank1``, ``a ⊙ K(a ⊙ x)`` with K on the int8
  S01 of a :class:`SlidingRank1Graph`'s core): the dense row gather on the
  int8 S01 with both scales folded in, as the packed gathers fold theirs
  (each nonzero weighs its source's column scale, the sum its row's scale,
  both rounded to x's type, one rounding). The reference rounds ``a ⊙ x``,
  the product and the row scale each in x's type; in float32 the two agree
  to reassociation.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback.

Mixed operands: a float32 ``x`` on a bfloat16 ``S`` is taken as the
reference's kernels take it (S cast to x's type per tile, which is exact,
then a float32 product): an instantiation of the unpacked kernels that
reads S as bf16 and widens it as it is read, with no float32 copy of S.
The packed kernels build their weights in x's type whatever it is.
:func:`window_matvec` is B1 on a runtime S with no escapes (the forward of
``diag_matvec``).

What bounds the kernels on an H100: bytes. At L7 (W = 384, F = 256, bf16)
one diag-window aggregation must stream S (127 MB), x (84 MB, re-read by
overlapping windows mostly from L2) and the output (84 MB). B3 on a narrow
window (the esc2 contraction, a few MB a call) reads 7.9 MB of S for
about 2 nonzeros a row. Every form takes the row gathers, which read each
row's S or bits once (for a batch of up to four), gather only the source
rows of its nonzeros and multiply no zero. With one item a gather lists
the row's nonzeros first and then issues up to eight source rows' loads
together.

The graph-level composites :func:`spmm_diag_window`,
:func:`spmm_sliding_dense` and :func:`spmm_sliding_packed` follow
``spmm_pallas.spmm_diag_window`` / ``spmm_sliding_dense`` /
``spmm_sliding_packed``: escape fix rows come from the hierarchical
contraction (``x[esc2_src]`` → B3/B10 → ``[esc2_back]``) when the graph has
an ``esc2_graph``, else from the ELL gather; gathers stay plain torch. A
packed diag graph takes packed B1/B4 (its escape tables carry ``a_s``).
The composites are symmetric operators that are zero on padding rows, so
their gradient is the same composite applied to the cotangent (the
reference's ``_diag_comp_bwd``, ``_sliding_bwd`` and
``_sliding_packed_bwd``; ``a_r a_s ⊙ S01`` is symmetric too, and so is
the int8 rank-1 form); one ``torch.autograd.Function`` carries that. S and
the tables get no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from gwen_tpu_torch.graph.graph import (
    BlockEllGraph,
    BlockTileGraph,
    DiagWindowGraph,
    SlidingDenseGraph,
    SlidingPackedGraph,
    SlidingRank1Graph,
    WindowedDenseGraph,
    unpack_bits,
)
from gwen_tpu_torch.ops import cuda_lib
from gwen_tpu_torch.ops.cuda_lib import DTYPE_CODE, INT, PTR, CudaLib, fit_rows
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor

LIB = CudaLib(
    "window_spmm.cu",
    # (s, x, window_start, esc_ptr, esc_rows, fix, out, n_pad, window,
    #  block, f, x_rows, batch, n_fix, dtype, stream)
    gwen_window_spmm_streamed=[PTR] * 7 + [INT] * 8 + [PTR],
    # (bits, col_scale, row_scale, x, window_start, esc_ptr, esc_rows,
    #  fix, out, n_pad, words, block, f, x_rows, batch, n_fix, dtype,
    #  stream)
    gwen_sliding_packed_spmm=[PTR] * 9 + [INT] * 8 + [PTR],
    # (s, col_scale, row_scale, x, window_start, out, n_pad, window,
    #  block, f, x_rows, batch, dtype, stream)
    gwen_rank1_spmm=[PTR] * 6 + [INT] * 7 + [PTR],
    # (nbr, w, window_start, x, out, n_pad, deg, block, f, x_rows,
    #  batch, dtype, stream)
    gwen_ell_spmm=[PTR] * 5 + [INT] * 7 + [PTR],
    # (tile_idx, n_active, tnbr, tw, x, out, n_pad, tiles_max,
    #  tile_degree, block, f, x_rows, batch, dtype, stream)
    gwen_tile_spmm=[PTR] * 6 + [INT] * 8 + [PTR],
)


# ------------------------------------------------------------ plain versions


def window_spmm_plain(s_mat: Tensor, window_start: Tensor, x: Tensor,
                      src_rows: int, esc_rows: Optional[Tensor] = None,
                      fix: Optional[Tensor] = None,
                      row_scale: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of all the kernels: ``x`` is ``(rows, F)`` or
    ``(B, rows, F)``; the result is ``(..., N_pad, F)`` in ``x.dtype``.

    ``S`` is cast to ``x.dtype`` (as the reference kernels do), products
    and the escape add run in float32, each row is multiplied by
    ``row_scale`` (rounded to ``x.dtype``) if given, and the sum is cast
    once. Rows of x at or past ``x.shape[-2]`` read as zero (up to
    ``src_rows``).
    """
    nb = window_start.shape[0]
    w = s_mat.shape[1]
    block = s_mat.shape[0] // nb
    rows = x.shape[-2]
    if rows < src_rows:
        x = torch.cat([x, x.new_zeros(*x.shape[:-2], src_rows - rows,
                                      x.shape[-1])], dim=-2)
    idx = (window_start.long()[:, None]
           + torch.arange(w, device=x.device)[None, :])
    xw = x.index_select(-2, idx.reshape(-1)).float()
    xw = xw.reshape(*x.shape[:-2], nb, w, x.shape[-1])
    s = s_mat.to(x.dtype).float().reshape(nb, block, w)
    acc = torch.matmul(s, xw).reshape(*x.shape[:-2], nb * block, x.shape[-1])
    if fix is not None:
        acc = acc.index_add(-2, esc_rows, fix.float())
    if row_scale is not None:
        acc = acc * row_scale.to(x.dtype).float()[:, None]
    return acc.to(x.dtype)


def scaled_s(s01: Tensor, window_start: Tensor, col_scale: Tensor,
             dtype: torch.dtype) -> Tensor:
    """The ``(N_pad, W)`` S tile the packed and int8 rank-1 kernels weigh:
    the 0/1 pattern ``s01`` times the column scale of each window column,
    rounded to ``dtype``."""
    n_pad, w = s01.shape
    nb = window_start.shape[0]
    idx = window_start.long()[:, None] + torch.arange(w, device=s01.device)
    cs = col_scale.to(dtype)[idx]  # (nb, W)
    return (s01.reshape(nb, n_pad // nb, w) * cs[:, None, :]).reshape(n_pad, w)


def packed_s(bits: Tensor, window_start: Tensor, col_scale: Tensor,
             dtype: torch.dtype) -> Tensor:
    """The ``(N_pad, W)`` S tile the packed kernels build from the S01
    bits (see :func:`scaled_s`)."""
    return scaled_s(unpack_bits(bits), window_start, col_scale, dtype)


def diag_window_spmm_plain(graph: DiagWindowGraph, x: Tensor,
                           fix: Optional[Tensor]) -> Tensor:
    """Plain version of :func:`diag_window_spmm` and
    :func:`diag_window_spmm_b`."""
    return window_spmm_plain(
        graph.s_mat, graph.window_start, x, graph.num_src_rows,
        None if fix is None else graph.escape.rows, fix)


def sliding_spmm_plain(graph: SlidingDenseGraph, x: Tensor) -> Tensor:
    """Plain version of :func:`sliding_spmm` and :func:`sliding_spmm_b`."""
    return window_spmm_plain(graph.s_mat, graph.window_start, x,
                             graph.num_src_rows)


def diag_window_spmm_packed_plain(graph: DiagWindowGraph, x: Tensor,
                                  fix: Optional[Tensor]) -> Tensor:
    """Plain version of :func:`diag_window_spmm_packed` and
    :func:`diag_window_spmm_packed_b`."""
    s = packed_s(graph.s_pack, graph.window_start, graph.r1_col, x.dtype)
    return window_spmm_plain(
        s, graph.window_start, x, graph.num_src_rows,
        None if fix is None else graph.escape.rows, fix,
        row_scale=graph.r1_row)


def sliding_packed_spmm_plain(graph: SlidingPackedGraph, x: Tensor) -> Tensor:
    """Plain version of :func:`sliding_packed_spmm`."""
    s = packed_s(graph.s_pack, graph.window_start, graph.col_scale, x.dtype)
    return window_spmm_plain(s, graph.window_start, x, graph.num_src_rows,
                             row_scale=graph.row_scale)


def sliding_rank1_spmm_plain(graph: SlidingRank1Graph, x: Tensor) -> Tensor:
    """Plain version of :func:`sliding_rank1_spmm`: the int8 S01 weighted by
    the column scales, both scales rounded to ``x.dtype``, the sums in
    float32 times the row scale and rounded once. ``x`` is ``(rows, F)`` or
    ``(B, rows, F)``; rows at or past ``x.shape[-2]`` read as zero."""
    core = graph.core
    s = scaled_s(core.s_mat, core.window_start, graph.col_scale, x.dtype)
    return window_spmm_plain(s, core.window_start, x, core.num_src_rows,
                             row_scale=graph.row_scale)


def windowed_dense_spmm_plain(graph: WindowedDenseGraph, x: Tensor) -> Tensor:
    """Plain version of :func:`windowed_dense_spmm`."""
    return window_spmm_plain(graph.s_mat, graph.window_start, x,
                             graph.num_src_rows)


def block_ell_spmm_plain(graph: BlockEllGraph, x: Tensor) -> Tensor:
    """Plain version of :func:`block_ell_spmm`: per slot ``d``, the gathered
    source rows times the weights (rounded to ``x.dtype``), summed in
    float32 in slot order and cast once. ``x`` is ``(rows, F)`` or ``(B,
    rows, F)``; rows at or past ``x.shape[-2]`` read as zero."""
    x = fit_rows(x, graph.num_src_rows)
    start = graph.window_start.long().repeat_interleave(graph.block_size)
    w = graph.nbr_weight.to(x.dtype).float()
    acc = torch.zeros(*x.shape[:-2], graph.num_padded_nodes, x.shape[-1],
                      dtype=torch.float32, device=x.device)
    for d in range(graph.max_degree):
        rows = x.index_select(-2, start + graph.nbr[:, d].long()).float()
        acc += w[:, d, None] * rows
    return acc.to(x.dtype)


def block_tiles_spmm_plain(graph: BlockTileGraph, x: Tensor) -> Tensor:
    """Plain version of :func:`block_tiles_spmm`: per slot, the gathered
    source row (tile base from ``tile_idx``, plus the within-tile index)
    times the weight (rounded to ``x.dtype``), summed in float32 in slot
    order over the slots of active tiles, and cast once. ``x`` is ``(rows,
    F)`` or ``(B, rows, F)``; rows at or past ``x.shape[-2]`` read as
    zero."""
    x = fit_rows(x, graph.num_src_rows)
    block, deg = graph.block_size, graph.tile_degree
    n_pad = graph.num_padded_nodes
    blk = torch.arange(n_pad, device=x.device) // block
    w = graph.tw.to(x.dtype).float()
    acc = torch.zeros(*x.shape[:-2], n_pad, x.shape[-1], dtype=torch.float32,
                      device=x.device)
    for t in range(int(graph.n_active.max()) if graph.n_active.numel() else 0):
        active = (t < graph.n_active.long())[blk]
        base = graph.tile_idx[:, t].long()[blk] * block
        for k in range(t * deg, (t + 1) * deg):
            wk = torch.where(active, w[:, k], w.new_zeros(()))
            if not bool(wk.any()):
                continue
            rows = x.index_select(-2, base + graph.tnbr[:, k].long()).float()
            acc += wk[:, None] * rows
    return acc.to(x.dtype)


# ------------------------------------------------------------ kernel wrappers


def _check(x: Tensor, window_start: Tensor, n_pad: int, w: int,
           esc_ptr: Optional[Tensor], esc_rows: Optional[Tensor],
           fix: Optional[Tensor], layout: list, block: int) -> None:
    """Raise on operands the kernels do not take. ``layout`` holds the
    graph's tensors besides ``window_start`` (S, or the bits and scales);
    ``block`` is the rows per window start (the graph's own)."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (rows, F) or (B, rows, F); got shape "
                         f"{tuple(x.shape)} (fold other batched inputs into "
                         "one leading axis, as the graph-level composites do)")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"window SpMM kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    nb = window_start.shape[0]
    f = x.shape[-1]
    vec = 16 // x.element_size()
    if n_pad != nb * block:
        raise ValueError(f"the kernel takes {block}-row blocks; S has "
                         f"{n_pad} rows for {nb} blocks")
    if w % 32:
        raise ValueError(f"window {w} is not a multiple of 32")
    if f % vec:
        raise ValueError(f"F={f} must be a multiple of {vec} for "
                         f"{x.dtype}")
    if window_start.dtype != torch.int32:
        raise TypeError("window_start must be int32")
    ts = [*layout, window_start, x]
    if fix is not None:
        if esc_ptr is None or esc_rows is None:
            raise ValueError("escape fix rows need esc_ptr and esc_rows")
        if (fix.dtype != x.dtype or fix.shape[:-2] != x.shape[:-2]
                or fix.dim() != x.dim() or fix.shape[-1] != f):
            raise ValueError(f"fix must be (..., U, {f}) {x.dtype} with x's "
                             "leading axes")
        if esc_ptr.dtype != torch.int32 or esc_ptr.shape[0] != nb + 1:
            raise ValueError("esc_ptr must be int32 (num_blocks + 1,)")
        if esc_rows.dtype != torch.int64 or esc_rows.shape[0] != fix.shape[-2]:
            raise ValueError("esc_rows must be int64 with one row per fix row")
        ts += [esc_ptr, esc_rows, fix]
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("window SpMM operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("window SpMM operands must be 16-byte aligned")


def _kernel_code(s_dtype: torch.dtype, x: Tensor, streamed: bool = False) -> int:
    """The kernels' dtype code for an S of ``s_dtype`` and ``x``: 0 float32,
    1 bfloat16, 2 float32 x on a bfloat16 S, 3 (``streamed``: a launch with
    no escape rows, B11's operand) bfloat16 x on a float32 S, 4 and 5
    float32 and bfloat16 x on an int8 S (the 0/1 pattern of a rank-1
    layout; no escapes)."""
    if s_dtype == x.dtype and x.dtype in DTYPE_CODE:
        return DTYPE_CODE[x.dtype]
    if s_dtype == torch.int8 and x.dtype in DTYPE_CODE:
        return 4 + DTYPE_CODE[x.dtype]
    if s_dtype == torch.bfloat16 and x.dtype == torch.float32:
        return 2
    if streamed and s_dtype == torch.float32 and x.dtype == torch.bfloat16:
        return 3
    raise TypeError(f"S is {s_dtype} but x is {x.dtype}: the kernels take S "
                    "in x's type, a float32 x on a bfloat16 S, (B11) a "
                    "bfloat16 x on a float32 S, or (B3, B10) an int8 S")


def _escape_args(esc_ptr, esc_rows, fix) -> tuple:
    """The escape pointers and ``n_fix`` a launch passes: null pointers
    and 0 where there is no fix array."""
    if fix is None:
        return None, None, None, 0
    return esc_ptr.data_ptr(), esc_rows.data_ptr(), fix.data_ptr(), fix.shape[-2]


def _batch(x: Tensor) -> int:
    return x.shape[0] if x.dim() == 3 else 1


def _launch_streamed(s_mat: Tensor, window_start: Tensor, block: int,
                     x: Tensor, esc_ptr: Optional[Tensor] = None,
                     esc_rows: Optional[Tensor] = None,
                     fix: Optional[Tensor] = None) -> Tensor:
    """Check the operands and launch ``gwen_window_spmm_streamed``, the row
    gather on a dense S (``block`` rows per start; x ``(rows, F)`` or ``(B,
    rows, F)``, the batch inside the kernel), with B1's or B4's escape fix
    rows (``fix`` ``(..., U, F)`` with x's leading axes) where given. Raises
    on anything the kernel does not take."""
    n_pad, w = s_mat.shape
    _check(x, window_start, n_pad, w, esc_ptr, esc_rows, fix, [s_mat], block)
    # Escape rows with S in x's type or a bf16 S under a float32 x only.
    code = _kernel_code(s_mat.dtype, x, streamed=fix is None)
    if code >= 4 and fix is not None:
        raise ValueError("an int8 S takes no escape rows")
    out = torch.empty(*x.shape[:-2], n_pad, x.shape[-1], dtype=x.dtype,
                      device=x.device)
    esc_p, rows_p, fix_p, n_fix = _escape_args(esc_ptr, esc_rows, fix)
    rc = LIB().gwen_window_spmm_streamed(
        s_mat.data_ptr(), x.data_ptr(), window_start.data_ptr(), esc_p, rows_p,
        fix_p, out.data_ptr(), n_pad, w, block, x.shape[-1], x.shape[-2],
        _batch(x), n_fix, code, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("dense-row gather", rc)
    return out


def _check_scales(s01: Tensor, col_scale: Tensor, row_scale: Tensor,
                  src_rows: int, s_dtype: torch.dtype = torch.int32) -> None:
    """Raise unless ``s01`` (the S01 bits, or the int8 S01) is ``s_dtype``
    and the rank-1 scales are float32 and cover the source and destination
    rows."""
    n_pad = s01.shape[0]
    if s01.dtype != s_dtype:
        raise TypeError(f"S01 must be {s_dtype}, not {s01.dtype}")
    if col_scale.dtype != torch.float32 or row_scale.dtype != torch.float32:
        raise TypeError("the rank-1 scales must be float32")
    if col_scale.shape[0] < src_rows or row_scale.shape[0] < n_pad:
        raise ValueError(f"scales of {col_scale.shape[0]} source and "
                         f"{row_scale.shape[0]} destination rows; the graph "
                         f"has {src_rows} and {n_pad}")


def _launch_packed_rows(bits: Tensor, col_scale: Tensor, row_scale: Tensor,
                        window_start: Tensor, block: int, src_rows: int,
                        x: Tensor, esc_ptr: Optional[Tensor] = None,
                        esc_rows: Optional[Tensor] = None,
                        fix: Optional[Tensor] = None) -> Tensor:
    """Check the operands and launch ``gwen_sliding_packed_spmm``, the row
    gather over the set bits (``block`` rows per start; x ``(rows, F)`` or
    ``(B, rows, F)``, the batch inside the kernel), with packed B1's or B4's
    escape fix rows where given. Raises on anything the kernel does not
    take."""
    n_pad, words = bits.shape
    _check_scales(bits, col_scale, row_scale, src_rows)
    _check(x, window_start, n_pad, words * 32, esc_ptr, esc_rows, fix,
           [bits, col_scale, row_scale], block)
    out = torch.empty(*x.shape[:-2], n_pad, x.shape[-1], dtype=x.dtype,
                      device=x.device)
    esc_p, rows_p, fix_p, n_fix = _escape_args(esc_ptr, esc_rows, fix)
    rc = LIB().gwen_sliding_packed_spmm(
        bits.data_ptr(), col_scale.data_ptr(), row_scale.data_ptr(),
        x.data_ptr(), window_start.data_ptr(), esc_p, rows_p, fix_p,
        out.data_ptr(), n_pad, words, block, x.shape[-1], x.shape[-2],
        _batch(x), n_fix, DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("bit-row gather", rc)
    return out


def _check_dim(x: Tensor, dim: int, name: str) -> None:
    if x.dim() != dim:
        raise ValueError(f"{name} takes a {dim}-d x; got shape "
                         f"{tuple(x.shape)}")


def diag_window_spmm(graph: DiagWindowGraph, x: Tensor,
                     fix: Optional[Tensor] = None) -> Tensor:
    """Kernel B1: the diag-window product plus the escape fix rows
    (``fix``: ``(U, F)`` in receiver order, or None). ``(N_pad, F)``. The
    dense row gather's batch-1 walk with the graph's own block size."""
    _check_dim(x, 2, "B1")
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return diag_window_spmm_plain(graph, x, fix)
    out = _launch_streamed(graph.s_mat, graph.window_start, graph.block_size,
                           x, graph.esc_ptr,
                           None if fix is None else graph.escape.rows, fix)
    diag_window_spmm.launches += 1
    return out


def diag_window_spmm_b(graph: DiagWindowGraph, x: Tensor,
                       fix: Optional[Tensor] = None) -> Tensor:
    """Kernel B4: B1 on ``(B, rows, F)`` with fix ``(B, U, F)``, on the
    dense row gather with the graph's own block size. ``(B, N_pad, F)``."""
    _check_dim(x, 3, "B4")
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return diag_window_spmm_plain(graph, x, fix)
    out = _launch_streamed(graph.s_mat, graph.window_start, graph.block_size,
                           x, graph.esc_ptr,
                           None if fix is None else graph.escape.rows, fix)
    diag_window_spmm_b.launches += 1
    return out


def window_matvec(s_mat: Tensor, graph: DiagWindowGraph, x: Tensor) -> Tensor:
    """Kernel B1 on a runtime ``s_mat`` ``(N_pad, W)`` in place of the
    graph's, with no escape rows: ``S_b @ x[ws_b : ws_b + W]`` per block,
    ``(N_pad, F)`` in x's type. x is ``(rows, F)`` with at most
    ``num_src_rows`` rows; F a multiple of the kernel's vector width. The
    dense row gather: it gathers a source row per nonzero of ``s_mat`` (the
    attention probabilities are zero off the window's mask)."""
    _check_dim(x, 2, "B1")
    if s_mat.shape != (graph.num_padded_nodes, graph.window_size):
        raise ValueError(f"s must be {(graph.num_padded_nodes, graph.window_size)}"
                         f"; got {tuple(s_mat.shape)}")
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return window_spmm_plain(s_mat, graph.window_start, x,
                                 graph.num_src_rows)
    out = _launch_streamed(s_mat, graph.window_start, graph.block_size, x)
    diag_window_spmm.launches += 1
    return out


def sliding_spmm(graph: SlidingDenseGraph, x: Tensor) -> Tensor:
    """Kernel B3: the banded product (no escapes). ``(N_pad, F)``. The dense
    row gather's batch-1 walk at every window width (the esc2 contraction,
    the RCM band of a partition), with the graph's own block size."""
    _check_dim(x, 2, "B3")
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return sliding_spmm_plain(graph, x)
    out = _launch_streamed(graph.s_mat, graph.window_start, graph.block_size, x)
    sliding_spmm.launches += 1
    return out


def sliding_spmm_b(graph: SlidingDenseGraph, x: Tensor) -> Tensor:
    """Kernel B10: B3 on ``(B, rows, F)``. ``(B, N_pad, F)``. B11's row
    gather at every window width, the batch inside the kernel."""
    _check_dim(x, 3, "B10")
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return sliding_spmm_plain(graph, x)
    out = _launch_streamed(graph.s_mat, graph.window_start, graph.block_size, x)
    sliding_spmm_b.launches += 1
    return out


def windowed_dense_spmm(graph: WindowedDenseGraph, x: Tensor) -> Tensor:
    """Kernel B11: ``S_b @ x[ws_b : ws_b + W]`` per block, x ``(rows, F)`` or
    ``(B, rows, F)`` with at most ``num_src_rows`` rows (missing rows read
    as zero). ``(..., N_pad, F)`` in x's type; S in x's type, bfloat16
    under a float32 x or float32 under a bfloat16 x."""
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return windowed_dense_spmm_plain(graph, x)
    if x.shape[-2] > graph.num_src_rows:
        raise ValueError(f"x has {x.shape[-2]} rows; the layout reads "
                         f"{graph.num_src_rows} source rows")
    out = _launch_streamed(graph.s_mat, graph.window_start, graph.block_size, x)
    windowed_dense_spmm.launches += 1
    return out


def block_ell_spmm(graph: BlockEllGraph, x: Tensor) -> Tensor:
    """Kernel B12: ``out[i] = Σ_d w[i, d] · x[ws(i) + nbr[i, d]]``, x
    ``(rows, F)`` or ``(B, rows, F)`` with at most ``num_src_rows`` rows
    (missing rows read as zero). ``(..., N_pad, F)`` in x's type."""
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return block_ell_spmm_plain(graph, x)
    n_pad, deg = graph.nbr.shape
    if x.dim() not in (2, 3) or x.dtype not in DTYPE_CODE:
        raise ValueError(f"B12 takes a float32 or bfloat16 (rows, F) or (B, "
                         f"rows, F); got {x.dtype} {tuple(x.shape)}")
    f = x.shape[-1]
    if f % (16 // x.element_size()):
        raise ValueError(f"F={f} must be a multiple of "
                         f"{16 // x.element_size()} for {x.dtype}")
    if (graph.nbr.dtype != torch.int32 or graph.window_start.dtype != torch.int32
            or graph.nbr_weight.dtype != torch.float32
            or graph.nbr_weight.shape != graph.nbr.shape
            or graph.window_start.shape[0] * graph.block_size != n_pad):
        raise ValueError("B12 takes int32 nbr (N_pad, D) and window_start "
                         "(N_pad / block,), float32 nbr_weight (N_pad, D)")
    if x.shape[-2] > graph.num_src_rows:
        raise ValueError(f"x has {x.shape[-2]} rows; the layout reads "
                         f"{graph.num_src_rows} source rows")
    for t in (graph.nbr, graph.nbr_weight, graph.window_start, x):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("B12 operands must be contiguous, 16-byte "
                             f"aligned and on {x.device}")
    out = torch.empty(*x.shape[:-2], n_pad, f, dtype=x.dtype, device=x.device)
    rc = LIB().gwen_ell_spmm(
        graph.nbr.data_ptr(), graph.nbr_weight.data_ptr(),
        graph.window_start.data_ptr(), x.data_ptr(), out.data_ptr(), n_pad,
        deg, graph.block_size, f, x.shape[-2],
        x.shape[0] if x.dim() == 3 else 1, DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("B12", rc)
    block_ell_spmm.launches += 1
    return out


def block_tiles_spmm(graph: BlockTileGraph, x: Tensor) -> Tensor:
    """Kernel B14: ``out[i] = Σ_{t < n_active[b]} Σ_d tw[i, tD+d] ·
    x[tile_idx[b, t]·block + tnbr[i, tD+d]]`` with ``b = i // block``, x
    ``(rows, F)`` or ``(B, rows, F)`` with at most ``num_src_rows`` rows
    (missing rows read as zero). ``(..., N_pad, F)`` in x's type."""
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return block_tiles_spmm_plain(graph, x)
    n_pad, flat = graph.tnbr.shape
    if x.dim() not in (2, 3) or x.dtype not in DTYPE_CODE:
        raise ValueError(f"B14 takes a float32 or bfloat16 (rows, F) or (B, "
                         f"rows, F); got {x.dtype} {tuple(x.shape)}")
    f = x.shape[-1]
    if f % (16 // x.element_size()):
        raise ValueError(f"F={f} must be a multiple of "
                         f"{16 // x.element_size()} for {x.dtype}")
    nb = n_pad // graph.block_size
    if (graph.tile_idx.dtype != torch.int32 or graph.n_active.dtype != torch.int32
            or graph.tnbr.dtype != torch.uint8 or graph.tw.dtype != torch.float32
            or graph.tw.shape != graph.tnbr.shape
            or flat != graph.tiles_max * graph.tile_degree
            or tuple(graph.tile_idx.shape) != (nb, graph.tiles_max)
            or tuple(graph.n_active.shape) != (nb,)
            or nb * graph.block_size != n_pad):
        raise ValueError(
            "B14 takes int32 tile_idx (N_pad / block, tiles_max) and n_active "
            "(N_pad / block,), uint8 tnbr and float32 tw (N_pad, tiles_max · "
            "tile_degree)")
    if x.shape[-2] > graph.num_src_rows:
        raise ValueError(f"x has {x.shape[-2]} rows; the layout reads "
                         f"{graph.num_src_rows} source rows")
    for t in (graph.tile_idx, graph.n_active, graph.tnbr, graph.tw, x):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("B14 operands must be contiguous, 16-byte "
                             f"aligned and on {x.device}")
    out = torch.empty(*x.shape[:-2], n_pad, f, dtype=x.dtype, device=x.device)
    rc = LIB().gwen_tile_spmm(
        graph.tile_idx.data_ptr(), graph.n_active.data_ptr(),
        graph.tnbr.data_ptr(), graph.tw.data_ptr(), x.data_ptr(),
        out.data_ptr(), n_pad, graph.tiles_max, graph.tile_degree,
        graph.block_size, f, x.shape[-2], x.shape[0] if x.dim() == 3 else 1,
        DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("B14", rc)
    block_tiles_spmm.launches += 1
    return out


def diag_window_spmm_packed(graph: DiagWindowGraph, x: Tensor,
                            fix: Optional[Tensor] = None) -> Tensor:
    """Packed B1: the diag-window product from the S01 bits and rank-1
    scales, plus the escape fix rows (``(U, F)``, built with ``w = a_s``).
    ``(N_pad, F)``. The bit-row gather's batch-1 walk with the graph's own
    block size."""
    _check_dim(x, 2, "packed B1")
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return diag_window_spmm_packed_plain(graph, x, fix)
    out = _launch_packed_rows(graph.s_pack, graph.r1_col, graph.r1_row,
                              graph.window_start, graph.block_size,
                              graph.num_src_rows, x, graph.esc_ptr,
                              None if fix is None else graph.escape.rows, fix)
    diag_window_spmm_packed.launches += 1
    return out


def diag_window_spmm_packed_b(graph: DiagWindowGraph, x: Tensor,
                              fix: Optional[Tensor] = None) -> Tensor:
    """Packed B4: packed B1 on ``(B, rows, F)`` with fix ``(B, U, F)``, on
    the row gather over the set bits (B13's) with the graph's own block
    size. ``(B, N_pad, F)``."""
    _check_dim(x, 3, "packed B4")
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return diag_window_spmm_packed_plain(graph, x, fix)
    out = _launch_packed_rows(graph.s_pack, graph.r1_col, graph.r1_row,
                              graph.window_start, graph.block_size,
                              graph.num_src_rows, x, graph.esc_ptr,
                              None if fix is None else graph.escape.rows, fix)
    diag_window_spmm_packed_b.launches += 1
    return out


def sliding_packed_spmm(graph: SlidingPackedGraph, x: Tensor) -> Tensor:
    """Kernel B13: ``a ⊙ S01·(a ⊙ x)`` on the bit-packed banded layout, x
    ``(rows, F)`` or ``(B, rows, F)`` with at most ``num_src_rows`` rows
    (missing rows read as zero). ``(..., N_pad, F)``."""
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return sliding_packed_spmm_plain(graph, x)
    if x.shape[-2] > graph.num_src_rows:
        raise ValueError(f"x has {x.shape[-2]} rows; the layout reads "
                         f"{graph.num_src_rows} source rows")
    out = _launch_packed_rows(graph.s_pack, graph.col_scale, graph.row_scale,
                              graph.window_start, graph.block_size,
                              graph.num_src_rows, x)
    sliding_packed_spmm.launches += 1
    return out


def sliding_rank1_spmm(graph: SlidingRank1Graph, x: Tensor) -> Tensor:
    """The int8 rank-1 form of B3 (x ``(rows, F)``) and B10 (x ``(B, rows,
    F)``): ``out[i] = T(a_r[i]) · Σ T(a_s[c]) · x[c]`` over the nonzeros of
    row i of the core's int8 S01, in float32 and rounded once (``T()``
    rounds to x's type). ``(..., N_pad, F)``. The dense row gather with both
    scales folded in, the graph's own block size."""
    if not cuda_lib.on_cuda(x, "window SpMM"):
        return sliding_rank1_spmm_plain(graph, x)
    core = graph.core
    n_pad, w = core.s_mat.shape
    _check_scales(core.s_mat, graph.col_scale, graph.row_scale,
                  core.num_src_rows, torch.int8)
    _check(x, core.window_start, n_pad, w, None, None, None,
           [core.s_mat, graph.col_scale, graph.row_scale], core.block_size)
    out = torch.empty(*x.shape[:-2], n_pad, x.shape[-1], dtype=x.dtype,
                      device=x.device)
    rc = LIB().gwen_rank1_spmm(
        core.s_mat.data_ptr(), graph.col_scale.data_ptr(),
        graph.row_scale.data_ptr(), x.data_ptr(), core.window_start.data_ptr(),
        out.data_ptr(), n_pad, w, core.block_size, x.shape[-1], x.shape[-2],
        _batch(x), _kernel_code(core.s_mat.dtype, x),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise cuda_lib.launch_failed("int8 rank-1 row gather", rc)
    sliding_rank1_spmm.launches += 1
    return out


diag_window_spmm.launches = 0
diag_window_spmm_b.launches = 0
sliding_spmm.launches = 0
sliding_spmm_b.launches = 0
diag_window_spmm_packed.launches = 0
diag_window_spmm_packed_b.launches = 0
sliding_packed_spmm.launches = 0
windowed_dense_spmm.launches = 0
block_ell_spmm.launches = 0
block_tiles_spmm.launches = 0
sliding_rank1_spmm.launches = 0


# ------------------------------------------------------------ composites


def _escape_rows_fix(nbr: Tensor, w: Tensor, x: Tensor) -> Tensor:
    """Escape contributions per unique receiver: ``x[..., nbr, :]`` + ELL
    contraction. nbr/w ``(U, deg)``, x ``(..., N, F)`` → ``(..., U, F)``."""
    gathered = x[..., nbr, :]  # (..., U, deg, F)
    return torch.einsum("ud,...udf->...uf", w.to(x.dtype), gathered)


def _sliding_escape_add(graph, x: Tensor, out: Tensor) -> Tensor:
    """``out`` plus the escape edges of ``graph.escape`` (ELL gather and a
    scatter-add onto the unique receiver rows), if the layout has any."""
    esc = getattr(graph, "escape", None)
    if esc is None:
        return out
    fix = _escape_rows_fix(esc.nbr, esc.w, x)
    return out.index_add(-2, esc.rows, fix.to(out.dtype))


def _check_rows(graph, x: Tensor) -> int:
    """Validate x's row count; return the output row count (the caller's
    own row count for pre-padded inputs, else ``num_nodes``)."""
    n = x.shape[-2]
    n_pad, src = graph.num_padded_nodes, graph.num_src_rows
    if n not in (graph.num_nodes, n_pad, src):
        raise ValueError(
            f"x has {n} node rows; graph expects {graph.num_nodes} "
            f"({n_pad} padded dst, {src} src)")
    return n if n in (n_pad, src) else graph.num_nodes


def _fold(x: Tensor) -> tuple[Tensor, tuple, int]:
    """``x`` ``(..., N, F)`` as the kernels take it: the leading axes folded
    into one item axis (none stays 2-d) and, on a CUDA tensor, F zero-padded
    up to the kernels' 16-byte vector (4 float32, 8 bf16). Returns the
    folded tensor, the leading shape and F, for :func:`_unfold`."""
    lead, f = tuple(x.shape[:-2]), x.shape[-1]
    if len(lead) > 1:
        x = x.reshape(-1, *x.shape[-2:])
    vec = 16 // x.element_size()
    if x.device.type != "cpu" and f % vec:
        x = torch.nn.functional.pad(x, (0, vec - f % vec))
    return x.contiguous(), lead, f


def _unfold(out: Tensor, lead: tuple, f: int) -> Tensor:
    """Undo :func:`_fold` on an aggregation's result."""
    if out.shape[-1] != f:
        out = out[..., :f]
    return out.reshape(*lead, *out.shape[-2:]) if len(lead) > 1 else out


def _sliding_composite(graph: SlidingDenseGraph, x: Tensor,
                       plain: bool) -> Tensor:
    out_rows = _check_rows(graph, x)
    if plain:
        b3 = sliding_spmm_plain
    else:
        b3 = sliding_spmm_b if x.dim() == 3 else sliding_spmm
    return _sliding_escape_add(graph, x, b3(graph, x)[..., :out_rows, :])


def _sliding_packed_composite(graph: SlidingPackedGraph, x: Tensor,
                              plain: bool) -> Tensor:
    out_rows = _check_rows(graph, x)
    b13 = sliding_packed_spmm_plain if plain else sliding_packed_spmm
    return b13(graph, x)[..., :out_rows, :]


def _rank1_composite(graph: SlidingRank1Graph, x: Tensor, plain: bool) -> Tensor:
    out_rows = _check_rows(graph, x)
    k = sliding_rank1_spmm_plain if plain else sliding_rank1_spmm
    return k(graph, x)[..., :out_rows, :]


def _ext_rows(graph, x: Tensor) -> int:
    """Row check and output row count of the windowed-dense and blocked-ELL
    layouts, as the reference's: a plain graph keeps the caller's row
    count, halo-extended sources always give the padded destination rows."""
    _check_rows(graph, x)
    n_pad = graph.num_padded_nodes
    return x.shape[-2] if graph.num_src_rows == n_pad else n_pad


def _windowed_dense_composite(graph: WindowedDenseGraph, x: Tensor,
                              plain: bool) -> Tensor:
    b11 = windowed_dense_spmm_plain if plain else windowed_dense_spmm
    return b11(graph, x)[..., :_ext_rows(graph, x), :]


def _block_ell_composite(graph: BlockEllGraph, x: Tensor, plain: bool) -> Tensor:
    b12 = block_ell_spmm_plain if plain else block_ell_spmm
    return b12(graph, x)[..., :_ext_rows(graph, x), :]


def _block_tiles_composite(graph: BlockTileGraph, x: Tensor,
                           plain: bool) -> Tensor:
    b14 = block_tiles_spmm_plain if plain else block_tiles_spmm
    return b14(graph, x)[..., :_ext_rows(graph, x), :]


def _diag_composite(graph: DiagWindowGraph, x: Tensor, plain: bool) -> Tensor:
    out_rows = _check_rows(graph, x)
    batched = x.dim() == 3
    packed = graph.s_pack is not None
    if plain:
        b1 = diag_window_spmm_packed_plain if packed else diag_window_spmm_plain
        b3 = sliding_spmm_plain
    elif batched:
        b1 = diag_window_spmm_packed_b if packed else diag_window_spmm_b
        b3 = sliding_spmm_b
    else:
        b1 = diag_window_spmm_packed if packed else diag_window_spmm
        b3 = sliding_spmm
    fix = None
    if graph.esc2_graph is not None:
        xc2 = x.index_select(-2, graph.esc2_src)
        fix = b3(graph.esc2_graph, xc2).index_select(-2, graph.esc2_back)
    elif graph.escape is not None:
        esc = graph.escape
        fix = _escape_rows_fix(esc.nbr, esc.w, x).to(x.dtype).contiguous()
    return b1(graph, x, fix)[..., :out_rows, :]


class _SymmetricAggregation(torch.autograd.Function):
    """A composite aggregation ``A·x`` whose operator is symmetric and zero
    on padding rows and columns: its x-gradient is ``A·g`` on the
    cotangent, cut or padded to x's rows — the same kernels again."""

    @staticmethod
    def forward(ctx, x, composite, graph):
        ctx.composite, ctx.graph, ctx.rows = composite, graph, x.shape[-2]
        return composite(graph, x, False)

    @staticmethod
    def backward(ctx, g):
        with annotate("gwen.op.aggregate.bwd"):
            gx = ctx.composite(ctx.graph, g.contiguous(), False)
            return fit_rows(gx, ctx.rows).to(g.dtype), None, None


def _aggregate(composite, graph, x: Tensor, plain: bool) -> Tensor:
    """``composite`` on ``x`` ``(..., N, F)`` with any leading axes and any
    F (see :func:`_fold`)."""
    xf, lead, f = _fold(x)
    if plain:
        out = composite(graph, xf, True)
    else:
        out = _SymmetricAggregation.apply(xf, composite, graph)
    return _unfold(out, lead, f)


def spmm_sliding_dense(graph: SlidingDenseGraph, x: Tensor,
                       plain: bool = False) -> Tensor:
    """Banded aggregation over a :class:`SlidingDenseGraph` (kernel B3, or
    B10 on ``(..., N, F)`` with leading axes, on CUDA), plus its escape
    edges. Differentiable in x; ``plain=True`` runs the plain versions and
    leaves the gradient to autograd."""
    return _aggregate(_sliding_composite, graph, x, plain)


def spmm_diag_window(graph: DiagWindowGraph, x: Tensor,
                     plain: bool = False) -> Tensor:
    """Diag-window aggregation (kernel B1, or B4 on ``(..., N, F)`` with
    leading axes, which fold into one batch axis, on CUDA) with its escape
    edges. Any F (zero-padded to the kernels' vector width on CUDA), and a
    float32 x on a bfloat16 graph, as the reference takes them.

    The fix rows come from the hierarchical contraction when the graph has
    an ``esc2_graph`` (gather, kernel B3/B10, gather back), else from the
    ELL gather; B1/B4 place them in-kernel. Differentiable in x: the
    backward runs the same composite on the cotangent. ``plain=True`` takes
    the same path with each kernel replaced by its plain version and leaves
    the gradient to autograd. Pre-padded inputs (``num_padded_nodes`` or
    ``num_src_rows`` rows) keep their row count; the kernels read only rows
    below ``num_src_rows``."""
    return _aggregate(_diag_composite, graph, x, plain)


def spmm_sliding_packed(graph: SlidingPackedGraph, x: Tensor,
                        plain: bool = False) -> Tensor:
    """Bit-packed banded aggregation (kernel B13 on CUDA) on ``(..., N,
    F)``. Differentiable in x: ``a ⊙ S01 ⊙ a`` is symmetric, so the
    backward is B13 on the cotangent (the reference's
    ``_sliding_packed_bwd``). ``plain=True`` runs the plain version and
    leaves the gradient to autograd."""
    return _aggregate(_sliding_packed_composite, graph, x, plain)


def _aggregate_ext(composite, graph, x: Tensor, plain: bool) -> Tensor:
    """:func:`_aggregate` for a layout whose source array may be longer than
    its output. Such an operator is not square, so the symmetric backward
    does not hold: the plain versions leave the gradient to autograd, and
    on the kernels a gradient is refused (it belongs to the halo composite,
    :func:`gwen_tpu_torch.parallel.halo.aggregate_halo`)."""
    if graph.num_src_rows == graph.num_padded_nodes:
        return _aggregate(composite, graph, x, plain)
    if (x.requires_grad and torch.is_grad_enabled() and not plain
            and x.device.type != "cpu"):
        raise ValueError(
            f"{type(graph).__name__} with {graph.num_src_rows} source rows "
            f"for {graph.num_padded_nodes} destination rows is not square: "
            "its kernel has no gradient of its own (the halo composite "
            "carries it)")
    xf, lead, f = _fold(x)
    return _unfold(composite(graph, xf, plain), lead, f)


def spmm_windowed_dense(graph: WindowedDenseGraph, x: Tensor,
                        plain: bool = False) -> Tensor:
    """Aggregation over a :class:`WindowedDenseGraph` (kernel B11 on CUDA)
    on ``(..., N, F)``. On a square graph differentiable in x (the backward
    is B11 on the cotangent, the reference's ``_sdense_bwd``);
    ``plain=True`` runs the plain version and leaves the gradient to
    autograd."""
    return _aggregate_ext(_windowed_dense_composite, graph, x, plain)


def spmm_block_ell(graph: BlockEllGraph, x: Tensor, plain: bool = False) -> Tensor:
    """Aggregation over a :class:`BlockEllGraph` (kernel B12 on CUDA) on
    ``(..., N, F)``. On a square graph differentiable in x (the backward is
    B12 on the cotangent, the reference's ``_spmm_bwd``); ``plain=True``
    runs the plain version and leaves the gradient to autograd."""
    return _aggregate_ext(_block_ell_composite, graph, x, plain)


def spmm_block_tiles(graph: BlockTileGraph, x: Tensor, plain: bool = False) -> Tensor:
    """Aggregation over a :class:`BlockTileGraph` (kernel B14 on CUDA) on
    ``(..., N, F)``. On a square graph differentiable in x (the backward is
    B14 on the cotangent, the reference's ``_spmm_tiles_bwd``);
    ``plain=True`` runs the plain version and leaves the gradient to
    autograd."""
    return _aggregate_ext(_block_tiles_composite, graph, x, plain)


def spmm_sliding_rank1(graph: SlidingRank1Graph, x: Tensor,
                       plain: bool = False) -> Tensor:
    """int8 rank-1 banded aggregation ``a ⊙ K(a ⊙ x)`` on ``(..., N, F)``,
    K the banded product on the int8 S01 of ``graph.core``: one launch of
    :func:`sliding_rank1_spmm` (B3's or, with leading axes, B10's int8 form)
    with both scales inside, rounded to x's type, and one rounding of the
    result (the reference's ``spmm_sliding_rank1`` rounds ``a ⊙ x``, the
    product and the row scale each). Differentiable in x: ``a ⊙ S01 ⊙ a``
    is symmetric, so the backward is the same kernel on the cotangent.
    ``plain=True`` runs the plain version and leaves the gradient to
    autograd."""
    return _aggregate(_rank1_composite, graph, x, plain)
