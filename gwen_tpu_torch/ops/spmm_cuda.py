"""Windowed SpMM for the diag-window and banded layouts: hand-written
Hopper kernels (``csrc/window_spmm.cu``) and their plain PyTorch versions.

Four kernel wrappers, each with a launch count (``.launches``):

* :func:`diag_window_spmm` — kernel B1, replacing
  ``gwen_tpu/ops/spmm_pallas.py:_diag_kernel`` (through ``_diag_impl``):
  per 128-row destination block ``b``, ``S_b (128, W) @ x[ws_b : ws_b + W]``
  in float32, plus the escape fix rows of the block placed in-kernel.
* :func:`sliding_spmm` — kernel B3, replacing
  ``gwen_tpu/ops/spmm_pallas.py:_sliding_kernel`` (through
  ``_sliding_impl``): the same banded product with a start per block and no
  escapes. The reference keeps x in a VMEM ring buffer; the math is
  ``out_b = Σ_{s ∈ [ws_b, ws_b + W)} S_b[:, s − ws_b] x[s]``.
* :func:`diag_window_spmm_b` — kernel B4, replacing ``_diag_kernel_b``
  (through ``_diag_impl_b``): B1 on ``(B, N, F)``; each CTA stages its S
  tile once and loops over the batch.
* :func:`sliding_spmm_b` — kernel B10, replacing ``_sliding_kernel_b``
  (through ``_sliding_impl_b``): B3 on ``(B, N, F)``, the batched kernel
  without escapes.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback.

What bounds the kernels on an H100: bytes. At L7 (W = 384, F = 256, bf16)
one aggregation does 32 GFLOP on the tensor cores but must stream S
(127 MB), x (84 MB, re-read by overlapping windows mostly from L2) and the
output (84 MB) — about 108 flop/byte, well under the ~295 flop/byte at
which an H100 turns compute-bound. The design therefore keeps the products
on the tensor cores (``mma.sync`` through WMMA, float32 accumulation) and
lays the grid out so the four 64-column tiles of one destination block run
next to each other and share its S tile in L2; the batched kernels read S
once per block and tile for the whole batch. Further work (TMA, ``wgmma``,
one CTA per block over all F) is for later PRs.

The graph-level composites :func:`spmm_diag_window` and
:func:`spmm_sliding_dense` follow ``spmm_pallas.spmm_diag_window`` /
``spmm_sliding_dense``: escape fix rows come from the hierarchical
contraction (``x[esc2_src]`` → B3/B10 → ``[esc2_back]``) when the graph has
an ``esc2_graph``, else from the ELL gather; gathers stay plain torch. Both
composites are symmetric operators that are zero on padding rows, so their
gradient is the same composite applied to the cotangent (the reference's
``_diag_comp_bwd`` and ``_sliding_bwd``); one ``torch.autograd.Function``
carries that. S and the tables get no gradient.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from gwen_tpu_torch.graph.graph import DiagWindowGraph, SlidingDenseGraph

Tensor = torch.Tensor

BLOCK = 128  # destination rows per graph block, fixed in the kernel
MAX_SMEM = 232_448  # dynamic shared memory one H100 block may use
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "window_spmm.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None


# ------------------------------------------------------------ build and bind


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in csrc/")
    return nvcc


def nvcc_build(src: Path) -> tuple[Path, str]:
    """Compile the CUDA source ``src`` for sm_90a into a shared library in
    ``_build/`` (once per source hash). Returns the library path and the
    compiler's output (ptxas register and shared-memory use; empty when
    already built)."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def build() -> tuple[Path, str]:
    """Compile ``csrc/window_spmm.cu`` (see :func:`nvcc_build`)."""
    return nvcc_build(_SRC)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # (s, x, window_start, esc_ptr, esc_rows, fix, out,
        #  num_blocks, window, f, x_rows, dtype_code, stream)
        lib.gwen_window_spmm.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                         ci, ci, ci, ci, ci, vp]
        lib.gwen_window_spmm.restype = ci
        # (..., num_blocks, window, f, x_rows, batch, n_fix, dtype, stream)
        lib.gwen_window_spmm_batched.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                 ci, ci, ci, ci, ci, ci, ci,
                                                 vp]
        lib.gwen_window_spmm_batched.restype = ci
        lib.gwen_window_spmm_batched_smem.argtypes = [ci, ci]
        lib.gwen_window_spmm_batched_smem.restype = ci
        _LIB = lib
    return _LIB


# ------------------------------------------------------------ plain versions


def window_spmm_plain(s_mat: Tensor, window_start: Tensor, x: Tensor,
                      src_rows: int, esc_rows: Optional[Tensor] = None,
                      fix: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of all four kernels: ``x`` is ``(rows, F)`` or
    ``(B, rows, F)``; the result is ``(..., N_pad, F)`` in ``x.dtype``.

    ``S`` is cast to ``x.dtype`` (as the reference kernels do), products
    and the escape add run in float32, and the sum is cast once. Rows of x
    at or past ``x.shape[-2]`` read as zero (up to ``src_rows``).
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
    return acc.to(x.dtype)


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


# ------------------------------------------------------------ kernel wrappers


def _launch(s_mat: Tensor, window_start: Tensor, x: Tensor,
            esc_ptr: Optional[Tensor], esc_rows: Optional[Tensor],
            fix: Optional[Tensor]) -> Tensor:
    """Check the operands and launch ``gwen_window_spmm`` (x ``(rows, F)``)
    or ``gwen_window_spmm_batched`` (x ``(B, rows, F)``) on the current
    stream. Raises on anything the kernels do not take."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (rows, F) or (B, rows, F); got shape "
                         f"{tuple(x.shape)} (fold other batched inputs into "
                         "one leading axis)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"window SpMM kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if s_mat.dtype != x.dtype:
        raise TypeError(f"S is {s_mat.dtype} but x is {x.dtype}; build the "
                        "graph with dtype=x.dtype")
    batched = x.dim() == 3
    nb = window_start.shape[0]
    n_pad, w = s_mat.shape
    f = x.shape[-1]
    vec = 16 // x.element_size()
    if n_pad != nb * BLOCK:
        raise ValueError(f"the kernel takes {BLOCK}-row blocks; S has "
                         f"{n_pad} rows for {nb} blocks")
    if w % 32:
        raise ValueError(f"window {w} is not a multiple of 32")
    if f % vec:
        raise ValueError(f"F={f} must be a multiple of {vec} for "
                         f"{x.dtype}")
    if window_start.dtype != torch.int32:
        raise TypeError("window_start must be int32")
    ts = [s_mat, window_start, x]
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
    lib = _lib()
    code = _DTYPE_CODE[x.dtype]
    if batched:
        smem = lib.gwen_window_spmm_batched_smem(w, code)
        if smem > MAX_SMEM:
            raise ValueError(f"window {w} needs {smem} bytes of shared memory "
                             f"per block in the batched kernel (at most "
                             f"{MAX_SMEM})")
    out = torch.empty(*x.shape[:-2], n_pad, f, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (s_mat.data_ptr(), x.data_ptr(), window_start.data_ptr(),
            None if fix is None else esc_ptr.data_ptr(),
            None if fix is None else esc_rows.data_ptr(),
            None if fix is None else fix.data_ptr(), out.data_ptr())
    if batched:
        rc = lib.gwen_window_spmm_batched(
            *ptrs, nb, w, f, x.shape[1], x.shape[0],
            0 if fix is None else fix.shape[1], code, stream)
    else:
        rc = lib.gwen_window_spmm(*ptrs, nb, w, f, x.shape[0], code, stream)
    if rc != 0:
        raise RuntimeError(f"window SpMM launch failed: CUDA error {rc}")
    return out


def _on_cuda(x: Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no window SpMM kernel for device {x.device}")
    return True


def _check_dim(x: Tensor, dim: int, name: str) -> None:
    if x.dim() != dim:
        raise ValueError(f"{name} takes a {dim}-d x; got shape "
                         f"{tuple(x.shape)}")


def diag_window_spmm(graph: DiagWindowGraph, x: Tensor,
                     fix: Optional[Tensor] = None) -> Tensor:
    """Kernel B1: the diag-window product plus the escape fix rows
    (``fix``: ``(U, F)`` in receiver order, or None). ``(N_pad, F)``."""
    _check_dim(x, 2, "B1")
    if not _on_cuda(x):
        return diag_window_spmm_plain(graph, x, fix)
    out = _launch(graph.s_mat, graph.window_start, x, graph.esc_ptr,
                  None if fix is None else graph.escape.rows, fix)
    diag_window_spmm.launches += 1
    return out


def diag_window_spmm_b(graph: DiagWindowGraph, x: Tensor,
                       fix: Optional[Tensor] = None) -> Tensor:
    """Kernel B4: B1 on ``(B, rows, F)`` with fix ``(B, U, F)``.
    ``(B, N_pad, F)``."""
    _check_dim(x, 3, "B4")
    if not _on_cuda(x):
        return diag_window_spmm_plain(graph, x, fix)
    out = _launch(graph.s_mat, graph.window_start, x, graph.esc_ptr,
                  None if fix is None else graph.escape.rows, fix)
    diag_window_spmm_b.launches += 1
    return out


def sliding_spmm(graph: SlidingDenseGraph, x: Tensor) -> Tensor:
    """Kernel B3: the banded product (no escapes). ``(N_pad, F)``."""
    _check_dim(x, 2, "B3")
    if not _on_cuda(x):
        return sliding_spmm_plain(graph, x)
    out = _launch(graph.s_mat, graph.window_start, x, None, None, None)
    sliding_spmm.launches += 1
    return out


def sliding_spmm_b(graph: SlidingDenseGraph, x: Tensor) -> Tensor:
    """Kernel B10: B3 on ``(B, rows, F)``. ``(B, N_pad, F)``."""
    _check_dim(x, 3, "B10")
    if not _on_cuda(x):
        return sliding_spmm_plain(graph, x)
    out = _launch(graph.s_mat, graph.window_start, x, None, None, None)
    sliding_spmm_b.launches += 1
    return out


diag_window_spmm.launches = 0
diag_window_spmm_b.launches = 0
sliding_spmm.launches = 0
sliding_spmm_b.launches = 0


# ------------------------------------------------------------ composites


def _escape_rows_fix(nbr: Tensor, w: Tensor, x: Tensor) -> Tensor:
    """Escape contributions per unique receiver: ``x[..., nbr, :]`` + ELL
    contraction. nbr/w ``(U, deg)``, x ``(..., N, F)`` → ``(..., U, F)``."""
    gathered = x[..., nbr, :]  # (..., U, deg, F)
    return torch.einsum("ud,...udf->...uf", w.to(x.dtype), gathered)


def _sliding_escape_add(graph, x: Tensor, out: Tensor) -> Tensor:
    """``out`` plus the escape edges of ``graph.escape`` (ELL gather and a
    scatter-add onto the unique receiver rows)."""
    esc = graph.escape
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


def _fit_rows(t: Tensor, rows: int) -> Tensor:
    """``t`` cut or zero-padded to ``rows`` node rows."""
    have = t.shape[-2]
    if have >= rows:
        return t[..., :rows, :]
    return torch.cat([t, t.new_zeros(*t.shape[:-2], rows - have, t.shape[-1])],
                     dim=-2)


def _sliding_composite(graph: SlidingDenseGraph, x: Tensor,
                       plain: bool) -> Tensor:
    out_rows = _check_rows(graph, x)
    if plain:
        b3 = sliding_spmm_plain
    else:
        b3 = sliding_spmm_b if x.dim() == 3 else sliding_spmm
    return _sliding_escape_add(graph, x, b3(graph, x)[..., :out_rows, :])


def _diag_composite(graph: DiagWindowGraph, x: Tensor, plain: bool) -> Tensor:
    out_rows = _check_rows(graph, x)
    batched = x.dim() == 3
    if plain:
        b1, b3 = diag_window_spmm_plain, sliding_spmm_plain
    elif batched:
        b1, b3 = diag_window_spmm_b, sliding_spmm_b
    else:
        b1, b3 = diag_window_spmm, sliding_spmm
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
        gx = ctx.composite(ctx.graph, g.contiguous(), False)
        return _fit_rows(gx, ctx.rows).to(g.dtype), None, None


def spmm_sliding_dense(graph: SlidingDenseGraph, x: Tensor,
                       plain: bool = False) -> Tensor:
    """Banded aggregation over a :class:`SlidingDenseGraph` (kernel B3, or
    B10 on ``(B, N, F)``, on CUDA), plus its escape edges. Differentiable in
    x; ``plain=True`` runs the plain versions and leaves the gradient to
    autograd."""
    if plain:
        return _sliding_composite(graph, x, True)
    return _SymmetricAggregation.apply(x, _sliding_composite, graph)


def spmm_diag_window(graph: DiagWindowGraph, x: Tensor,
                     plain: bool = False) -> Tensor:
    """Diag-window aggregation (kernel B1, or B4 on ``(B, N, F)``, on
    CUDA) with its escape edges.

    The fix rows come from the hierarchical contraction when the graph has
    an ``esc2_graph`` (gather, kernel B3/B10, gather back), else from the
    ELL gather; B1/B4 place them in-kernel. Differentiable in x: the
    backward runs the same composite on the cotangent. ``plain=True`` takes
    the same path with each kernel replaced by its plain version and leaves
    the gradient to autograd. Pre-padded inputs (``num_padded_nodes`` or
    ``num_src_rows`` rows) keep their row count; the kernels read only rows
    below ``num_src_rows``."""
    if plain:
        return _diag_composite(graph, x, True)
    return _SymmetricAggregation.apply(x, _diag_composite, graph)
