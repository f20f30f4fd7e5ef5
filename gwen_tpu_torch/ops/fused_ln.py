"""Fused residual + LayerNorm: hand-written Triton kernels for the forward
(B2) and the backward (B2b), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

B2 replaces ``gwen_tpu/ops/fused_ln.py:_ln_fwd_kernel`` (through
``_fwd_impl``): ``out = h + (m − μ)·rsqrt(σ² + eps)·scale + bias`` with
float32 statistics over the feature axis (population variance), cast to
``m.dtype`` once.

B2b replaces ``_ln_bwd_kernel`` (through ``_bwd_impl``): with
``g′ = g·scale`` and ``x̂`` recomputed from the saved ``m``,
``dm = (g′ − mean g′ − x̂·mean(g′x̂))·rstd``, ``dh = g``,
``dscale = Σ g·x̂`` and ``dbias = Σ g`` over all rows.

What bounds them on an H100: bytes. B2 reads ``m`` and ``h`` and writes
``out`` once; B2b reads ``m`` and ``g`` and writes ``dm`` once. Between
them are a row reduction and a few flops — no tensor-core work. One
program normalises ``ROWS`` whole rows held in registers (a 256-wide row
fits one block), so every byte crosses device memory once. B2b's programs
walk a strided set of row blocks and each writes one partial
``dscale``/``dbias`` row into a ``(programs, F)`` float32 buffer that is
summed outside the kernel (the reference sums its (8, F) block outside
too): no atomics, so the gradients are the same from run to run.

The conditional LayerNorm of a noise-conditioned model (GenCast,
:func:`cond_layernorm`) is the same pair: ``LN(m)·scale + offset (+ h)``
with ``scale = 1 + s`` and ``offset = o`` computed from the noise level,
one of each a sample. They are B2's scale and bias (B2 without ``h``
where the norm has no residual), and B2b's ``dscale``/``dbias`` are their
gradients, so on the card a call takes one sample; a batch with a row a
sample raises there (the CPU runs it in plain torch).

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernels or raise.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

import torch

from gwen_tpu_torch.ops import cuda_lib
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor

_TRITON_CACHE = Path(__file__).resolve().parents[1] / "_build" / "triton"
_KERNELS: dict = {}
# B2b launch shape: 4 programs per SM (rows of the partial buffer), each of
# 2 warps. Measured on an H100 at (659,456 × 256) bf16: 0.45 ms with 2
# warps against 0.88 ms with 4 or 8; rows per block and programs per SM
# moved it by under 15 %.
BWD_PROGRAMS_PER_SM = 4
BWD_WARPS = 2


def residual_layernorm_plain(m: Tensor, h: Optional[Tensor], scale: Tensor,
                             bias: Tensor, eps: float = 1e-6) -> Tensor:
    """Plain version of the forward, B2 (without ``h`` where it is
    None)."""
    x = m.float()
    mu = x.mean(dim=-1, keepdim=True)
    d = x - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    xhat = d * torch.rsqrt(var + eps)
    out = xhat * scale.float() + bias.float()
    if h is not None:
        out = out + h.float()
    return out.to(m.dtype)


def residual_layernorm_bwd_plain(m: Tensor, g: Tensor, scale: Tensor,
                                 eps: float = 1e-6
                                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of the backward, B2b: ``(dm, dscale, dbias)`` with dm
    in ``m.dtype`` and the parameter gradients in float32."""
    f = m.shape[-1]
    x = m.float()
    mu = x.mean(dim=-1, keepdim=True)
    d = x - mu
    r = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    xhat = d * r
    g32 = g.float()
    gs = g32 * scale.float()
    gm = gs.mean(dim=-1, keepdim=True)
    gx = (gs * xhat).mean(dim=-1, keepdim=True)
    dm = ((gs - gm - xhat * gx) * r).to(m.dtype)
    return (dm, (g32 * xhat).reshape(-1, f).sum(0),
            g32.reshape(-1, f).sum(0))


def _kernels() -> dict:
    """Compile (once) and return the Triton kernels. Triton is imported
    here, not at module import: CPU-only installs have no Triton."""
    if not _KERNELS:
        # Keep Triton's compile cache inside the checkout, beside nvcc's
        # output, unless the caller chose a cache directory.
        os.environ.setdefault("TRITON_CACHE_DIR", str(_TRITON_CACHE))
        import triton
        import triton.language as tl

        @triton.jit
        def ln_fwd(m_ptr, h_ptr, sc_ptr, bi_ptr, out_ptr, n_rows, f, eps,
                   ROWS: tl.constexpr, BLOCK_F: tl.constexpr,
                   HAS_H: tl.constexpr):
            rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
            cols = tl.arange(0, BLOCK_F)
            cmask = cols < f
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * f + cols[None, :]
            m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            mu = tl.sum(m, axis=1) / f
            d = tl.where(mask, m - mu[:, None], 0.0)
            var = tl.sum(d * d, axis=1) / f
            xhat = d * tl.rsqrt(var + eps)[:, None]
            sc = tl.load(sc_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            bi = tl.load(bi_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            out = xhat * sc[None, :] + bi[None, :]
            if HAS_H:
                out += tl.load(h_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty),
                     mask=mask)

        @triton.jit
        def ln_bwd(m_ptr, g_ptr, sc_ptr, dm_ptr, ds_ptr, db_ptr, n_rows, f,
                   eps, ROWS: tl.constexpr, BLOCK_F: tl.constexpr):
            pid = tl.program_id(0)
            nprog = tl.num_programs(0)
            cols = tl.arange(0, BLOCK_F)
            cmask = cols < f
            sc = tl.load(sc_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            ds_acc = tl.zeros((BLOCK_F,), dtype=tl.float32)
            db_acc = tl.zeros((BLOCK_F,), dtype=tl.float32)
            for blk in range(pid, tl.cdiv(n_rows, ROWS), nprog):
                rows = blk * ROWS + tl.arange(0, ROWS)
                mask = (rows < n_rows)[:, None] & cmask[None, :]
                offs = rows.to(tl.int64)[:, None] * f + cols[None, :]
                m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                mu = tl.sum(m, axis=1) / f
                d = tl.where(mask, m - mu[:, None], 0.0)
                r = tl.rsqrt(tl.sum(d * d, axis=1) / f + eps)
                xhat = d * r[:, None]
                gs = g * sc[None, :]
                gm = tl.sum(gs, axis=1) / f
                gx = tl.sum(gs * xhat, axis=1) / f
                dm = (gs - gm[:, None] - xhat * gx[:, None]) * r[:, None]
                tl.store(dm_ptr + offs, dm.to(dm_ptr.dtype.element_ty),
                         mask=mask)
                ds_acc += tl.sum(g * xhat, axis=0)
                db_acc += tl.sum(g, axis=0)
            tl.store(ds_ptr + pid * f + cols, ds_acc, mask=cmask)
            tl.store(db_ptr + pid * f + cols, db_acc, mask=cmask)

        _KERNELS.update(fwd=ln_fwd, bwd=ln_bwd)
    return _KERNELS


def _first_call(fn, key: tuple, launch) -> None:
    """``launch()``. The first call of a Triton specialisation (``key``:
    the field's and the parameters' dtypes, the row count's divisibility
    by 16 and the width), where Triton compiles or loads it from its cache,
    adds one to ``fn.loads`` and its host seconds to ``fn.load_seconds``."""
    if key in fn.specialisations:
        launch()
        return
    t0 = time.perf_counter()
    launch()
    fn.specialisations.add(key)
    fn.loads += 1
    fn.load_seconds += time.perf_counter() - t0


def _check(m: Tensor, other: Tensor, params: tuple[Tensor, ...]) -> None:
    f = m.shape[-1]
    if other.shape != m.shape or other.dtype != m.dtype:
        raise ValueError(f"operands {tuple(m.shape)} {m.dtype} and "
                         f"{tuple(other.shape)} {other.dtype} must match")
    if any(p.shape != (f,) for p in params):
        raise ValueError(f"scale and bias must have shape ({f},)")
    for t in (m, other, *params):
        if t.device != m.device:
            raise ValueError(f"operand on {t.device}, m on {m.device}")
        if not t.is_contiguous():
            raise ValueError("fused LayerNorm operands must be contiguous")


def _blocks(f: int) -> tuple[int, int]:
    block_f = 1 << max(f - 1, 0).bit_length()
    return block_f, max(1, 4096 // block_f)


def residual_layernorm_fwd(m: Tensor, h: Optional[Tensor], scale: Tensor,
                           bias: Tensor, eps: float = 1e-6) -> Tensor:
    """Kernel B2: ``h + layer_norm(m)`` over the last axis, or
    ``layer_norm(m)`` where ``h`` is None (no autograd;
    :func:`residual_layernorm` and :func:`cond_layernorm` are the
    differentiable entries)."""
    if not cuda_lib.on_cuda(m, "fused LayerNorm"):
        return residual_layernorm_plain(m, h, scale, bias, eps)
    _check(m, m if h is None else h, (scale, bias))
    f = m.shape[-1]
    n_rows = m.numel() // f
    block_f, rows = _blocks(f)
    out = torch.empty_like(m)
    with torch.cuda.device(m.device):
        _first_call(residual_layernorm_fwd,
                    (m.dtype, scale.dtype, n_rows % 16 == 0, n_rows == 1, f, h is None),
                    lambda: _kernels()["fwd"][((n_rows + rows - 1) // rows,)](
                        m, m if h is None else h, scale, bias, out, n_rows, f, eps,
                        ROWS=rows, BLOCK_F=block_f, HAS_H=h is not None,
                        num_warps=4))
    residual_layernorm.launches += 1
    return out


def residual_layernorm_bwd(m: Tensor, g: Tensor, scale: Tensor,
                           eps: float = 1e-6
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """Kernel B2b: ``(dm, dscale, dbias)`` of ``h + layer_norm(m)`` for the
    cotangent ``g``; dscale and dbias are float32."""
    if not cuda_lib.on_cuda(m, "fused LayerNorm"):
        return residual_layernorm_bwd_plain(m, g, scale, eps)
    _check(m, g, (scale,))
    f = m.shape[-1]
    n_rows = m.numel() // f
    block_f, rows = _blocks(f)
    sms = torch.cuda.get_device_properties(m.device).multi_processor_count
    programs = max(1, min((n_rows + rows - 1) // rows,
                          BWD_PROGRAMS_PER_SM * sms))
    dm = torch.empty_like(m)
    ds = torch.empty(programs, f, dtype=torch.float32, device=m.device)
    db = torch.empty(programs, f, dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        _first_call(residual_layernorm_bwd,
                    (m.dtype, scale.dtype, n_rows % 16 == 0, n_rows == 1, f),
                    lambda: _kernels()["bwd"][(programs,)](
                        m, g, scale, dm, ds, db, n_rows, f, eps,
                        ROWS=rows, BLOCK_F=block_f, num_warps=BWD_WARPS))
    residual_layernorm_bwd.launches += 1
    return dm, ds.sum(0), db.sum(0)


residual_layernorm_bwd.launches = 0
residual_layernorm_fwd.loads, residual_layernorm_fwd.load_seconds = 0, 0.0
residual_layernorm_fwd.specialisations = set()
residual_layernorm_bwd.loads, residual_layernorm_bwd.load_seconds = 0, 0.0
residual_layernorm_bwd.specialisations = set()


class _ResidualLayerNorm(torch.autograd.Function):
    """B2 forward (``h`` None: no residual), B2b backward inside the span
    ``span``; saves ``(m, scale)`` as the reference's ``_fused_fwd`` does
    and recomputes the statistics. The scale's and bias's gradients are
    B2b's ``dscale`` and ``dbias``, whether they are parameters or
    computed (the conditional norm)."""

    @staticmethod
    def forward(ctx, m, h, scale, bias, eps, span):
        ctx.save_for_backward(m, scale)
        ctx.eps, ctx.span, ctx.has_h = eps, span, h is not None
        return residual_layernorm_fwd(m, h, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        with annotate(ctx.span):
            m, scale = ctx.saved_tensors
            dm, ds, db = residual_layernorm_bwd(m, g.contiguous(), scale,
                                                ctx.eps)
            return (dm, g if ctx.has_h else None, ds.to(scale.dtype),
                    db.to(scale.dtype), None, None)


def residual_layernorm(m: Tensor, h: Tensor, scale: Tensor, bias: Tensor,
                       eps: float = 1e-6) -> Tensor:
    """Kernel B2 (its launch count is ``residual_layernorm.launches``):
    ``h + layer_norm(m)`` over the last axis, differentiable through
    kernel B2b."""
    return _ResidualLayerNorm.apply(m, h, scale, bias, eps, "gwen.op.residual_ln.bwd")


residual_layernorm.launches = 0


def fused_residual_layernorm(norm_params, m: Tensor, h: Tensor,
                             eps: float = 1e-6,
                             backend: str = "auto") -> Tensor:
    """``h + layer_norm(m)`` (see the module docstring): kernels B2/B2b
    with ``backend="auto"``; otherwise the plain forward, differentiated by
    autograd.

    Takes the composite ``h + core.layer_norm_apply(m)`` when the feature
    axis is not a multiple of 128 or the shapes differ — the reference's
    semantics, whose LayerNorm output is cast before the residual add.
    One span ``gwen.op.residual_ln`` under a profiler.
    """
    from gwen_tpu_torch.nn import core

    with annotate("gwen.op.residual_ln"):
        f = m.shape[-1]
        if f % 128 != 0 or m.shape != h.shape:
            return h + core.layer_norm_apply(norm_params, m, eps=eps)
        fn = residual_layernorm if backend == "auto" else residual_layernorm_plain
        return fn(m, h, norm_params["scale"], norm_params["bias"], eps)


def cond_layernorm(m: Tensor, scale: Tensor, offset: Tensor,
                   h: Optional[Tensor] = None, eps: float = 1e-6,
                   backend: str = "auto") -> Tensor:
    """The conditional LayerNorm ``LN(m)·scale + offset`` (``+ h``) over the
    last axis, float32 statistics, no learned affine of its own: ``scale``
    (``1 + s``) and ``offset`` come from the noise level, ``(F,)`` (or a
    ``(1, F)`` row) for one sample, or ``(B, F)`` for ``m`` ``(B, ...,
    F)``; differentiable. With ``backend="auto"`` one sample takes kernels
    B2/B2b, any width; ``h`` must then match ``m``. On a CUDA tensor a
    ``(B, F)`` scale with ``B > 1``, or an ``h`` of another shape, raises:
    B2/B2b take one scale and offset row. On the CPU, or with another
    backend, those run in plain torch. One span ``gwen.op.cond_norm`` under
    a profiler, ``.bwd`` over B2b."""
    with annotate("gwen.op.cond_norm"):
        if scale.dim() == 2 and scale.shape[0] == 1:
            scale, offset = scale[0], offset[0]
        fused = scale.dim() == 1 and (h is None or h.shape == m.shape)
        if backend == "auto" and (fused or cuda_lib.on_cuda(m, "conditional LayerNorm")):
            if not fused:
                raise ValueError(
                    f"cond_layernorm on the card takes one sample: scale {tuple(scale.shape)}, "
                    f"m {tuple(m.shape)}, h {None if h is None else tuple(h.shape)}")
            return _ResidualLayerNorm.apply(
                m.contiguous(), None if h is None else h.contiguous(),
                scale.contiguous(), offset.contiguous(), eps, "gwen.op.cond_norm.bwd")
        if scale.dim() == 2:  # one row a sample, over (B, ..., F)
            shape = (scale.shape[0],) + (1,) * (m.dim() - 2) + (scale.shape[1],)
            scale, offset = scale.reshape(shape), offset.reshape(shape)
        return residual_layernorm_plain(m, h, scale, offset, eps)
