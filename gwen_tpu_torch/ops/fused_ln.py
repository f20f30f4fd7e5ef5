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

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernels or raise.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

Tensor = torch.Tensor

_TRITON_CACHE = Path(__file__).resolve().parents[1] / "_build" / "triton"
_KERNELS: dict = {}
# B2b launch shape: 4 programs per SM (rows of the partial buffer), each of
# 2 warps. Measured on an H100 at (659,456 × 256) bf16: 0.45 ms with 2
# warps against 0.88 ms with 4 or 8; rows per block and programs per SM
# moved it by under 15 %.
BWD_PROGRAMS_PER_SM = 4
BWD_WARPS = 2


def residual_layernorm_plain(m: Tensor, h: Tensor, scale: Tensor,
                             bias: Tensor, eps: float = 1e-6) -> Tensor:
    """Plain version of the forward, B2."""
    x = m.float()
    mu = x.mean(dim=-1, keepdim=True)
    d = x - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    xhat = d * torch.rsqrt(var + eps)
    out = xhat * scale.float() + bias.float() + h.float()
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
                   ROWS: tl.constexpr, BLOCK_F: tl.constexpr):
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
            h = tl.load(h_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            out = xhat * sc[None, :] + bi[None, :] + h
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


def _on_cuda(m: Tensor) -> bool:
    if m.device.type == "cpu":
        return False
    if m.device.type != "cuda":
        raise ValueError(f"no fused LayerNorm kernel for device {m.device}")
    return True


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


def residual_layernorm_fwd(m: Tensor, h: Tensor, scale: Tensor,
                           bias: Tensor, eps: float = 1e-6) -> Tensor:
    """Kernel B2: ``h + layer_norm(m)`` over the last axis (no autograd;
    :func:`residual_layernorm` is the differentiable entry)."""
    if not _on_cuda(m):
        return residual_layernorm_plain(m, h, scale, bias, eps)
    _check(m, h, (scale, bias))
    f = m.shape[-1]
    n_rows = m.numel() // f
    block_f, rows = _blocks(f)
    out = torch.empty_like(m)
    with torch.cuda.device(m.device):
        _kernels()["fwd"][((n_rows + rows - 1) // rows,)](
            m, h, scale, bias, out, n_rows, f, eps,
            ROWS=rows, BLOCK_F=block_f, num_warps=4)
    residual_layernorm.launches += 1
    return out


def residual_layernorm_bwd(m: Tensor, g: Tensor, scale: Tensor,
                           eps: float = 1e-6
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """Kernel B2b: ``(dm, dscale, dbias)`` of ``h + layer_norm(m)`` for the
    cotangent ``g``; dscale and dbias are float32."""
    if not _on_cuda(m):
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
        _kernels()["bwd"][(programs,)](
            m, g, scale, dm, ds, db, n_rows, f, eps,
            ROWS=rows, BLOCK_F=block_f, num_warps=BWD_WARPS)
    residual_layernorm_bwd.launches += 1
    return dm, ds.sum(0), db.sum(0)


residual_layernorm_bwd.launches = 0


class _ResidualLayerNorm(torch.autograd.Function):
    """B2 forward, B2b backward; saves ``(m, scale)`` as the reference's
    ``_fused_fwd`` does and recomputes the statistics."""

    @staticmethod
    def forward(ctx, m, h, scale, bias, eps):
        ctx.save_for_backward(m, scale)
        ctx.eps = eps
        return residual_layernorm_fwd(m, h, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        m, scale = ctx.saved_tensors
        dm, ds, db = residual_layernorm_bwd(m, g.contiguous(), scale, ctx.eps)
        return dm, g, ds.to(scale.dtype), db.to(scale.dtype), None


def residual_layernorm(m: Tensor, h: Tensor, scale: Tensor, bias: Tensor,
                       eps: float = 1e-6) -> Tensor:
    """Kernel B2 (its launch count is ``residual_layernorm.launches``):
    ``h + layer_norm(m)`` over the last axis, differentiable through
    kernel B2b."""
    return _ResidualLayerNorm.apply(m, h, scale, bias, eps)


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
    """
    from gwen_tpu_torch.nn import core

    f = m.shape[-1]
    if f % 128 != 0 or m.shape != h.shape:
        return h + core.layer_norm_apply(norm_params, m, eps=eps)
    fn = residual_layernorm if backend == "auto" else residual_layernorm_plain
    return fn(m, h, norm_params["scale"], norm_params["bias"], eps)
