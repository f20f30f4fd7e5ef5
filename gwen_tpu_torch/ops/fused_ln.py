"""Fused residual + LayerNorm forward: a hand-written Triton kernel (B2)
and its plain PyTorch version.

Replaces ``gwen_tpu/ops/fused_ln.py:_ln_fwd_kernel`` (through
``_fwd_impl``): ``out = h + (m − μ)·rsqrt(σ² + eps)·scale + bias`` with
float32 statistics over the feature axis (population variance), cast to
``m.dtype`` once.

What bounds it on an H100: bytes. Each element is read twice (``m``,
``h``) and written once, with a row reduction and a few flops between — no
tensor-core work. One program normalises ``ROWS`` whole rows held in
registers (a 256-wide row fits one block), so every byte crosses device
memory exactly once. The backward (``_ln_bwd_kernel`` in the reference)
belongs to training and is not ported yet.

On a CPU tensor :func:`residual_layernorm` runs the plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

Tensor = torch.Tensor

_TRITON_CACHE = Path(__file__).resolve().parents[1] / "_build" / "triton"
_KERNEL = None


def residual_layernorm_plain(m: Tensor, h: Tensor, scale: Tensor,
                             bias: Tensor, eps: float = 1e-6) -> Tensor:
    """Plain version of :func:`residual_layernorm`."""
    x = m.float()
    mu = x.mean(dim=-1, keepdim=True)
    d = x - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    xhat = d * torch.rsqrt(var + eps)
    out = xhat * scale.float() + bias.float() + h.float()
    return out.to(m.dtype)


def _kernel():
    """Compile (once) and return the Triton kernel. Triton is imported
    here, not at module import: CPU-only installs have no Triton."""
    global _KERNEL
    if _KERNEL is None:
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

        _KERNEL = ln_fwd
    return _KERNEL


def residual_layernorm(m: Tensor, h: Tensor, scale: Tensor, bias: Tensor,
                       eps: float = 1e-6) -> Tensor:
    """Kernel B2: ``h + layer_norm(m)`` over the last axis."""
    if m.device.type == "cpu":
        return residual_layernorm_plain(m, h, scale, bias, eps)
    if m.device.type != "cuda":
        raise ValueError(f"no fused LayerNorm kernel for device {m.device}")
    f = m.shape[-1]
    if h.shape != m.shape or h.dtype != m.dtype:
        raise ValueError(f"m {tuple(m.shape)} {m.dtype} and h "
                         f"{tuple(h.shape)} {h.dtype} must match")
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"scale and bias must have shape ({f},)")
    for t in (m, h, scale, bias):
        if t.device != m.device:
            raise ValueError(f"operand on {t.device}, m on {m.device}")
        if not t.is_contiguous():
            raise ValueError("fused LayerNorm operands must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (m, h, scale, bias)):
        raise NotImplementedError(
            "the fused LayerNorm kernel has no backward yet; training comes "
            "with slice 2 of the port")
    n_rows = m.numel() // f
    block_f = 1 << max(f - 1, 0).bit_length()
    rows = max(1, 4096 // block_f)
    out = torch.empty_like(m)
    kernel = _kernel()
    with torch.cuda.device(m.device):
        kernel[((n_rows + rows - 1) // rows,)](
            m, h, scale, bias, out, n_rows, f, eps,
            ROWS=rows, BLOCK_F=block_f, num_warps=4)
    residual_layernorm.launches += 1
    return out


residual_layernorm.launches = 0


def fused_residual_layernorm(norm_params, m: Tensor, h: Tensor,
                             eps: float = 1e-6,
                             backend: str = "auto") -> Tensor:
    """``h + layer_norm(m)`` (see the module docstring): kernel B2 with
    ``backend="auto"``, its plain version otherwise.

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
