from gwen_tpu_torch.ops import attention_cuda, edges, fused_ln, spmm_cuda, unfused_cuda
from gwen_tpu_torch.ops.aggregate import (
    aggregate,
    aggregate_block_ell_reference,
    aggregate_block_tiles_reference,
    aggregate_dense,
    aggregate_diag_window_reference,
    aggregate_segment,
    aggregate_sliding_dense_reference,
    aggregate_sliding_packed_reference,
    aggregate_sliding_rank1_reference,
    aggregate_windowed_dense_reference,
)
from gwen_tpu_torch.ops.attention import (
    diag_matvec,
    diag_sddmm,
    diag_spmm_t,
    windowed_attention,
)
from gwen_tpu_torch.ops.fused_ln import fused_residual_layernorm
from gwen_tpu_torch.ops.spmm_cuda import (
    spmm_block_ell,
    spmm_block_tiles,
    spmm_diag_window,
    spmm_sliding_dense,
    spmm_sliding_packed,
    spmm_sliding_rank1,
    spmm_windowed_dense,
)

__all__ = [
    "aggregate",
    "aggregate_block_ell_reference",
    "aggregate_block_tiles_reference",
    "aggregate_dense",
    "aggregate_diag_window_reference",
    "aggregate_segment",
    "aggregate_sliding_dense_reference",
    "aggregate_sliding_packed_reference",
    "aggregate_sliding_rank1_reference",
    "aggregate_windowed_dense_reference",
    "diag_matvec",
    "diag_sddmm",
    "diag_spmm_t",
    "fused_residual_layernorm",
    "kernel_loads",
    "spmm_block_ell",
    "spmm_block_tiles",
    "spmm_diag_window",
    "spmm_sliding_dense",
    "spmm_sliding_packed",
    "spmm_sliding_rank1",
    "spmm_windowed_dense",
    "windowed_attention",
]


def kernel_loads() -> dict[str, dict]:
    """``{name: {"count", "seconds"}}`` of the kernels' loads in this
    process, on the host's clock: ``nvcc`` (compiles of a CUDA source),
    ``window_spmm``, ``window_attention``, ``window_unfused`` and
    ``edge_sum`` (their libraries' loads), ``ln_fwd`` and ``ln_bwd`` (each
    Triton kernel's first call per specialisation). Counted always,
    outside the per-call path of the built kernels."""
    held = {"nvcc": spmm_cuda.nvcc_build, "window_spmm": spmm_cuda._lib,
            "window_attention": attention_cuda._lib,
            "window_unfused": unfused_cuda._lib, "edge_sum": edges._lib,
            "ln_fwd": fused_ln.residual_layernorm_fwd,
            "ln_bwd": fused_ln.residual_layernorm_bwd}
    return {name: {"count": fn.loads, "seconds": fn.load_seconds}
            for name, fn in held.items()}
