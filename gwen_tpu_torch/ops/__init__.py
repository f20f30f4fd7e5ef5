from gwen_tpu_torch.ops.aggregate import (
    aggregate,
    aggregate_diag_window_reference,
    aggregate_segment,
    aggregate_sliding_dense_reference,
    aggregate_sliding_packed_reference,
)
from gwen_tpu_torch.ops.attention import (
    diag_matvec,
    diag_sddmm,
    diag_spmm_t,
    windowed_attention,
)
from gwen_tpu_torch.ops.fused_ln import fused_residual_layernorm
from gwen_tpu_torch.ops.spmm_cuda import (
    spmm_diag_window,
    spmm_sliding_dense,
    spmm_sliding_packed,
)

__all__ = [
    "aggregate",
    "aggregate_diag_window_reference",
    "aggregate_segment",
    "aggregate_sliding_dense_reference",
    "aggregate_sliding_packed_reference",
    "diag_matvec",
    "diag_sddmm",
    "diag_spmm_t",
    "fused_residual_layernorm",
    "spmm_diag_window",
    "spmm_sliding_dense",
    "spmm_sliding_packed",
    "windowed_attention",
]
