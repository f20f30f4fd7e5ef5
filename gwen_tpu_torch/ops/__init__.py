from gwen_tpu_torch.ops.aggregate import (
    aggregate,
    aggregate_diag_window_reference,
    aggregate_segment,
    aggregate_sliding_dense_reference,
)
from gwen_tpu_torch.ops.attention import windowed_attention
from gwen_tpu_torch.ops.fused_ln import fused_residual_layernorm
from gwen_tpu_torch.ops.spmm_cuda import spmm_diag_window, spmm_sliding_dense

__all__ = [
    "aggregate",
    "aggregate_diag_window_reference",
    "aggregate_segment",
    "aggregate_sliding_dense_reference",
    "fused_residual_layernorm",
    "spmm_diag_window",
    "spmm_sliding_dense",
    "windowed_attention",
]
