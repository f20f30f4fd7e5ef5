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
    "spmm_block_ell",
    "spmm_block_tiles",
    "spmm_diag_window",
    "spmm_sliding_dense",
    "spmm_sliding_packed",
    "spmm_sliding_rank1",
    "spmm_windowed_dense",
    "windowed_attention",
]
