from gwen_tpu_torch.graph.build import icosphere_edges
from gwen_tpu_torch.graph.graph import (
    DiagWindowGraph,
    EscapeFixup,
    Graph,
    SlidingDenseGraph,
    build_graph,
    diag_transpose_tables,
    gcn_normalize,
    to_diag_window,
    to_sliding_dense,
)
from gwen_tpu_torch.graph.reorder import (
    apply_order,
    bandwidth,
    kd_patch_order,
    rcm_order,
)

__all__ = [
    "DiagWindowGraph",
    "EscapeFixup",
    "Graph",
    "SlidingDenseGraph",
    "build_graph",
    "diag_transpose_tables",
    "gcn_normalize",
    "to_diag_window",
    "to_sliding_dense",
    "icosphere_edges",
    "apply_order",
    "bandwidth",
    "kd_patch_order",
    "rcm_order",
]
