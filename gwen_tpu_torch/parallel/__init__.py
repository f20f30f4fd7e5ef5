"""Graph-partitioned parallelism on ``torch.distributed``: partition tables,
halo exchange, halo aggregation and attention, the per-rank apply."""

from gwen_tpu_torch.parallel.apply import local_graph, make_partitioned_apply
from gwen_tpu_torch.parallel.halo import (
    HaloDiagGraph,
    HaloGraph,
    aggregate_halo,
    attend_halo,
    halo_exchange,
)
from gwen_tpu_torch.parallel.partition import PartitionedGraph, partition_graph

__all__ = [
    "HaloDiagGraph",
    "HaloGraph",
    "PartitionedGraph",
    "aggregate_halo",
    "attend_halo",
    "halo_exchange",
    "local_graph",
    "make_partitioned_apply",
    "partition_graph",
]
