"""Run a model over a partitioned mesh graph, one process per partition:
counterpart of ``gwen_tpu.parallel.apply``.

The reference wraps ``model.apply`` in ``shard_map`` over a ``(data,
graph)`` device mesh. Here each rank of a
:class:`~gwen_tpu_torch.train.mesh.ProcessMesh` holds its own slice of the
stacked partition tables (:func:`local_graph`, moved to its device once),
its contiguous chunk of the node axis and its share of the batch, and runs
the unchanged model on them; the halo exchanges happen inside
:func:`gwen_tpu_torch.ops.aggregate.aggregate` and the attention dispatch.
Parameters are replicated (every rank builds the model from the same seed);
their gradients are summed by the trainer.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gwen_tpu_torch.graph.graph import (
    DiagWindowGraph,
    EscapeFixup,
    diag_transpose_tables,
)
from gwen_tpu_torch.parallel.halo import HaloDiagGraph, HaloGraph
from gwen_tpu_torch.parallel.partition import PartitionedGraph
from gwen_tpu_torch.train.mesh import ProcessMesh

Tensor = torch.Tensor


def _receivers(rows: np.ndarray) -> EscapeFixup:
    """An :class:`EscapeFixup` that names a partition's escape receivers and
    nothing else: their fix rows come from the global contraction."""
    none = torch.zeros(0, dtype=torch.int64)
    return EscapeFixup(senders=none, receivers=none,
                       weights=torch.zeros(0), nbr=none.reshape(0, 1),
                       w=torch.zeros(0, 1),
                       rows=torch.from_numpy(rows.astype(np.int64)),
                       num_edges=0)


def local_graph(pg: PartitionedGraph, index: int, group=None,
                transpose_tables: bool = False):
    """Partition ``index``'s :class:`HaloGraph` or :class:`HaloDiagGraph`
    from the stacked tables (on the CPU; ``.to(device)`` moves it), on
    process group ``group``. ``transpose_tables`` attaches what windowed
    attention needs to a diag partition."""
    p = index
    max_edges = int(pg.edges_per_part.max()) if pg.num_parts else 0
    if pg.layout == "diag":
        esc = pg.diag_loc_idx is not None
        k = int(pg.diag_u_count[p]) if esc else 0
        local = DiagWindowGraph(
            s_mat=pg.s_diag[p],
            window_start=torch.from_numpy(pg.diag_window_start[p]),
            num_nodes=pg.n_local,
            num_edges=max_edges,
            block_size=pg.block_size,
            window_size=pg.diag_window,
            superblock=pg.diag_superblock,
            num_src_rows=pg.n_local + 2 * pg.halo,
            escape=_receivers(pg.diag_loc_idx[p, :k]) if k else None,
            esc_ptr=torch.from_numpy(pg.diag_esc_ptr[p]) if k else None,
        )
        if transpose_tables:
            local = diag_transpose_tables(local)

        def rows(a):
            return torch.from_numpy(np.asarray(a, np.int64))

        return HaloDiagGraph(
            local=local, group=group, halo=pg.halo, n_local=pg.n_local,
            loc_idx=rows(pg.diag_loc_idx[p]) if esc else None,
            back_loc=rows(pg.diag_back_loc[p, :k]) if esc else None,
            idx2=rows(pg.diag_idx2) if esc else None,
            esc2=pg.esc2_graph if esc else None,
        )
    common = dict(group=group, halo=pg.halo, n_local=pg.n_local,
                  block_size=pg.block_size, num_edges=max_edges)
    if pg.layout == "sliding":
        return HaloGraph(  # the ELL tables are not read on this path
            nbr=torch.zeros(pg.n_local, 1, dtype=torch.int32),
            nbr_weight=torch.zeros(pg.n_local, 1),
            window_start=torch.from_numpy(pg.sliding_window_start[p]),
            window_size=pg.sliding_window, s_mat=pg.s_sliding[p], sliding=True,
            **common)
    return HaloGraph(
        nbr=torch.from_numpy(pg.nbr[p]),
        nbr_weight=torch.from_numpy(pg.nbr_weight[p]),
        window_start=torch.from_numpy(pg.window_start[p]),
        window_size=pg.window_size,
        s_mat=None if pg.s_dense is None else torch.from_numpy(pg.s_dense[p]),
        **common)


class PartitionedApply:
    """``apply(x_local)`` for this rank: the model on the rank's partition.

    ``graph`` is the rank's halo graph on its device. :meth:`shard` cuts a
    *global* batch entry (padded node space, ``pg.pad_nodes``) to what this
    rank computes on: the node axis (-2) over the graph axis, and for
    entries with a leading batch axis that axis over the data axis.
    """

    def __init__(self, model, pg: PartitionedGraph, mesh: ProcessMesh, graph):
        self.model, self.pg, self.mesh, self.graph = model, pg, mesh, graph

    def __call__(self, x_local: Tensor) -> Tensor:
        return self.model(self.graph, x_local)

    def shard(self, entry: Any) -> Any:
        if isinstance(entry, (tuple, list)):
            return type(entry)(self.shard(e) for e in entry)
        if not isinstance(entry, torch.Tensor) or entry.dim() < 2:
            return entry
        mesh, n_local = self.mesh, self.pg.n_local
        if entry.shape[-2] != self.pg.padded_nodes:
            raise ValueError(
                f"entry has {entry.shape[-2]} node rows; the partitioned "
                f"path takes the padded node space ({self.pg.padded_nodes} "
                "rows, pg.pad_nodes)")
        out = entry.narrow(-2, mesh.graph_index * n_local, n_local)
        if entry.dim() >= 3 and mesh.data > 1:
            if entry.shape[0] % mesh.data:
                raise ValueError(
                    f"batch of {entry.shape[0]} does not divide over the "
                    f"data axis ({mesh.data})")
            per = entry.shape[0] // mesh.data
            out = out.narrow(0, mesh.data_index * per, per)
        return out


def make_partitioned_apply(model, pg: PartitionedGraph, mesh: ProcessMesh,
                           device="cuda",
                           transpose_tables: bool = False) -> PartitionedApply:
    """The per-rank apply of ``model`` over ``pg`` on ``mesh``: this rank's
    slice of every stacked table, moved to ``device`` once (the card unless
    the caller asks for the CPU), on the rank's graph group."""
    if pg.num_parts != mesh.graph:
        raise ValueError(f"{pg.num_parts} partitions for a graph axis of "
                         f"{mesh.graph}")
    graph = local_graph(pg, mesh.graph_index, mesh.graph_group,
                        transpose_tables).to(device)
    return PartitionedApply(model, pg, mesh, graph)
