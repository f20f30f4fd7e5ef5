"""Process mesh over ``torch.distributed``: counterpart of
``gwen_tpu.train.mesh``.

One process per device. The ranks form a ``(data, graph)`` mesh with the
graph axis innermost (``rank = data_index · graph + graph_index``), so the
halo exchange of one model replica runs between neighbouring ranks: a
*graph* group per replica (halo exchange, the escape ``all_gather``) and a
*data* group per partition. Parameters are replicated; their gradients are
summed over every rank (:meth:`ProcessMesh.all_reduce_gradients`). One
process needs no process group at all. :func:`shard_batch` cuts a global
host batch over the data axis.

The reference's ``data_sharding``, ``node_sharding`` and ``replicated``
name ``jax.sharding`` layouts of one process's devices; a process here holds
one device, so they have no counterpart: a batch is cut by
:func:`shard_batch` and a partition by ``PartitionedApply.shard``.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Container, Iterable, Optional

import torch
import torch.distributed as dist


def initialize_distributed(device: "str | torch.device" = "cuda",
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout_s: float = 1800.0) -> torch.device:
    """Join the default process group and return this process's device.

    ``world_size`` and ``rank`` default to the ``WORLD_SIZE``, ``RANK`` (and,
    for the device index, ``LOCAL_RANK``) that ``python -m
    torch.distributed.run`` sets; ``init_method`` to ``env://``. The backend
    follows the device: NCCL on CUDA (one device per process), gloo on the
    CPU. One process, or a group that is already up: nothing is started."""
    dev = torch.device(device)
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if dev.type == "cuda" and world_size > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                           % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)
    if world_size <= 1 or dist.is_initialized():
        return dev
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def finish_distributed(started_group: bool) -> None:
    """The end of a run over several processes: wait for every rank, then
    leave the default group if this run joined it (``started_group``: no
    group was up before :func:`initialize_distributed`). Nothing on one
    process."""
    if world_size() > 1:
        dist.barrier()
        if started_group:
            dist.destroy_process_group()


def is_main_process() -> bool:
    """Rank-0 gate for logging, the registry and checkpoints: the rank in
    the default process group or, with none up (before it is joined, after
    it is left), the launcher's ``RANK``."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", 0)) == 0


@dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in the ``(data, graph)`` mesh and its groups
    (``None`` where an axis has one rank)."""

    data: int
    graph: int
    data_index: int
    graph_index: int
    graph_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None

    @property
    def world(self) -> int:
        return self.data * self.graph

    def all_reduce_gradients(self, params: Iterable[torch.Tensor]) -> None:
        """Sum every parameter's gradient over all ranks, in place. Each
        rank differentiates ``local_sum / global_count``, so the sum is the
        gradient of the global mean, what the reference's ``shard_map`` with
        replicated parameters returns. A parameter without a gradient on
        this rank contributes zeros: every rank makes the same calls."""
        if self.world == 1:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad)

    def all_reduce_sum(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` summed over all ranks (a copy; ``value`` itself on one
        process)."""
        if self.world == 1:
            return value
        out = value.detach().clone()
        dist.all_reduce(out)
        return out


def make_mesh(data: int = -1, graph: int = 1) -> ProcessMesh:
    """The ``(data, graph)`` mesh over the default process group's ranks and
    this rank's coordinates. ``data=-1`` absorbs all remaining ranks. Every
    rank creates every group, in the same order."""
    n = world_size()
    if data == -1:
        if n % graph:
            raise ValueError(f"{n} ranks not divisible by graph={graph}")
        data = n // graph
    if data * graph != n:
        raise ValueError(f"mesh {data}x{graph} != {n} ranks")
    if n == 1:
        return ProcessMesh(1, 1, 0, 0)
    rank = dist.get_rank()
    d, g = divmod(rank, graph)
    graph_group = data_group = None
    for di in range(data):
        grp = dist.new_group([di * graph + gi for gi in range(graph)])
        if di == d and graph > 1:
            graph_group = grp
    for gi in range(graph):
        grp = dist.new_group([di * graph + gi for di in range(data)])
        if gi == g and data > 1:
            data_group = grp
    return ProcessMesh(data, graph, d, g, graph_group, data_group)


def shard_batch(mesh: ProcessMesh, batch: Any, replicated: Container = ()) -> Any:
    """This rank's share of a global host batch (numpy arrays or tensors,
    alone or in a tuple, list or dict), as the reference's ``_shard_batch``
    lays a batch out over its ``"data"`` axis. A leaf whose leading axis
    divides ``mesh.data`` is cut into equal consecutive shares, the rank's
    ``data_index``-th; any other leaf (a batch of 1, or 21 on 2 ranks) is
    kept whole on every rank, the reference's degrade to replication. Dict
    entries named in ``replicated`` (the member mask) are never cut.

    Every loss of the data-parallel tasks is a mean with equal shares over
    the batch axis, so ``local_mean / world`` summed over the ranks is the
    global mean either way (``gnn_loss_fn``, ``cnn_loss_fn`` with a
    mesh)."""
    def cut(leaf):
        if mesh.data == 1 or getattr(leaf, "ndim", 0) == 0:
            return leaf
        if leaf.shape[0] % mesh.data:
            return leaf
        per = leaf.shape[0] // mesh.data
        return leaf[mesh.data_index * per:(mesh.data_index + 1) * per]

    if isinstance(batch, dict):
        return {k: v if k in replicated else cut(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(cut(v) for v in batch)
    return cut(batch)
