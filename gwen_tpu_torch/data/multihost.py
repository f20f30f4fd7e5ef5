"""Per-process slices of an axis and gathers across processes: counterpart
of ``gwen_tpu.data.multihost`` on ``torch.distributed``. Both degrade to
one process (the slice is everything, the gather the identity). The
reference's ``global_sharded_array`` assembles a ``jax.Array`` sharded
over several processes' devices; a tensor here lives on one process's one
device, so it has no counterpart (``train.mesh.shard_batch`` cuts a host
batch instead)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def process_slice(total: int, axis_procs: Optional[int] = None) -> slice:
    """This process's contiguous slice of a length-``total`` axis split over
    ``axis_procs`` processes (default: all of them); the first ``total %
    axis_procs`` slices are one longer."""
    nproc, pid = _world()
    nproc = nproc if axis_procs is None else axis_procs
    base, rem = divmod(total, nproc)
    start = pid * base + min(pid, rem)
    return slice(start, start + base + (1 if pid < rem else 0))


def load_member_shard(zarr_array, time_idx: Optional[slice] = None) -> np.ndarray:
    """Read this process's member slice from a ``(time, member, ...)``
    store (a range read: only the chunks of that slice are touched)."""
    sl = process_slice(zarr_array.shape[zarr_array.axis("member")])
    idx = [slice(None)] * len(zarr_array.dims)
    idx[zarr_array.axis("member")] = sl
    if time_idx is not None:
        idx[zarr_array.axis("time")] = time_idx
    return zarr_array[tuple(idx)]


def all_gather_from_hosts(x) -> np.ndarray:
    """Every process's ``x`` (same shape on each), stacked on a new leading
    axis, on every process. One process: ``x`` itself as an array."""
    x = np.asarray(x)
    nproc, _ = _world()
    if nproc == 1:
        return x
    backend = dist.get_backend()
    dev = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    parts = [torch.empty_like(t) for _ in range(nproc)]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()
