"""Persistent mesh-field datasets: zarr fields + graph sidecar.

Counterpart of ``gwen_tpu.data.meshstore``, same files on disk. Stores
ensemble trajectories on a mesh graph: fields ``(time, member, node,
channel)`` in a chunked zarr array with the graph (senders, receivers and
vertices, in the original node order) in an ``.npz`` sidecar, so
``train-mesh --data`` can train on stored data instead of the synthetic
dynamics, and a serving artifact trained from a store can rebuild its
graph.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gwen_tpu_torch.data import zarrstore

GRAPH_FILE = "mesh_graph.npz"


def save_mesh_dataset(
    path: str | Path,
    fields: np.ndarray,  # (time, member, node, channel)
    senders: np.ndarray,
    receivers: np.ndarray,
    verts: np.ndarray | None = None,
    time_chunk: int = 8,
    compression_level: int = 1,
    meta: dict | None = None,
) -> Path:
    path = Path(path)
    fields = np.asarray(fields, np.float32)
    if fields.ndim != 4:
        raise ValueError("fields must be (time, member, node, channel)")
    arr = zarrstore.create(
        path,
        shape=fields.shape,
        dims=("time", "member", "node", "channel"),
        chunks=(min(time_chunk, fields.shape[0]), 1) + fields.shape[2:],
        compression_level=compression_level,
        meta={"kind": "mesh-ensemble", **(meta or {})},
    )
    arr.write(tuple(slice(None) for _ in fields.shape), fields)
    np.savez_compressed(
        path / GRAPH_FILE,
        senders=np.asarray(senders, np.int64),
        receivers=np.asarray(receivers, np.int64),
        verts=(np.zeros((int(fields.shape[2]), 3)) if verts is None else np.asarray(verts)),
    )
    return path


def load_mesh_dataset(path: str | Path, lazy: bool = False):
    """Returns (fields, senders, receivers, verts, meta).

    ``lazy=True`` returns the fields as a streaming
    :class:`~gwen_tpu_torch.data.lazy.LazyField`, for archives that outgrow
    host memory; ``MeshEnsembleDataset`` consumes either form.
    """
    path = Path(path)
    arr = zarrstore.open_array(path)
    if arr.meta.get("kind") != "mesh-ensemble":
        raise ValueError(f"{path} is not a mesh-ensemble store")
    gp = path / GRAPH_FILE
    if not gp.exists():
        raise FileNotFoundError(f"missing graph sidecar {gp}")
    z = np.load(gp)
    if lazy:
        from gwen_tpu_torch.data.lazy import LazyField

        fields = LazyField(arr)
    else:
        fields = arr.read()
    return fields, z["senders"], z["receivers"], z["verts"], arr.meta


def load_mesh_graph(path: str | Path):
    """``(senders, receivers, verts)`` of a mesh-ensemble store's graph
    sidecar, without touching the fields."""
    gp = Path(path) / GRAPH_FILE
    if not gp.exists():
        raise FileNotFoundError(f"missing graph sidecar {gp}")
    z = np.load(gp)
    return z["senders"], z["receivers"], z["verts"]
