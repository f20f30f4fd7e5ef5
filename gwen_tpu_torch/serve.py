"""Serving artifacts: load the reference's export format and serve it.

Counterpart of ``gwen_tpu.serve``. An artifact directory holds
``arrays.npz`` (every array leaf) and ``meta.json`` (the pytree specs, the
input shape and the training run's hyperparameters under ``metadata``),
as written by the reference's ``gwen-tpu export`` or by
:func:`export_model` here. The reference's ``model.stablehlo`` is a JAX
program and is not read: :class:`ServingModel` rebuilds the model from the
stored hyperparameters and the graph from the stored mesh level or, for a
run trained from a mesh-ensemble store (``metadata["data"]``), from that
store's graph sidecar (the
reference's ``export_cli.py`` recipe: icosphere or stored mesh, KD-patch order,
``to_diag_window``, with transpose tables for the attention processor; an
interaction artifact takes RCM order and the COO graph, the only container
its edge MLP runs on), then loads the stored weights.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from gwen_tpu_torch.graph import (
    apply_order,
    build_graph,
    icosphere_edges,
    kd_patch_order,
    rcm_order,
    to_diag_window,
)
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax, params_to_tree

_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def pack_tree(tree, leaves: list) -> Any:
    """Encode a tree of dicts/lists/tuples/literals/arrays as a JSON-able
    spec (the reference's codec); array leaves are appended to ``leaves``
    as numpy arrays. A bfloat16 tensor is stored as its uint16 bit pattern
    with ``"dt": "bfloat16"``, as the reference stores it."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"k": "lit", "v": tree}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            leaves.append(t.view(torch.int16).numpy().view(np.uint16))
            return {"k": "arr", "i": len(leaves) - 1, "dt": "bfloat16"}
        tree = t.numpy()
    if isinstance(tree, np.ndarray):
        leaves.append(tree)
        return {"k": "arr", "i": len(leaves) - 1, "dt": tree.dtype.name}
    if isinstance(tree, dict):
        return {"k": "dict",
                "v": {str(k): pack_tree(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"k": "list" if isinstance(tree, list) else "tuple",
                "v": [pack_tree(v, leaves) for v in tree]}
    raise TypeError(f"pack_tree: unsupported node type {type(tree).__name__}")


def unpack_tree(spec: Any, leaves: list) -> Any:
    """Inverse of :func:`pack_tree`; array leaves come back as CPU tensors.
    A ``struct`` spec (the reference's graph containers) decodes to None:
    the port rebuilds its own graph."""
    kind = spec["k"]
    if kind == "lit":
        return spec["v"]
    if kind == "arr":
        leaf = np.ascontiguousarray(leaves[spec["i"]])
        want = spec.get("dt")
        if want is None or leaf.dtype.name == want:
            return torch.from_numpy(leaf)
        if want not in _TORCH_DTYPES or leaf.dtype.itemsize != 2:
            raise ValueError(f"unpack_tree: cannot read a {want} leaf "
                             f"stored as {leaf.dtype}")
        return torch.from_numpy(leaf.view(np.int16)).view(_TORCH_DTYPES[want])
    if kind == "dict":
        return {k: unpack_tree(v, leaves) for k, v in spec["v"].items()}
    if kind == "list":
        return [unpack_tree(v, leaves) for v in spec["v"]]
    if kind == "tuple":
        return tuple(unpack_tree(v, leaves) for v in spec["v"])
    if kind == "struct":
        return None
    raise ValueError(f"unpack_tree: unknown node kind {kind!r}")


def export_model(model: EncodeProcessDecode, sample_input: np.ndarray, path,
                 metadata: dict, rollout_steps: int = 0) -> Path:
    """Write ``model``'s weights as an artifact in the reference's format
    (``arrays.npz`` + ``meta.json``, no ``model.stablehlo``).
    ``rollout_steps`` is recorded as the reference records the length of
    its compiled rollout; the port compiles none (see
    :meth:`ServingModel.rollout`).

    ``metadata`` must carry the run hyperparameters that
    :meth:`ServingModel.load` rebuilds from: ``levels``, ``channels``,
    ``latent_size``, ``process_steps``, ``mlp_layers``, ``residual``,
    ``compute_dtype``, ``diag_window`` and ``processor`` (and, for
    attention, ``attn_heads`` and ``attn_pack``).
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves: list[np.ndarray] = []
    spec = {
        "params": pack_tree(params_to_tree(model.state_dict()), leaves),
        "graph": pack_tree(None, leaves),
        "input": {"shape": list(np.shape(sample_input)),
                  "dtype": np.asarray(sample_input).dtype.name},
        "platforms": [],
        "torch_version": torch.__version__,
        "rollout_steps": int(rollout_steps),
        "metadata": metadata,
    }
    np.savez(path / "arrays.npz",
             **{f"a{i}": leaf for i, leaf in enumerate(leaves)})
    (path / "meta.json").write_text(json.dumps(spec))
    return path


def model_from_metadata(md: dict, device) -> EncodeProcessDecode:
    """An :class:`EncodeProcessDecode` built from a run's hyperparameters
    (an artifact's ``metadata``, or the ``model.json`` that
    :meth:`gwen_tpu_torch.registry.Run.save_model` writes), with its
    parameters still to be loaded."""
    dtype = (torch.bfloat16 if md.get("compute_dtype", "bfloat16") == "bfloat16"
             else torch.float32)
    ch = int(md["channels"])
    return EncodeProcessDecode(
        ch, ch, device=device,
        latent_size=int(md["latent_size"]),
        process_steps=int(md["process_steps"]),
        mlp_layers=int(md.get("mlp_layers", 2)),
        residual=bool(md.get("residual", True)),
        compute_dtype=dtype,
        processor=md.get("processor", "gcn"),
        attn_heads=int(md.get("attn_heads", 2)),
        attn_pack=md.get("attn_pack", "auto"),
    )


class ServingModel:
    """A loaded artifact: ``step`` runs one forward, ``rollout`` many.

    States are in the graph's node order (KD-patch; RCM for an interaction
    artifact); ``node_perm`` maps original node ``perm[i]`` to row ``i``.
    """

    def __init__(self, model: EncodeProcessDecode, graph, node_perm: np.ndarray,
                 meta: dict):
        self.model = model
        self.graph = graph
        self.node_perm = node_perm
        self.meta = meta

    @classmethod
    def load(cls, path, device) -> "ServingModel":
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "arrays.npz") as z:
            leaves = [z[f"a{i}"] for i in range(len(z.files))]
        params = unpack_tree(meta["params"], leaves)
        md = meta.get("metadata", {})
        processor = md.get("processor", "gcn")
        if processor not in ("gcn", "attention", "interaction"):
            raise ValueError(f"artifact uses an unknown processor "
                             f"{processor!r}")
        if md.get("data"):
            # Trained from a mesh-ensemble store: its sidecar holds the
            # mesh (a missing store raises FileNotFoundError).
            from gwen_tpu_torch.data.meshstore import load_mesh_graph

            s, r, verts = load_mesh_graph(md["data"])
            n = int(max(s.max(), r.max())) + 1
            mesh_name = f"the mesh of {md['data']}"
        else:
            verts, s, r = icosphere_edges(int(md["levels"]))
            n = verts.shape[0]
            mesh_name = f"the L{md['levels']} icosphere"
        if md.get("nodes") is not None and int(md["nodes"]) != n:
            raise ValueError(f"artifact was trained on {md['nodes']} nodes; "
                             f"{mesh_name} has {n}")
        interaction = processor == "interaction"
        perm = rcm_order(s, r, n) if interaction else kd_patch_order(verts, s, r, n)
        s2, r2, _ = apply_order(perm, s, r)
        model = model_from_metadata(md, device)
        graph = build_graph(s2, r2, n)
        if not interaction:
            graph = to_diag_window(graph,
                                   window_size=int(md.get("diag_window", 384)),
                                   dtype=model.compute_dtype,
                                   transpose_tables=processor == "attention")
        graph = graph.to(device)
        model.load_state_dict(params_from_jax(params))
        model.eval()
        return cls(model, graph, perm, meta)

    @property
    def input_shape(self) -> tuple:
        return tuple(self.meta["input"]["shape"])

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One forward step (kernel node order)."""
        with torch.inference_mode():
            return self.model(self.graph, x)

    @property
    def rollout_steps(self) -> int:
        """Steps per dispatch that the artifact records (0: none)."""
        return int(self.meta.get("rollout_steps", 0))

    def rollout(self, x0: torch.Tensor, num_steps: int) -> torch.Tensor:
        """Autoregressive rollout: ``(num_steps, *state_shape)``. The
        reference dispatches ``rollout_steps`` steps at a time as one
        compiled scan; the port has no compiled program to load, so it
        runs :meth:`step` once a step whatever ``rollout_steps`` says."""
        states = []
        x = x0
        for _ in range(num_steps):
            x = self.step(x)
            states.append(x)
        return torch.stack(states)
