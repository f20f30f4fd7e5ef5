"""``python -m gwen_tpu_torch export`` and ``predict``: serving artifacts.

Counterpart of ``gwen_tpu.cli.export_cli``. ``export`` packages the best
mesh-model run of the registry as an artifact (:mod:`gwen_tpu_torch.serve`:
the weights and the hyperparameters that rebuild the model and its graph;
no compiled program) with the node permutation of its graph beside it
(``node_perm.npy``). ``predict`` serves such an artifact: the input is a
``(nodes, channels)`` .npy in *original* node order; it is mapped through
the artifact's node permutation (``ServingModel.node_perm``) and the
trajectory mapped back.
"""

from __future__ import annotations

import numpy as np
import torch

from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.logging_utils import get_logger
from gwen_tpu_torch.registry import Registry, default_experiment

log = get_logger()


def _resolve_hparams(meta: dict, config: GwenConfig) -> dict:
    """Model hyperparameters for export: the run's stored values win. A CLI
    value that differs from both the stored value and the dataclass
    default is a conflicting override and raises ``ValueError`` (another
    processor, head count, residual or MLP depth gives parameters of the
    same shapes, so the artifact would serve wrong predictions; another
    ``diag_window`` changes the attention neighbourhood). A run recorded
    without one of these keys takes the CLI value."""
    model_d, mesh_d = type(config.model)(), type(config.mesh)()
    spec = [
        ("processor", config.model.processor, model_d.processor),
        ("attn_heads", config.model.attn_heads, model_d.attn_heads),
        ("residual", config.model.residual, model_d.residual),
        ("mlp_layers", config.model.mlp_layers, model_d.mlp_layers),
        ("compute_dtype", config.model.compute_dtype, model_d.compute_dtype),
        ("diag_window", config.mesh.diag_window, mesh_d.diag_window),
    ]
    out = {}
    for name, cli_val, default in spec:
        stored = meta.get(name)
        if stored is None:
            out[name] = cli_val
        elif cli_val != default and cli_val != stored:
            raise ValueError(
                f"export: run was trained with {name}={stored!r} but the "
                f"CLI sets {name}={cli_val!r}; drop the override — stored "
                "hyperparameters are authoritative")
        else:
            out[name] = stored
    return out


def export_main(config: GwenConfig, out: str, data: str = "",
                experiment: str = "", rollout_steps: int = 4,
                device: str = "cuda") -> dict:
    """Export the best run of ``experiment`` (default
    ``<run.experiment>_MESH``) to the artifact directory ``out``.

    The mesh comes from the store ``data`` (its graph sidecar) or else from
    the icosphere at the run's ``levels``, and must have the run's node
    count. The model is rebuilt on ``device`` from the stored
    hyperparameters and loads the run's params with every key and shape
    checked. The artifact records ``rollout_steps``; ``node_perm.npy`` is
    the node order :meth:`ServingModel.load` computes for it: KD-patch for
    the GCN and attention processors, RCM for interaction.
    """
    from pathlib import Path

    from gwen_tpu_torch.graph import icosphere_edges, kd_patch_order, rcm_order
    from gwen_tpu_torch.serve import export_model, model_from_metadata

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "export: CUDA is not available; pass --device cpu to export on "
            "the CPU")
    registry = Registry(config.run.registry_root)
    experiment = experiment or (
        (config.run.experiment or default_experiment()) + "_MESH")
    params, meta = registry.load_best_model(experiment)

    hp = _resolve_hparams(meta, config)
    if data:
        from gwen_tpu_torch.data.meshstore import load_mesh_graph

        s, r, verts = load_mesh_graph(data)
        n = int(max(s.max(), r.max())) + 1
    else:
        if meta.get("data"):
            log.info("run was trained on %s; exporting against the L%s "
                     "icosphere — pass --data to use the training mesh",
                     meta["data"], meta["levels"])
        verts, s, r = icosphere_edges(int(meta["levels"]))
        n = verts.shape[0]
    if meta.get("nodes") is not None and n != int(meta["nodes"]):
        raise ValueError(
            f"export: rebuilt mesh has {n} nodes but the run was trained on "
            f"{meta['nodes']} (data={meta.get('data') or 'icosphere'}); pass "
            "--data pointing at the training dataset")

    processor = hp["processor"]
    interaction = processor == "interaction"
    perm = rcm_order(s, r, n) if interaction else kd_patch_order(verts, s, r, n)
    md = {**meta, **hp, "data": data, "experiment": experiment,
          "node_order": "rcm" if interaction else "kd"}
    model = model_from_metadata(md, dev)
    model.load_state_dict(params)
    ch = int(meta["channels"])
    path = export_model(model, np.zeros((n, ch), np.float32), out, md,
                        rollout_steps=rollout_steps)
    np.save(Path(path) / "node_perm.npy", np.asarray(perm, np.int64))
    result = {"artifact": str(path), "nodes": n, "channels": ch,
              "platform": dev.type}
    log.info("exported %s", result)
    return result


def predict_main(artifact: str, input_path: str, steps: int, out: str,
                 device: str = "cuda") -> dict:
    """Load a serving artifact on ``device`` and roll out ``steps`` steps
    from the initial state in ``input_path``; save the ``(steps, nodes,
    channels)`` trajectory to ``out``."""
    from gwen_tpu_torch.serve import ServingModel

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "predict: CUDA is not available; the port serves on an NVIDIA "
            "GPU (pass --device cpu to run the plain versions on the CPU)")
    sm = ServingModel.load(artifact, dev)
    x0 = np.load(input_path)
    if tuple(x0.shape) != sm.input_shape:
        raise ValueError(
            f"input shape {x0.shape} != artifact input {sm.input_shape}")
    perm = sm.node_perm
    x = torch.from_numpy(np.ascontiguousarray(x0[perm], np.float32)).to(dev)
    traj = sm.rollout(x, steps).cpu().numpy()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    traj = traj[:, inv]
    np.save(out, traj)
    result = {"out": out, "steps": steps, "shape": list(traj.shape),
              "device": str(dev)}
    log.info("predicted %s", result)
    return result
