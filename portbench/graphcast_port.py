"""The system under test for the GraphCast cells, built as the port builds
it: the configuration as ``gwen_tpu_torch``'s own (``model.architecture
"graphcast"``), its graphs, the model with the benchmark's parameters,
and ``Trainer`` on the GraphCast task loss with the graphs as its
context. Beside ``port.py``, the only module of the benchmark that
imports the program; ``port.py`` stays the only one for the EPD cells.
"""

from __future__ import annotations

import json

import torch

# The program's graphs on the host, by their configuration: the control's
# seeds share one process and one build.
_GRAPHS: dict[str, object] = {}


def require() -> None:
    """Import the program's GraphCast; raises ``ImportError`` on a program
    that has none."""
    import gwen_tpu_torch.nn.graphcast  # noqa: F401


def program_config(cfg: dict):
    """The benchmark configuration as the port's ``GwenConfig``."""
    from gwen_tpu_torch.config import GwenConfig

    m, g = cfg["model"], cfg["graph"]
    return GwenConfig.from_dict({
        "model": {k: m[k] for k in ("architecture", "channels_in", "channels_out",
                                    "latent_size", "process_steps", "compute_dtype",
                                    "param_dtype")},
        "graph": {k: g[k] for k in ("grid_lat", "grid_lon", "refine", "g2m_radius")},
        "train": {"remat": m["remat"]}})


def build_graphs(cfg: dict, device: torch.device):
    """The program's ``GraphCastGraphs`` on ``device`` (built once a
    process)."""
    from gwen_tpu_torch.nn.graphcast import graphcast_graphs

    key = json.dumps(cfg["graph"], sort_keys=True)
    if key not in _GRAPHS:
        _GRAPHS[key] = graphcast_graphs(program_config(cfg))
    return _GRAPHS[key].to(device)


def sizes(graphs) -> dict[str, int]:
    """Node and edge counts, as ``roofline/graphcast.py`` takes them."""
    return {"grid": graphs.num_grid, "mesh": graphs.num_mesh,
            "g2m": graphs.grid2mesh.num_edges, "mesh_edges": graphs.mesh.num_edges,
            "m2g": graphs.mesh2grid.num_edges}


def build_model(cfg: dict, params: dict, device: torch.device):
    """The model of the port's configuration with the benchmark's
    parameters loaded by name."""
    from gwen_tpu_torch.nn.graphcast import graphcast_from_config

    model = graphcast_from_config(program_config(cfg), device)
    model.load_state_dict(params, strict=True)
    return model


def build_trainer(cfg: dict, mix: dict, model, graphs, device: torch.device):
    """``(trainer, state)``: ``Trainer`` on GraphCast's weighted loss with
    the graphs as its context, and AdamW at the mix's settings."""
    from gwen_tpu_torch.train import Trainer, TrainState, graphcast_loss_fn, make_optimizer
    from gwen_tpu_torch.train.tasks import graphcast_channel_weights

    g, loss = cfg["graph"], cfg["loss"]
    o = mix["optimizer"]
    opt = make_optimizer(model.parameters(), o["lr"], weight_decay=o["weight_decay"],
                         betas=tuple(o["betas"]))
    weights = graphcast_channel_weights(loss["levels_hpa"], loss["atmospheric"],
                                        loss["surface_weights"])
    trainer = Trainer(graphcast_loss_fn(model, g["grid_lat"], g["grid_lon"], weights),
                      device, context=graphs)
    return trainer, TrainState(model, opt)
