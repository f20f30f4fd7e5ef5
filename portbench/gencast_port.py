"""The system under test for the GenCast cell, built as the port builds it:
the configuration as ``gwen_tpu_torch``'s own (``model.architecture
"gencast"``), its graphs (the k-hop lists built on the card), the model
with the benchmark's parameters, and ``Trainer`` on the EDM denoising task
with the graphs as its context. Beside ``port.py`` and
``graphcast_port.py``, the only module of the benchmark that imports the
program for this cell.
"""

from __future__ import annotations

import contextlib
import json

import torch

# The program's graphs by their configuration and device: the control's
# seeds share one process and one build.
_GRAPHS: dict[tuple, object] = {}


def require() -> None:
    """Import the program's GenCast; raises ``ImportError`` on a program
    that has none."""
    import gwen_tpu_torch.nn.gencast  # noqa: F401


def program_config(cfg: dict):
    """The benchmark configuration as the port's ``GwenConfig``."""
    from gwen_tpu_torch.config import GwenConfig

    m, g = cfg["model"], cfg["graph"]
    return GwenConfig.from_dict({
        "model": {k: m[k] for k in ("architecture", "channels_in", "channels_out",
                                    "latent_size", "process_steps", "attn_heads",
                                    "ffn_size", "compute_dtype", "param_dtype")},
        "graph": {k: g[k] for k in ("grid_lat", "grid_lon", "refine", "g2m_radius",
                                    "k_hop")},
        "train": {"remat": m["remat"]}})


def build_graphs(cfg: dict, device: torch.device):
    """The program's ``GenCastGraphs`` on ``device`` (built once a process
    and device)."""
    from gwen_tpu_torch.nn.gencast import gencast_graphs

    key = (json.dumps(cfg["graph"], sort_keys=True), str(device))
    if key not in _GRAPHS:
        _GRAPHS[key] = gencast_graphs(program_config(cfg), device)
    return _GRAPHS[key]


def sizes(graphs) -> dict[str, int]:
    """Node, edge and pair counts, as ``roofline/gencast.py`` takes them
    (``mesh_edges``: the mesh's directed edges, ``6 (N − 2)`` on an
    icosphere level)."""
    return {"grid": graphs.num_grid, "mesh": graphs.num_mesh,
            "g2m": graphs.grid2mesh.num_edges, "m2g": graphs.mesh2grid.num_edges,
            "mesh_edges": 6 * (graphs.num_mesh - 2), "pairs": graphs.mesh.num_pairs}


def build_model(cfg: dict, params: dict, device: torch.device):
    """The model of the port's configuration with the benchmark's
    parameters loaded by name."""
    from gwen_tpu_torch.nn.gencast import gencast_from_config

    model = gencast_from_config(program_config(cfg), device)
    model.load_state_dict(params, strict=True)
    return model


def build_trainer(cfg: dict, mix: dict, model, graphs, device: torch.device):
    """``(trainer, state)``: ``Trainer`` on the EDM denoising task with the
    graphs as its context, and AdamW at the mix's settings."""
    from gwen_tpu_torch.train import Trainer, TrainState, gencast_denoising_loss_fn, make_optimizer
    from gwen_tpu_torch.train.tasks import graphcast_channel_weights

    g, loss, edm = cfg["graph"], cfg["loss"], cfg["edm"]
    o = mix["optimizer"]
    opt = make_optimizer(model.parameters(), o["lr"], weight_decay=o["weight_decay"],
                         betas=tuple(o["betas"]))
    weights = graphcast_channel_weights(loss["levels_hpa"], loss["atmospheric"],
                                        loss["surface_weights"])
    task = gencast_denoising_loss_fn(model, g["grid_lat"], g["grid_lon"], weights,
                                     p_mean=edm["p_mean"], p_std=edm["p_std"],
                                     sigma_data=edm["sigma_data"])
    return Trainer(task, device, context=graphs), TrainState(model, opt)


@contextlib.contextmanager
def first_attention(held: list):
    """Within, the program's attention operator (``windowed_attention`` as
    ``nn/attention.py`` calls it) runs as it does, and the first call's
    ``(q, k, v, out)`` are appended to ``held`` as copies of what the
    operator took and gave, ``(H, ..., N, dh)`` in the mesh's row order."""
    from gwen_tpu_torch.nn import attention

    inner = attention.windowed_attention

    def held_call(graph, q, k, v, **kw):
        out = inner(graph, q, k, v, **kw)
        if not held:
            held.append(tuple(t.detach().clone() for t in (q, k, v, out)))
        return out

    attention.windowed_attention = held_call
    try:
        yield
    finally:
        attention.windowed_attention = inner


def attn_pairs() -> int:
    """The program's counter of attended (row, source) pairs."""
    from gwen_tpu_torch.nn import gencast

    return gencast.attn_pairs
