"""The system under test, built as ``python -m gwen_tpu_torch train-mesh``
builds it on the card: the icosphere, the KD-patch order, the GCN graph,
the weighted diag-window layout (with transpose tables for attention) and
the ``EncodeProcessDecode`` model, whose weights the benchmark loads.

The only module of the benchmark that imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class Program:
    """The program's mesh, once per process: ``perm`` maps the program's
    node order to the icosphere's (program row ``i`` is node
    ``perm[i]``)."""

    graph: object
    perm: torch.Tensor
    num_nodes: int


def build_graph(cfg: dict, device: torch.device) -> Program:
    from gwen_tpu_torch.graph import (
        apply_order,
        build_graph as coo_graph,
        icosphere_edges,
        kd_patch_order,
        to_diag_window,
    )

    g, m = cfg["graph"], cfg["model"]
    verts, s, r = icosphere_edges(g["refine"])
    n = verts.shape[0]
    perm = kd_patch_order(np.asarray(verts), s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    graph = to_diag_window(
        coo_graph(s2, r2, n), window_size=g["diag_window"],
        block_size=g["block"], superblock=g["superblock"],
        dtype=DTYPES[m["compute_dtype"]],
        transpose_tables=m["processor"] == "attention", packed=g["packed"])
    return Program(graph.to(device), torch.from_numpy(perm).to(device), n)


def build_model(cfg: dict, params: dict, device: torch.device):
    """The model with the benchmark's parameters loaded by name."""
    from gwen_tpu_torch.nn import EncodeProcessDecode

    m = cfg["model"]
    model = EncodeProcessDecode(
        m["channels"], m["channels"], device=device,
        latent_size=m["latent_size"], process_steps=m["process_steps"],
        mlp_layers=m["mlp_layers"], residual=m["residual"], remat=m["remat"],
        compute_dtype=DTYPES[m["compute_dtype"]], processor=m["processor"],
        attn_heads=m["attn_heads"])
    model.load_state_dict(params, strict=True)
    return model


def build_trainer(mix: dict, model, graph, device: torch.device):
    """``(trainer, state)``: ``Trainer`` on the mix's next-step loss with the
    graph as its context, and Adam at the mix's rate."""
    from gwen_tpu_torch.train import Trainer, TrainState, make_optimizer, mesh_graph_loss_fn

    opt = make_optimizer(model.parameters(), mix["optimizer"]["lr"])
    trainer = Trainer(mesh_graph_loss_fn(model, mix["train_loss"]), device,
                      context=graph)
    return trainer, TrainState(model, opt)


def first_gradients(state, beta1: float) -> dict:
    """The gradient each parameter had at the first update, read back from
    Adam's first moment after exactly one step (``m = (1 − β1) g``); zero
    for a parameter the optimizer has not stepped."""
    opt = state.optimizer.optim
    return {name: (opt.state[p]["exp_avg"].detach().clone() / (1 - beta1)
                   if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p))
            for name, p in state.model.named_parameters()}


def generate(model, graph, base: torch.Tensor, white: torch.Tensor,
             steps: int, sigma: float, smoothing: int) -> torch.Tensor:
    """One ensemble request through ``generate_ensemble``: ``(K, T, N, C)``."""
    from gwen_tpu_torch.ensemble import generate_ensemble

    return generate_ensemble(model, graph, base, None, white.shape[0], steps,
                             sigma=sigma, smoothing_steps=smoothing, noise=white)
