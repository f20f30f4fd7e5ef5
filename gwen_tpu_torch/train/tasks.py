"""Task definitions: counterpart of ``gwen_tpu.train.tasks``, cut to the
mesh next-step task the ``train-mesh`` path trains."""

from __future__ import annotations

from typing import Callable

from gwen_tpu_torch import losses


def mesh_graph_loss_fn(model, loss: str = "mse") -> Callable:
    """``loss_fn((x, y), graph) -> (loss, preds)`` for next-step prediction
    of ``(B, nodes, channels)`` node fields; the graph comes in as the
    Trainer's context."""
    if loss not in ("mse", "l1"):
        raise ValueError(f"unknown mesh loss {loss!r}")
    fn = losses.mse_loss if loss == "mse" else losses.l1_loss

    def loss_fn(batch, graph):
        x, y = batch
        preds = model(graph, x)
        return fn(preds, y), preds

    return loss_fn
