"""Losses of the mesh training path: counterpart of ``gwen_tpu.losses``,
cut to the MSE and L1 losses and ``rmse`` (CRPS comes with slice 4).
Each returns a 0-d tensor in the inputs' dtype."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def mse_loss(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean(torch.abs(pred - target))


def rmse(pred: Tensor, target: Tensor) -> Tensor:
    return torch.sqrt(mse_loss(pred, target))
