"""Loss library: counterpart of ``gwen_tpu.losses``.

The MSE and L1 losses of the mesh training path, the target-node masked L1
and the masked loss of the GNN trainer, the reference's Gaussian-surrogate
and variance-regularised ensemble losses, the analytic Gaussian CRPS, and
the proper (fair) ensemble CRPS used for training and skill verification.
Each returns a 0-d tensor in the inputs' dtype."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_SQRT2 = 1.4142135623730951
_INV_SQRT_PI = 0.5641895835477563


def _norm_cdf(z: Tensor) -> Tensor:
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def mse_loss(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean(torch.abs(pred - target))


def rmse(pred: Tensor, target: Tensor) -> Tensor:
    return torch.sqrt(mse_loss(pred, target))


def masked_node_l1(output: Tensor, x: Tensor, target_mask: Tensor,
                   node_axis: int = -2) -> Tensor:
    """L1 over target-masked nodes only: a weighted mean, ``target_mask``
    1-d over the node axis (default ``(..., nodes, features)``)."""
    mask = target_mask.to(output.dtype)
    shape = [1] * output.dim()
    shape[node_axis] = mask.shape[0]
    mask = mask.reshape(shape)
    diff = torch.abs(output - x) * mask
    # Each masked node contributes output.numel() / num_nodes elements.
    per_node = output.numel() // target_mask.numel()
    denom = torch.clamp(mask.sum() * per_node, min=1.0)
    return diff.sum() / denom


def crps_gaussian_surrogate(preds: Tensor, target: Tensor,
                            ensemble_axis: int = 1) -> Tensor:
    """The reference's ``CRPSLoss`` surrogate: fit a Gaussian over the
    ensemble axis (population standard deviation) and return
    ``mean((Phi((y - mu) / sigma) - 0.5)^2)``. Not a proper score; see
    :func:`crps_gaussian` and :func:`crps_ensemble`."""
    mu = preds.mean(dim=ensemble_axis, keepdim=True)
    sigma = preds.std(dim=ensemble_axis, keepdim=True, unbiased=False) + 1e-6
    z = (target - mu) / sigma
    return torch.mean((_norm_cdf(z) - 0.5) ** 2)


def crps_gaussian(mu: Tensor, sigma: Tensor, target: Tensor) -> Tensor:
    """Analytic CRPS of a Gaussian forecast (Gneiting & Raftery 2007,
    eq. 21)."""
    sigma = torch.clamp(sigma, min=1e-8)
    z = (target - mu) / sigma
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    crps = sigma * (z * (2.0 * _norm_cdf(z) - 1.0) + 2.0 * pdf - _INV_SQRT_PI)
    return torch.mean(crps)


def crps_ensemble(preds: Tensor, target: Tensor, ensemble_axis: int = 0,
                  fair: bool = True) -> Tensor:
    """Empirical ensemble CRPS ``E|X − y| − ½ E|X − X'|``, the pair term
    over ``m(m − 1)`` pairs when ``fair`` (and m > 1), else ``m²``.
    ``preds`` holds the ensemble on ``ensemble_axis``; ``target`` has the
    same shape without that axis."""
    preds = preds.movedim(ensemble_axis, 0)
    m = preds.shape[0]
    term1 = torch.mean(torch.abs(preds - target[None]), dim=0)
    # Pairwise spread via O(m²); m is small (ensemble members).
    diffs = torch.abs(preds[:, None] - preds[None, :])  # (m, m, ...)
    denom = m * (m - 1) if (fair and m > 1) else m * m
    term2 = diffs.sum(dim=(0, 1)) / max(denom, 1)
    return torch.mean(term1 - 0.5 * term2)


def ensemble_variance_regularized_l1(preds: Tensor, target: Tensor,
                                     alpha: float = 0.1,
                                     ensemble_axis: int = 1) -> Tensor:
    """The reference's ``EnsembleVarRegLoss``: ``L1(preds, target) − alpha ·
    mean(var(preds, ensemble_axis))`` (population variance); rewards
    spread."""
    l1 = torch.mean(torch.abs(preds - target))
    spread = torch.mean(preds.var(dim=ensemble_axis, unbiased=False))
    return l1 - alpha * spread


def masked_loss(pred: Tensor, target: Tensor, mask: Tensor,
                base: str = "l1") -> Tensor:
    """The reference's ``MaskedLoss``: zero out constant cells and
    normalise by the mask sum."""
    mask_b = torch.broadcast_to(mask.to(pred.dtype), pred.shape)
    if base == "l1":
        err = torch.abs(pred - target)
    elif base == "mse":
        err = (pred - target) ** 2
    else:
        raise ValueError(f"unknown base loss {base!r}")
    return (err * mask_b).sum() / torch.clamp(mask_b.sum(), min=1.0)


def variance_mask(data: "numpy.ndarray | Tensor", threshold: float,
                  time_axis: int = 0) -> Tensor:
    """float32 mask of the cells whose (population) variance over time
    exceeds ``threshold``: 1.0 where the cell is active."""
    data = torch.as_tensor(data)
    var = data.var(dim=time_axis, unbiased=False)
    return (var > threshold).to(torch.float32)


LOSSES = {
    "l1": l1_loss,
    "l1-masked": masked_node_l1,
    "crps": crps_gaussian_surrogate,
    "crps-gaussian": crps_gaussian,
    "crps-ensemble": crps_ensemble,
    "ensemble-var-reg": ensemble_variance_regularized_l1,
    "masked": masked_loss,
    "rmse": rmse,
}
