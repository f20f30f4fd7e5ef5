"""Ensemble-member perturbation sampling and skill verification:
counterpart of ``gwen_tpu.ensemble``.

Generate additional ensemble members by perturbing initial conditions on
the member axis with graph-correlated noise, roll the model forward, and
score the generated ensemble against held-out members with proper scores
(fair ensemble CRPS, RMSE of the ensemble mean, spread/skill ratio).

Randomness is explicit: every function that draws takes a
``torch.Generator`` (on the device the noise is to live on) and,
optionally, the white noise itself as a tensor, which then is used in
place of a draw. ``jax.random`` and torch give different numbers from one
seed, so a comparison with the reference hands both the same noise. The
model is an ``nn.Module`` that holds its parameters, so the reference's
``params`` argument has no counterpart.

The member axis rides the batched aggregation kernels as a leading axis
(:func:`gwen_tpu_torch.ops.aggregate` folds leading axes into one batch);
there is no loop over members.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gwen_tpu_torch import losses
from gwen_tpu_torch.ops.aggregate import aggregate
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor
SIGMAS = (0.01, 0.02, 0.05, 0.1, 0.2)  # calibrate_sigma's default candidates


def _white(generator: Optional[torch.Generator], shape: Sequence[int],
           dtype: torch.dtype, noise: Optional[Tensor]) -> Tensor:
    """The white noise of one draw: ``noise`` if given (checked against
    ``shape``), else standard normal from ``generator`` on its device."""
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise has shape {tuple(noise.shape)}; the draw "
                             f"is {tuple(shape)}")
        return noise.to(dtype)
    if generator is None:
        raise ValueError("a draw needs a torch.Generator or the noise itself")
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device)


def correlated_noise(generator: Optional[torch.Generator], graph,
                     shape: Sequence[int], smoothing_steps: int = 2,
                     dtype: torch.dtype = torch.float32, *,
                     noise: Optional[Tensor] = None) -> Tensor:
    """Spatially-correlated field noise: white noise smoothed by repeated
    normalised-adjacency aggregation over the mesh graph, then restored to
    unit variance per field. ``shape`` is ``(..., nodes, channels)``;
    smoothing acts on the node axis."""
    eps = _white(generator, shape, dtype, noise)
    for _ in range(smoothing_steps):
        eps = aggregate(graph, eps)
    std = eps.std(dim=(-2, -1), keepdim=True, unbiased=False) + 1e-8
    return eps / std


def sample_perturbed_members(generator: Optional[torch.Generator],
                             base_state: Tensor, num_members: int,
                             sigma: float = 0.1, graph=None,
                             smoothing_steps: int = 2, batch_dims: int = 0, *,
                             noise: Optional[Tensor] = None) -> Tensor:
    """K perturbed initial conditions from one base state.

    ``base_state`` ``(nodes, channels)`` → ``(K, nodes, channels)``; with
    ``batch_dims=d`` the member axis is inserted after the first ``d``
    leading axes (``(B, N, C)`` → ``(B, K, N, C)``), the layout the
    CRPS-ensemble loss consumes. With a graph the noise is spatially
    correlated, without it white. All members come from one
    ``(..., K, ...)`` draw."""
    shape = (*base_state.shape[:batch_dims], num_members,
             *base_state.shape[batch_dims:])
    if graph is not None:
        eps = correlated_noise(generator, graph, shape, smoothing_steps,
                               base_state.dtype, noise=noise)
    else:
        eps = _white(generator, shape, base_state.dtype, noise)
    return base_state.unsqueeze(batch_dims) + sigma * eps.to(base_state.device)


def rollout(step_fn: Callable[[Tensor], Tensor], state: Tensor,
            num_steps: int) -> Tensor:
    """Autoregressive rollout: the ``(num_steps, *state.shape)`` trajectory.
    A Python loop; wrap the call in ``torch.no_grad()`` where the trajectory
    is not differentiated."""
    states = []
    for _ in range(num_steps):
        state = step_fn(state)
        states.append(state)
    return torch.stack(states)


def ensemble_skill(generated: Tensor, reference: Tensor,
                   ensemble_axis: int = 0) -> dict:
    """Skill scores of a generated ensemble against a reference field.

    ``generated`` holds the ensemble on ``ensemble_axis``; ``reference``
    has the same shape without that axis. Returns the fair CRPS, the RMSE
    of the ensemble mean, the mean spread (sample standard deviation across
    members) and the spread/error ratio (about 1 for a well-calibrated
    ensemble)."""
    gen = generated.movedim(ensemble_axis, 0)
    m = gen.shape[0]
    rmse_mean = losses.rmse(gen.mean(dim=0), reference)
    spread = (torch.sqrt(torch.mean(gen.var(dim=0, unbiased=True)))
              if m > 1 else gen.new_zeros(()))
    crps = losses.crps_ensemble(gen, reference, ensemble_axis=0, fair=True)
    spread_error = spread * ((m + 1) / m) ** 0.5 / (rmse_mean + 1e-12)
    return {
        "crps": float(crps),
        "rmse_ensemble_mean": float(rmse_mean),
        "spread": float(spread),
        "spread_error_ratio": float(spread_error),
    }


def generate_ensemble(model, graph, base_state: Tensor,
                      generator: Optional[torch.Generator], num_members: int,
                      num_steps: int, sigma: float = 0.1,
                      smoothing_steps: int = 2, *,
                      noise: Optional[Tensor] = None) -> Tensor:
    """Perturb, then roll every member forward: ``(K, T, nodes, channels)``.
    The members ride the model's batch axis (one forward per step for all of
    them). Runs without gradients. Under a profiler the request is the span
    ``gwen.ensemble`` over one ``gwen.perturb`` and a ``gwen.lead_step``
    a step."""
    def lead_step(x):
        with annotate("gwen.lead_step"):
            return model(graph, x)

    with annotate("gwen.ensemble"), torch.no_grad():
        with annotate("gwen.perturb"):
            members = sample_perturbed_members(
                generator, base_state, num_members, sigma, graph,
                smoothing_steps, noise=noise)
        traj = rollout(lead_step, members, num_steps)
    return traj.movedim(0, 1)


def inflate_ensemble(generated: Tensor, factor: float,
                     ensemble_axis: int = 0) -> Tensor:
    """Multiplicative ensemble inflation: scale each member's deviation
    from the ensemble mean by ``factor``. The mean (and its RMSE) stay, the
    spread scales linearly, so ``factor ≈ 1 / ratio`` restores calibration
    of an under-dispersive ensemble."""
    mean = generated.mean(dim=ensemble_axis, keepdim=True)
    return mean + factor * (generated - mean)


def calibrate_inflation(generated: Tensor, reference: Tensor,
                        ensemble_axis: int = 0, target_ratio: float = 1.0,
                        max_factor: float = 10.0) -> float:
    """Closed-form inflation factor from one validation ensemble:
    ``target_ratio / current_ratio``, clamped to ``[1 / max_factor,
    max_factor]`` (1.0 where the ratio is not positive)."""
    ratio = ensemble_skill(generated, reference, ensemble_axis)["spread_error_ratio"]
    if not (ratio > 0):
        return 1.0
    return float(min(max(target_ratio / ratio, 1.0 / max_factor), max_factor))


def calibrate_sigma(model, graph, fields_val,
                    generator: Optional[torch.Generator],
                    sigmas: Sequence[float] = SIGMAS,
                    num_members: int = 8, horizon: int = 4,
                    smoothing_steps: int = 2, *,
                    noise: Optional[Tensor] = None) -> dict:
    """Pick the perturbation amplitude by validation CRPS.

    For each candidate sigma, generate an ensemble from every validation
    member's initial state and score it against that member's own
    trajectory. ``fields_val`` is ``(time, member, nodes, channels)``.
    Returns the best sigma and the per-sigma table (CRPS and spread/error
    ratio). ``noise``, if given, is ``(len(sigmas), members, num_members,
    nodes, channels)``: the white noise of every draw, in order."""
    device = noise.device if noise is not None else generator.device
    fields_val = torch.as_tensor(np.asarray(fields_val)).to(device)
    t, m = fields_val.shape[:2]
    horizon = min(horizon, t - 1)
    table = []
    for si, sigma in enumerate(sigmas):
        crps_vals, ratio_vals = [], []
        for mi in range(m):
            gen = generate_ensemble(
                model, graph, fields_val[0, mi], generator,
                num_members=num_members, num_steps=horizon, sigma=float(sigma),
                smoothing_steps=smoothing_steps,
                noise=None if noise is None else noise[si, mi])
            skill = ensemble_skill(gen, fields_val[1: 1 + horizon, mi])
            crps_vals.append(skill["crps"])
            ratio_vals.append(skill["spread_error_ratio"])
        table.append({
            "sigma": float(sigma),
            "crps": float(np.mean(crps_vals)),
            "spread_error_ratio": float(np.mean(ratio_vals)),
        })
    best = min(table, key=lambda row: row["crps"])
    return {"best_sigma": best["sigma"], "table": table}
