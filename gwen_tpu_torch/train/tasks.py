"""Task definitions: counterpart of ``gwen_tpu.train.tasks``: the
member-graph GNN task of ``train-gnn`` (:func:`gnn_loss_fn`, which closes
over its small graph), the UNet task of ``train-cnn`` (:func:`cnn_loss_fn`)
and the tasks the ``train-mesh`` path trains:
next-step prediction, fair-ensemble-CRPS training on perturbed members, and
rollout-horizon training. Each mesh ``loss_fn(batch, graph) -> (loss,
preds)`` closes over the model; the graph comes in as the Trainer's
context. :func:`mesh_loss_fn` is the reference's apply-fn form of the
next-step task.

With a ``mesh`` (a :class:`~gwen_tpu_torch.train.mesh.ProcessMesh` of the
data axis) the member-graph and UNet tasks train data-parallel: each rank
takes its share of the global batch (``train.mesh.shard_batch``) and
returns ``local_mean / world``. Each of their losses is a mean over the
batch axis with equal shares (masked L1, ``masked_loss`` with its mask sum,
which grows with the batch, the ensemble-variance L1 and the Gaussian CRPS
surrogate over the member axis within each sample), so the trainer's sum
over ranks is the mean over the global batch; a batch kept whole on every
rank gives its full mean over ``world``, which sums to the same.

The ``partitioned_*`` tasks run through a rank's
:class:`~gwen_tpu_torch.parallel.apply.PartitionedApply`. Their batches are
*global* (padded node space, the same on every rank); each rank cuts its
share (``apply_fn.shard``) and returns ``local_mean / world``: the shards
are equal, so the sum over ranks is the mean over the global batch and
nodes (pad rows included, as in the reference's ``shard_map`` mean), and
the sum of the ranks' parameter gradients is its gradient. The trainer does
both sums (``Trainer(mesh=...)``); the predictions stay local."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from gwen_tpu_torch import ensemble, losses
from gwen_tpu_torch.profiling import annotate


def gnn_loss_fn(model, graph, loss: str = "l1-masked",
                mask_threshold_mask=None, var_reg_alpha: float = 0.1,
                mesh=None) -> Callable:
    """Member-graph GNN task. ``loss_fn(batch) -> (loss, preds)`` with
    ``batch = {"x": (B, members, features), "mask": (members,)}`` and,
    from datasets that zero the target rows of the input, ``"target"``
    (the unmasked truth). The model applies to the whole batch at once.
    The loss is L1 over the target-masked member nodes, composed with the
    spatial variance mask ``mask_threshold_mask`` (one value per feature)
    when given; or the ensemble-variance regularizer; or the Gaussian CRPS
    surrogate. ``graph`` must lie on the model's device. With ``mesh`` the
    loss is ``local_mean / mesh.world`` (module docstring)."""
    if mask_threshold_mask is None and loss not in (
            "l1-masked", "ensemble-var-reg", "crps"):
        raise ValueError(f"unknown GNN loss {loss!r}")
    world = 1 if mesh is None else mesh.world

    def loss_fn(batch):
        x, target_mask = batch["x"], batch["mask"]
        target = batch.get("target", x)
        preds = model(graph, x)
        if mask_threshold_mask is not None:
            # Count only the active cells of target members.
            fmask = torch.as_tensor(mask_threshold_mask, dtype=preds.dtype,
                                    device=preds.device).reshape(1, 1, -1)
            nmask = target_mask.to(preds.dtype).reshape(1, -1, 1)
            value = losses.masked_loss(preds, target, fmask * nmask)
        elif loss == "l1-masked":
            value = losses.masked_node_l1(preds, target, target_mask)
        elif loss == "ensemble-var-reg":
            value = losses.ensemble_variance_regularized_l1(
                preds, target, alpha=var_reg_alpha, ensemble_axis=1)
        else:
            value = losses.crps_gaussian_surrogate(preds, target, ensemble_axis=1)
        return value / world, preds

    return loss_fn


def cnn_loss_fn(model, loss: str = "l1", spatial_mask=None,
                mesh=None) -> Callable:
    """UNet task: ``loss_fn((x, y)) -> (loss, preds)`` on member-channel
    fields ``(B, C, height, ncells)``. With ``spatial_mask`` (one value per
    ``(height, ncells)`` cell) the loss is :func:`losses.masked_loss` of
    base ``loss``; otherwise L1 or MSE. With ``mesh`` it is ``local_mean /
    mesh.world`` (module docstring)."""
    if loss not in ("l1", "mse"):
        raise ValueError(f"unknown CNN loss {loss!r}")
    fn = losses.l1_loss if loss == "l1" else losses.mse_loss
    world = 1 if mesh is None else mesh.world

    def loss_fn(batch):
        x, y = batch
        preds = model(x)
        if spatial_mask is None:
            return fn(preds, y) / world, preds
        mask = torch.as_tensor(spatial_mask, dtype=preds.dtype,
                               device=preds.device)
        return losses.masked_loss(preds, y, mask, base=loss) / world, preds

    return loss_fn


def mesh_loss_fn(apply_fn: Callable, loss: str = "mse") -> Callable:
    """Next-step prediction through ``apply_fn(x) -> preds``, the
    reference's apply-fn form of the task: ``loss_fn((x, y)) -> (loss,
    preds)`` on ``(B, nodes, channels)`` node fields, ``loss`` ``"mse"`` or
    ``"l1"``. ``apply_fn`` is a model bound to its graph, or a rank's
    :class:`~gwen_tpu_torch.parallel.apply.PartitionedApply`; the latter
    takes the partitioned rule of :func:`partitioned_mesh_loss_fn` (global
    batches, ``local_mean / world``)."""
    from gwen_tpu_torch.parallel.apply import PartitionedApply

    if isinstance(apply_fn, PartitionedApply):
        return partitioned_mesh_loss_fn(apply_fn, loss)
    fn = _mean_loss(loss)

    def loss_fn(batch):
        x, y = batch
        preds = apply_fn(x)
        return fn(preds, y), preds

    return loss_fn


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


# GraphCast's loss weights (Lam et al. 2023): the 37 pressure levels of its
# 0.25° ERA5 model in hPa, and the weights of its 5 surface variables (2 m
# temperature; 10 m u and v wind, mean sea-level pressure and total
# precipitation), the 6 atmospheric variables weighing 1.
PRESSURE_LEVELS_HPA = (1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175,
                       200, 225, 250, 300, 350, 400, 450, 500, 550, 600, 650,
                       700, 750, 775, 800, 825, 850, 875, 900, 925, 950, 975,
                       1000)
SURFACE_WEIGHTS = (1.0, 0.1, 0.1, 0.1, 0.1)


def latitude_weights(n_lat: int) -> np.ndarray:
    """Each latitude row's cell area on a grid from −90° to 90° with the
    poles, normalised to mean 1: ``cos(lat) · sin(Δ/2)``, the pole rows
    ``sin²(Δ/4)``."""
    lat = np.deg2rad(np.linspace(-90.0, 90.0, n_lat))
    delta = np.pi / (n_lat - 1)
    w = np.cos(lat) * np.sin(delta / 2)
    w[[0, -1]] = np.sin(delta / 4) ** 2
    return w / w.mean()


def graphcast_channel_weights(levels: Sequence[float] = PRESSURE_LEVELS_HPA,
                              atmospheric: int = 6,
                              surface: Sequence[float] = SURFACE_WEIGHTS
                              ) -> np.ndarray:
    """``(atmospheric · len(levels) + len(surface),)``: the atmospheric
    variables first, each over the levels with weights proportional to
    pressure at mean 1, then the surface variables' weights."""
    lv = np.asarray(levels, np.float64)
    return np.concatenate([np.tile(lv / lv.mean(), atmospheric),
                           np.asarray(surface, np.float64)])


def graphcast_loss_fn(model, n_lat: int, n_lon: int,
                      channel_weights: np.ndarray) -> Callable:
    """GraphCast's next-step task: ``loss_fn((x, y), graphs) -> (loss,
    preds)`` on grid fields ``(B, n_lat · n_lon, C)`` (latitude rows,
    longitude fastest): the mean over samples, grid nodes and channels of
    the squared error weighted by :func:`latitude_weights` of the node's
    row and by ``channel_weights`` of the channel."""
    host = (np.repeat(latitude_weights(n_lat), n_lon), np.asarray(channel_weights))
    on: dict = {}

    def loss_fn(batch, graphs):
        x, y = batch
        preds = model(graphs, x)
        if preds.device not in on:
            on[preds.device] = tuple(torch.as_tensor(w, dtype=torch.float32, device=preds.device)
                                     for w in host)
        w_node, w_chan = on[preds.device]
        err = ((preds.float() - y) ** 2 * w_chan).mean(dim=-1)
        return (err * w_node).mean(), preds

    return loss_fn


def edm_scalings(sigma: torch.Tensor, sigma_data: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """EDM's preconditioning and loss weight (Karras et al. 2022) for noise
    levels ``sigma``: ``(c_skip, c_out, c_in, λ)`` with ``c_skip = σd² /
    (σ² + σd²)``, ``c_out = σ σd / sqrt(σ² + σd²)``, ``c_in = 1 / sqrt(σ² +
    σd²)`` and ``λ = (σ² + σd²) / (σ σd)²``."""
    s2, d2 = sigma * sigma, sigma_data * sigma_data
    root = torch.sqrt(s2 + d2)
    return d2 / (s2 + d2), sigma * sigma_data / root, 1 / root, (s2 + d2) / (s2 * d2)


def gencast_denoising_loss_fn(model, n_lat: int, n_lon: int,
                              channel_weights: np.ndarray, p_mean: float = -1.2,
                              p_std: float = 1.2, sigma_data: float = 1.0) -> Callable:
    """GenCast's denoising task (EDM): ``loss_fn((cond, y, seed), graphs)
    -> (loss, denoised)`` with the conditioning ``cond`` ``(B, n_lat ·
    n_lon, C_cond)`` (the two input states, forcings and static fields) and
    the target ``y`` ``(B, n_lat · n_lon, C)``.

    The draw, on y's device from a ``torch.Generator`` seeded with
    ``seed``: ``σ = exp(p_mean + p_std · randn(B))``, then the noise
    ``randn(y.shape)``, i.i.d. per grid node. The model ``F`` sees ``[c_in
    (y + σ n), cond]`` and ``σ``; the denoised ``D = c_skip (y + σ n) +
    c_out F`` (:func:`edm_scalings`) is scored by ``λ(σ)`` times the squared
    error weighted by :func:`latitude_weights` of the node's row and by
    ``channel_weights``, averaged over samples, nodes and channels. The draw
    and the preconditioning are the span ``gwen.gencast.noise``."""
    host = (np.repeat(latitude_weights(n_lat), n_lon), np.asarray(channel_weights))
    on: dict = {}

    def loss_fn(batch, graphs):
        cond, y, seed = batch
        with annotate("gwen.gencast.noise"):
            gen = torch.Generator(device=y.device).manual_seed(int(seed))
            b = y.shape[0]
            sigma = torch.exp(p_mean + p_std * torch.randn(b, generator=gen, device=y.device))
            noisy = y + sigma[:, None, None] * torch.randn(y.shape, generator=gen,
                                                           device=y.device)
            c_skip, c_out, c_in, lam = (v[:, None, None] for v in edm_scalings(sigma, sigma_data))
            x = torch.cat([c_in * noisy, cond.to(noisy.dtype)], dim=-1)
        out = model(graphs, x, sigma)
        if y.device not in on:
            on[y.device] = tuple(torch.as_tensor(w, dtype=torch.float32, device=y.device)
                                 for w in host)
        w_node, w_chan = on[y.device]
        denoised = c_skip * noisy + c_out * out.float()
        err = ((denoised - y) ** 2 * w_chan).mean(dim=-1)
        return (lam[:, :, 0] * err * w_node).mean(), denoised

    return loss_fn


def ensemble_crps_loss_fn(model, num_members: int = 4, sigma: float = 0.05,
                          smoothing_steps: int = 2,
                          spread_weight: float = 0.0) -> Callable:
    """Probabilistic mesh training: minimise the fair ensemble CRPS of K
    perturbed forecasts.

    ``loss_fn((x, y, seed_or_noise), graph)``: for each sample, K
    graph-correlated perturbations of the input state are forecast one step
    and scored against the target. The third batch entry is either a seed
    (an int: the white noise is drawn from a ``torch.Generator`` on x's
    device seeded with it) or the ``(B, K, N, C)`` white noise itself. The
    ``B · K`` members ride the model's batch axis; the reported predictions
    are the ensemble mean."""

    def loss_fn(batch, graph):
        x, y, third = batch
        b = x.shape[0]
        if isinstance(third, torch.Tensor) and third.dim() == x.dim() + 1:
            generator, noise = None, third
        else:
            generator = torch.Generator(device=x.device).manual_seed(int(third))
            noise = None
        xs = ensemble.sample_perturbed_members(
            generator, x, num_members, sigma, graph, smoothing_steps,
            batch_dims=1, noise=noise)  # (B, K, N, C)
        preds = model(graph, xs.reshape(b * num_members, *x.shape[1:]))
        preds = preds.reshape(b, num_members, *y.shape[1:])
        value = losses.crps_ensemble(preds, y, ensemble_axis=1, fair=True)
        if spread_weight:
            spread = torch.sqrt(
                torch.mean(preds.var(dim=1, unbiased=False)) + 1e-12)
            value = value - spread_weight * spread
        return value, preds.mean(dim=1)

    return loss_fn


def rollout_loss_fn(model, horizon: int, loss: str = "mse") -> Callable:
    """Multi-step (rollout-horizon) training: autoregress ``horizon`` steps
    and penalise the whole trajectory. ``loss_fn((x0, traj), graph)`` with
    ``traj`` ``(B, horizon, N, C)``; autograd runs through all the steps
    (the model's remat policy applies to each)."""
    fn = losses.mse_loss if loss == "mse" else losses.l1_loss

    def loss_fn(batch, graph):
        x0, traj = batch
        preds = ensemble.rollout(lambda x: model(graph, x), x0,
                                 horizon).movedim(0, 1)  # (B, H, N, C)
        return fn(preds, traj), preds

    return loss_fn


def _mean_loss(loss: str) -> Callable:
    if loss not in ("mse", "l1"):
        raise ValueError(f"unknown mesh loss {loss!r}")
    return losses.mse_loss if loss == "mse" else losses.l1_loss


def partitioned_mesh_loss_fn(apply_fn, loss: str = "mse") -> Callable:
    """Next-step prediction through the partitioned apply:
    ``loss_fn((x, y)) -> (local_mean / world, local preds)`` with ``x`` and
    ``y`` ``(B, padded nodes, channels)``."""
    fn = _mean_loss(loss)

    def loss_fn(batch):
        x, y = apply_fn.shard(batch)
        preds = apply_fn(x)
        return fn(preds, y) / apply_fn.mesh.world, preds

    return loss_fn


def partitioned_rollout_loss_fn(apply_fn, horizon: int,
                                loss: str = "mse") -> Callable:
    """Rollout-horizon training through the partitioned apply:
    ``loss_fn((x0, traj))`` with ``x0`` ``(B, padded nodes, C)`` and ``traj``
    ``(B, horizon, padded nodes, C)``."""
    fn = _mean_loss(loss)

    def loss_fn(batch):
        x0, traj = apply_fn.shard(batch)
        preds = ensemble.rollout(apply_fn, x0, horizon).movedim(0, 1)
        return fn(preds, traj) / apply_fn.mesh.world, preds

    return loss_fn


def partitioned_ensemble_crps_loss_fn(apply_fn, num_members: int = 4,
                                      sigma: float = 0.05,
                                      smoothing_steps: int = 2) -> Callable:
    """Fair-ensemble-CRPS training through the partitioned apply.

    ``loss_fn((x, y, seed_or_noise), noise_graph)``: the white noise is
    drawn on the padded *global* node space from one seed, the same on every
    rank, smoothed on ``noise_graph`` (a COO graph over the padded node
    space, replicated), and only then cut to the rank's nodes and samples.
    The K members of a sample stay on one rank, so the batch (not batch ×
    members) divides over the data axis."""

    def loss_fn(batch, noise_graph):
        x, y, third = batch
        if isinstance(third, torch.Tensor) and third.dim() == x.dim() + 1:
            generator, noise = None, third
        else:
            generator = torch.Generator(device=x.device).manual_seed(int(third))
            noise = None
        xs = ensemble.sample_perturbed_members(
            generator, x, num_members, sigma, noise_graph, smoothing_steps,
            batch_dims=1, noise=noise)  # (B, K, N_pad, C), on every rank
        xs, y = apply_fn.shard((xs, y))
        b = xs.shape[0]
        preds = apply_fn(xs.reshape(b * num_members, *xs.shape[2:]))
        preds = preds.reshape(b, num_members, *y.shape[1:])
        value = losses.crps_ensemble(preds, y, ensemble_axis=1, fair=True)
        return value / apply_fn.mesh.world, preds.mean(dim=1)

    return loss_fn
