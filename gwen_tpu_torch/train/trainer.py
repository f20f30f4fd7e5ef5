"""Training runtime for one device: counterpart of
``gwen_tpu.train.trainer``.

* :class:`TrainState` — the model (its parameters), the optimizer and the
  step count.
* :class:`Trainer` — one train step (forward, backward, optimizer update),
  the epoch loop with per-epoch best, registry metrics every ``log_every``
  steps, checkpoints every ``checkpoint_every`` steps and at each new best,
  ``resume`` from the latest checkpoint, and :meth:`Trainer.evaluate`.
  Host batches are made on a background thread (in pinned memory for a
  CUDA device) and copied to the device ``prefetch_size`` batches ahead of
  the step that uses them. With a :class:`~gwen_tpu_torch.train.mesh.
  ProcessMesh` of several ranks (the partitioned tasks of
  :mod:`gwen_tpu_torch.train.tasks`) a step also sums the parameter
  gradients and the reported loss over all ranks; every rank then takes the
  same optimizer step.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from gwen_tpu_torch.data.pipeline import prefetch as host_prefetch
from gwen_tpu_torch.logging_utils import get_logger
from gwen_tpu_torch.profiling import annotate
from gwen_tpu_torch.registry import Run
from gwen_tpu_torch.train.checkpoint import Checkpointer
from gwen_tpu_torch.train.optim import Optimizer

log = get_logger()


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


LossFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]
# loss_fn(batch[, context]) -> (loss, predictions)


def to_device(batch: Any, device) -> Any:
    """A batch (numpy arrays or tensors, alone or in a tuple, list or
    dict) on ``device``; plain numbers (a seed) pass through."""
    if isinstance(batch, (int, float)):
        return batch
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return type(batch)(to_device(b, device) for b in batch)


def prefetch(batches: Iterable, device, size: int = 2) -> Iterator:
    """Yield ``batches`` on ``device``, keeping ``size`` of them copied
    ahead (the copies are queued on the stream before the step that waits
    for the current batch)."""
    queue: collections.deque = collections.deque()
    for batch in batches:
        queue.append(to_device(batch, device))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


class Trainer:
    """Generic trainer over ``loss_fn(batch[, context]) -> (loss, preds)``,
    where ``loss_fn`` closes over the model that ``TrainState.model``
    holds. ``context`` (typically the graph) is placed on ``device`` once
    and passed to every call."""

    def __init__(self, loss_fn: LossFn, device, run: Optional[Run] = None,
                 checkpointer: Optional[Checkpointer] = None,
                 log_every: int = 10, context: Any = None, mesh=None):
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.device = torch.device(device)
        self.run = run
        self.checkpointer = checkpointer
        self.log_every = log_every
        self.context = None if context is None else context.to(self.device)

    def _call_loss(self, batch):
        if self.context is None:
            return self.loss_fn(batch)
        return self.loss_fn(batch, self.context)

    def train_step(self, state: TrainState, batch) -> torch.Tensor:
        """One update from a device batch; returns the loss (on device).
        Under a profiler the step is the span ``gwen.train_step`` over
        ``gwen.forward``, ``gwen.backward``, ``gwen.allreduce`` (with a
        mesh) and ``gwen.optimizer``."""
        with annotate("gwen.train_step"):
            state.model.train()
            with annotate("gwen.forward"):
                loss, _ = self._call_loss(batch)
            with annotate("gwen.backward"):
                loss.backward()
            loss = loss.detach()
            if self.mesh is not None:
                with annotate("gwen.allreduce"):
                    self.mesh.all_reduce_gradients(state.model.parameters())
                    loss = self.mesh.all_reduce_sum(loss)
            with annotate("gwen.optimizer"):
                state.optimizer.step(state.model.parameters())
            state.step += 1
        return loss

    def fit(self, state: TrainState, batches_per_epoch: Callable[[int], Iterable],
            epochs: int, checkpoint_every: int = 0, prefetch_size: int = 2,
            resume: bool = False) -> tuple[TrainState, float]:
        """Run ``epochs`` passes; returns ``(state, best_epoch_loss)``.
        With ``resume=True`` and a checkpoint on disk, training restarts
        from the latest one (parameters, optimizer, step)."""
        if resume and self.mesh is not None and self.mesh.world > 1:
            # Rank 0 alone holds the checkpointer; restoring there only
            # would let the replicas drift apart.
            raise ValueError("resume is not supported on a multi-rank mesh")
        if resume and self.checkpointer and self.checkpointer.latest_step() is not None:
            self.checkpointer.restore(state)
            log.info("resumed from checkpoint at step %d", state.step)
        best_loss = float("inf")
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses = []
            # Host batches are made (read, stacked, pinned) on a thread
            # ahead of the step, then copied to the device ahead of it.
            host = host_prefetch(batches_per_epoch(epoch), prefetch_size,
                                 pin_memory=self.device.type == "cuda")
            for batch in prefetch(host, self.device, prefetch_size):
                losses.append(self.train_step(state, batch))
                step = state.step
                if (checkpoint_every and self.checkpointer
                        and step % checkpoint_every == 0):
                    self.checkpointer.save(step, state)
                if self.log_every and step % self.log_every == 0 and self.run:
                    self.run.log_metric("train_loss", float(losses[-1]), step)
            epoch_loss = (float(torch.stack(losses).float().mean())
                          if losses else float("nan"))
            log.info("epoch %d: loss=%.6f (%.2fs, %d steps)", epoch,
                     epoch_loss, time.perf_counter() - t0, len(losses))
            if self.run is not None:
                self.run.log_metric("loss", epoch_loss, epoch)
            if epoch_loss < best_loss:
                best_loss = epoch_loss
                if self.checkpointer:
                    self.checkpointer.save(state.step, state)
        return state, best_loss

    @torch.no_grad()
    def evaluate(self, model: torch.nn.Module, batches: Iterable,
                 collect_preds: bool = True
                 ) -> tuple[float, Optional[np.ndarray]]:
        """Mean loss over ``batches`` and (optionally) the concatenated
        predictions on the host."""
        model.eval()
        losses, preds = [], []
        for batch in prefetch(batches, self.device):
            loss, pred = self._call_loss(batch)
            if self.mesh is not None:
                loss = self.mesh.all_reduce_sum(loss)
            losses.append(float(loss))
            if collect_preds:
                preds.append(pred.float().cpu().numpy())
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        out = np.concatenate(preds, axis=0) if (collect_preds and preds) else None
        return mean_loss, out
