"""Optimizer and learning-rate schedule factory: counterpart of
``gwen_tpu.train.optim`` on ``torch.optim``.

:func:`make_schedule` returns the learning rate as a plain function of the
update count (0 for the first update), with the optax schedules' values.
:func:`make_optimizer` builds Adam — or AdamW when ``weight_decay > 0``:
decoupled decay as in optax ``adamw`` — with ``betas`` (torch's and
optax's default ``(0.9, 0.999)``), a ``LambdaLR`` over the schedule and
optional global-norm gradient clipping.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable

import torch


def make_schedule(
    lr: float,
    scheduler: str = "none",
    total_steps: int = 10_000,
    warmup_steps: int = 0,
    cycle_steps: int = 2_000,
    min_lr_factor: float = 0.1,
) -> Callable[[int], float]:
    if scheduler == "none":
        def sched(step: int) -> float:
            return lr
    elif scheduler == "cosine":
        decay = max(total_steps - warmup_steps, 1)

        def sched(step: int) -> float:
            frac = min(step, decay) / decay
            cos = 0.5 * (1.0 + math.cos(math.pi * frac))
            return lr * ((1 - min_lr_factor) * cos + min_lr_factor)
    elif scheduler == "cyclic":
        # Triangular: between min_lr_factor·lr and lr, period cycle_steps.
        def sched(step: int) -> float:
            phase = abs((step % cycle_steps) / (cycle_steps / 2.0) - 1.0)
            return lr * (min_lr_factor + (1 - min_lr_factor) * (1.0 - phase))
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    if warmup_steps <= 0:
        return sched

    def warmed(step: int) -> float:  # linear warmup, then the schedule
        if step < warmup_steps:
            return lr * step / warmup_steps
        return sched(step - warmup_steps)
    return warmed


@dataclass
class Optimizer:
    """An optimizer, its schedule and its clipping, stepped together."""

    optim: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    grad_clip: float = 0.0

    def step(self, params: Iterable[torch.Tensor]) -> None:
        """Clip, update, advance the schedule, clear the gradients."""
        if self.grad_clip > 0:
            torch.nn.utils.clip_grad_norm_(list(params), self.grad_clip)
        self.optim.step()
        self.scheduler.step()
        self.optim.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"optim": self.optim.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optim.load_state_dict(state["optim"])
        self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(
    params: Iterable[torch.Tensor],
    lr: float,
    weight_decay: float = 0.0,
    scheduler: str = "none",
    total_steps: int = 10_000,
    warmup_steps: int = 0,
    cycle_steps: int = 2_000,
    grad_clip: float = 0.0,
    betas: tuple[float, float] = (0.9, 0.999),
) -> Optimizer:
    sched = make_schedule(lr, scheduler, total_steps, warmup_steps, cycle_steps)
    params = list(params)
    if weight_decay > 0:
        optim = torch.optim.AdamW(params, lr=lr, betas=betas, weight_decay=weight_decay)
    else:
        optim = torch.optim.Adam(params, lr=lr, betas=betas)
    lam = torch.optim.lr_scheduler.LambdaLR(
        optim, lambda step: sched(step) / lr if lr else 0.0)
    return Optimizer(optim, lam, grad_clip)
