"""Faults planted under the timed path, for the check to catch: each is a
context manager that patches the program in this process only.

* ``unchanged``: a step returns its state unchanged (the optimizer takes
  no step; a rollout returns its input at every lead step);
* ``half_batch``: half of the batch is left out and the rest stands for
  it (the loss over the first half; members past the first half are the
  mean of the first half's outputs);
* ``altered``: an answer is altered where it is produced (a train step's
  largest gradient doubled before the optimizer takes it; in generation,
  the model's output for the first member negated).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patch(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged():
    from gwen_tpu_torch import ensemble
    from gwen_tpu_torch.train.optim import Optimizer

    def no_step(self, params):
        self.optim.zero_grad(set_to_none=True)

    def still(step_fn, state, num_steps):
        return torch.stack([state] * num_steps)

    with _patch(Optimizer, "step", no_step), _patch(ensemble, "rollout", still):
        yield


@contextlib.contextmanager
def half_batch():
    import gwen_tpu_torch.train as train
    from gwen_tpu_torch.nn import EncodeProcessDecode

    make = train.mesh_graph_loss_fn
    forward = EncodeProcessDecode.forward

    def half_loss(model, loss="mse"):
        inner = make(model, loss)

        def loss_fn(batch, graph):
            x, y = batch
            return inner((x[: len(x) // 2], y[: len(y) // 2]), graph)
        return loss_fn

    def half_forward(self, graph, x):
        if x.dim() < 3 or x.shape[0] < 2 or torch.is_grad_enabled():
            return forward(self, graph, x)
        out = forward(self, graph, x[: x.shape[0] // 2])
        rest = out.mean(0, keepdim=True).expand(x.shape[0] - out.shape[0], *out.shape[1:])
        return torch.cat([out, rest])

    with _patch(train, "mesh_graph_loss_fn", half_loss), \
            _patch(EncodeProcessDecode, "forward", half_forward):
        yield


@contextlib.contextmanager
def altered():
    from gwen_tpu_torch.nn import EncodeProcessDecode
    from gwen_tpu_torch.train.optim import Optimizer

    forward, step = EncodeProcessDecode.forward, Optimizer.step

    def flipped(self, graph, x):
        out = forward(self, graph, x)
        if torch.is_grad_enabled():
            return out
        sign = torch.ones(out.shape[0], *([1] * (out.dim() - 1)), dtype=out.dtype,
                          device=out.device)
        sign[0] = -1
        return out * sign

    def doubled(self, params):
        params = list(params)
        top = max((p for p in params if p.grad is not None),
                  key=lambda p: float(p.grad.norm()))
        top.grad.mul_(2)
        step(self, params)

    with _patch(EncodeProcessDecode, "forward", flipped), \
            _patch(Optimizer, "step", doubled):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
