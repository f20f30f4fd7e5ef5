"""Parameter containers and the dense building blocks.

Counterpart of ``gwen_tpu.nn.core``. Parameters keep the reference's
layout and names — a linear layer is ``{"w": (d_in, d_out), "b": (d_out,)}``
and an MLP is ``{"layer_0": linear, "layer_1": linear, ...}`` — held in
``nn.ParameterDict``/``nn.ModuleDict`` so a model's ``state_dict`` keys are
the reference's param-tree paths joined with dots, and converting weights
is a plain copy (:mod:`gwen_tpu_torch.nn.convert`).
"""

from __future__ import annotations

import torch
from torch import nn

from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor


def glorot_uniform(shape: tuple[int, int], generator: torch.Generator,
                   device) -> Tensor:
    """Glorot-uniform float32 tensor drawn on the CPU from ``generator``
    (so a seed gives the same weights on every device), then moved."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(device)


def linear_init(d_in: int, d_out: int, generator: torch.Generator,
                device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w": nn.Parameter(glorot_uniform((d_in, d_out), generator, device)),
        "b": nn.Parameter(torch.zeros(d_out, device=device)),
    })


def linear_apply(params, x: Tensor) -> Tensor:
    """``x @ w + b`` in ``x.dtype`` (a bf16 product returns bf16); the span
    ``gwen.op.linear`` under a profiler."""
    with annotate("gwen.op.linear"):
        return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


def layer_norm_init(dim: int, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": nn.Parameter(torch.ones(dim, device=device)),
        "bias": nn.Parameter(torch.zeros(dim, device=device)),
    })


def layer_norm_apply(params, x: Tensor, eps: float = 1e-6) -> Tensor:
    """LayerNorm over the last axis with float32 statistics (population
    variance) whatever the compute dtype; cast back to ``x.dtype``."""
    h = x.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, unbiased=False)
    h = (h - mean) * torch.rsqrt(var + eps)
    h = h * params["scale"] + params["bias"]
    return h.to(x.dtype)


def mlp_init(dims: list[int], generator: torch.Generator,
             device) -> nn.ModuleDict:
    return nn.ModuleDict({
        f"layer_{i}": linear_init(dims[i], dims[i + 1], generator, device)
        for i in range(len(dims) - 1)
    })


def mlp_apply(params, x: Tensor, activation=torch.relu) -> Tensor:
    n = len(params)
    for i in range(n):
        x = linear_apply(params[f"layer_{i}"], x)
        if i < n - 1:
            x = activation(x)
    return x


def count_params(params: "nn.Module | dict[str, Tensor]") -> int:
    """The number of elements over a module's parameters or a state dict's
    tensors."""
    tensors = (params.parameters() if isinstance(params, nn.Module)
               else params.values())
    return sum(t.numel() for t in tensors)
