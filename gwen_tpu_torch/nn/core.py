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


def _product(x2: Tensor, w: Tensor, b: Tensor, relu: bool) -> Tensor:
    """``x2 @ w + b``, then the ReLU if ``relu``, for a 2-D ``x2`` and ``w``,
    ``b`` in its dtype; the route follows the shape alone (see
    :func:`linear`)."""
    m, k = x2.shape
    n = w.shape[1]
    if n == 1 or m < 2:
        linear.routes["plain"] += 1
        y = x2 @ w + b
        return y.relu_() if relu else y
    if k == 1:
        linear.routes["outer"] += 1
        x2 = torch.cat([x2, x2.new_zeros(m, 7)], 1)
        w = torch.cat([w, w.new_zeros(7, n)])
    else:
        linear.routes["epilogue"] += 1
    return (torch._addmm_activation if relu else torch.addmm)(b, x2, w)


class _Linear(torch.autograd.Function):
    """The product with its bias (and ReLU) forward; backward, what autograd
    computes for ``x @ w.to(x.dtype) + b.to(x.dtype)``: ``dx = dy @ wᵀ``
    and ``dw = xᵀ @ dy`` in ``x.dtype``, ``db`` the sum of ``dy`` over
    rows, both cast to the parameters' dtype. Saves ``x`` and the cast
    weight, as autograd does. With the ReLU, :class:`_ReluGrad` masks the
    cotangent first, in a node of its own."""

    @staticmethod
    def forward(ctx, x2: Tensor, w: Tensor, b: Tensor, relu: bool) -> Tensor:
        wc = w.to(x2.dtype)
        ctx.dtypes = w.dtype, b.dtype
        ctx.save_for_backward(x2, wc)
        return _product(x2, wc, b.to(x2.dtype), relu)

    @staticmethod
    def backward(ctx, dy: Tensor):
        x2, wc = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dy @ wc.t() if need_x else None
        dw = (x2.t() @ dy).to(ctx.dtypes[0]) if need_w else None
        db = dy.sum(0).to(ctx.dtypes[1]) if need_b else None
        return dx, dw, db, None


class _ReluGrad(torch.autograd.Function):
    """The identity on a ReLU's output ``y``, whose backward is the ReLU's:
    the cotangent where ``y > 0``. A node of its own, as autograd's ReLU is,
    so the engine frees the incoming cotangent before the product's
    backward allocates ``dx``."""

    @staticmethod
    def forward(ctx, y: Tensor) -> Tensor:
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy: Tensor) -> Tensor:
        (y,) = ctx.saved_tensors
        return torch.ops.aten.threshold_backward(dy, y, 0)


def linear(x: Tensor, w: Tensor, b: Tensor, relu: bool = False) -> Tensor:
    """``x @ w + b`` in ``x.dtype`` (a bf16 product returns bf16), then the
    ReLU if ``relu``: every product with a weight and a bias, with the span
    ``gwen.op.linear`` under a profiler. ``x`` is ``(..., K)``; its leading
    axes fold into the rows of one 2-D product.

    The bias, and the ReLU, are added while the product's tile is in
    registers, rounded once; the route follows the shape (counted in
    ``linear.routes``):

    - ``epilogue``: ``torch.addmm`` with the 1-D bias, and
      ``torch._addmm_activation`` with the ReLU; on the card, one GEMM with
      cuBLASLt's bias or ReLU-bias epilogue, at any row count (PyTorch
      2.11 on an H100 takes up to 16,777,216 rows at K = N = 256 in one).
    - ``outer``: K = 1, which the epilogue refuses: ``x`` and ``w`` padded
      with zeros to K = 8 (16-byte rows), then the epilogue; the zeros add
      nothing to the sum.
    - ``plain``: one output column (or one row), which the epilogue also
      refuses: the product, then the bias add, whose pass touches one
      value a row.
    """
    with annotate("gwen.op.linear"):
        y = _Linear.apply(x.reshape(-1, x.shape[-1]), w, b, relu)
        if relu:
            y = _ReluGrad.apply(y)
        return y.reshape(*x.shape[:-1], w.shape[1])


linear.routes = dict.fromkeys(("epilogue", "outer", "plain"), 0)


def linear_apply(params, x: Tensor) -> Tensor:
    """:func:`linear` with a layer's ``{"w", "b"}``."""
    return linear(x, params["w"], params["b"])


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
    """The layers in turn, ``activation`` between them; a ReLU runs in its
    product's epilogue (:func:`linear`)."""
    n = len(params)
    fused = activation is torch.relu
    for i in range(n):
        p = params[f"layer_{i}"]
        x = linear(x, p["w"], p["b"], relu=fused and i < n - 1)
        if i < n - 1 and not fused:
            x = activation(x)
    return x


def count_params(params: "nn.Module | dict[str, Tensor]") -> int:
    """The number of elements over a module's parameters or a state dict's
    tensors."""
    tensors = (params.parameters() if isinstance(params, nn.Module)
               else params.values())
    return sum(t.numel() for t in tensors)
