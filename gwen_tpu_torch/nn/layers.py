"""Graph layers: counterpart of ``gwen_tpu.nn.layers``.

``gcn_apply`` is ``Â · X · W + b`` with the aggregation dispatched through
:func:`gwen_tpu_torch.ops.aggregate.aggregate`. It transforms first when
the fan-out does not grow (``d_out ≤ d_in``) and aggregates first
otherwise: the same result, with the aggregation on the narrower side.
:func:`gcn_pre` and :func:`gcn_post` are the dense parts on either side of
the aggregation, so a remat policy can keep the aggregation output and
recompute only them (the reference tags that output ``AGG_CKPT_NAME``).
Each product with the weight, and the bias add, is the span
``gwen.op.linear`` under a profiler; a product with its bias is
:func:`core.linear`.
"""

from __future__ import annotations

import torch

from gwen_tpu_torch.nn import core
from gwen_tpu_torch.ops.aggregate import aggregate
from gwen_tpu_torch.profiling import annotate

Tensor = torch.Tensor


def gcn_init(d_in: int, d_out: int, generator: torch.Generator, device):
    return core.linear_init(d_in, d_out, generator, device)


def _transform_first(params) -> bool:
    d_in, d_out = params["w"].shape
    return d_out <= d_in


def gcn_pre(params, x: Tensor) -> Tensor:
    """The dense part before the aggregation (``x @ w`` when transforming
    first, else ``x``). The product is in ``x.dtype``: the weights are
    cast, not the product."""
    if not _transform_first(params):
        return x
    with annotate("gwen.op.linear"):
        return x @ params["w"].to(x.dtype)


def gcn_post(params, a: Tensor) -> Tensor:
    """The dense part after the aggregation output ``a``: ``a @ w + b``
    (:func:`core.linear`, the bias in the product's epilogue) when
    aggregating first, else ``a + b``."""
    if not _transform_first(params):
        return core.linear_apply(params, a)
    with annotate("gwen.op.linear"):
        return a + params["b"].to(a.dtype)


def gcn_apply(params, graph, x: Tensor, backend: str = "auto") -> Tensor:
    return gcn_post(params, aggregate(graph, gcn_pre(params, x),
                                      backend=backend))
