"""Graph layers: counterpart of ``gwen_tpu.nn.layers``.

``gcn_apply`` is ``Â · X · W + b`` with the aggregation dispatched through
:func:`gwen_tpu_torch.ops.aggregate.aggregate`. It transforms first when
the fan-out does not grow (``d_out ≤ d_in``) and aggregates first
otherwise: the same result, with the aggregation on the narrower side.
:func:`gcn_pre` and :func:`gcn_post` are the dense parts on either side of
the aggregation, so a remat policy can keep the aggregation output and
recompute only them (the reference tags that output ``AGG_CKPT_NAME``).
"""

from __future__ import annotations

import torch

from gwen_tpu_torch.nn import core
from gwen_tpu_torch.ops.aggregate import aggregate

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
    return x @ params["w"].to(x.dtype) if _transform_first(params) else x


def gcn_post(params, a: Tensor) -> Tensor:
    """The dense part after the aggregation output ``a``."""
    if not _transform_first(params):
        a = a @ params["w"].to(a.dtype)
    return a + params["b"].to(a.dtype)


def gcn_apply(params, graph, x: Tensor, backend: str = "auto") -> Tensor:
    return gcn_post(params, aggregate(graph, gcn_pre(params, x),
                                      backend=backend))
