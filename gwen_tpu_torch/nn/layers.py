"""Graph layers: counterpart of ``gwen_tpu.nn.layers``.

``gcn_apply`` is ``Â · X · W + b`` with the aggregation dispatched through
:func:`gwen_tpu_torch.ops.aggregate.aggregate`. It transforms first when
the fan-out does not grow (``d_out ≤ d_in``) and aggregates first
otherwise: the same result, with the aggregation on the narrower side.
"""

from __future__ import annotations

import torch

from gwen_tpu_torch.nn import core
from gwen_tpu_torch.ops.aggregate import aggregate

Tensor = torch.Tensor


def gcn_init(d_in: int, d_out: int, generator: torch.Generator, device):
    return core.linear_init(d_in, d_out, generator, device)


def gcn_apply(params, graph, x: Tensor, backend: str = "auto") -> Tensor:
    d_in, d_out = params["w"].shape
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype)
    if d_out <= d_in:
        h = aggregate(graph, x @ w, backend=backend)
    else:
        h = aggregate(graph, x, backend=backend) @ w
    return h + b
