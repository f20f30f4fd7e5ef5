"""Reference (JAX) parameters → the port's state dict.

The port keeps the reference's parameter layout (a linear ``w`` is
``(d_in, d_out)``), so conversion joins the param-tree path with dots and
copies each leaf: both packages then compute with the same weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """Flatten a nested param dict whose leaves are numpy arrays (or
    tensors) into ``{"encoder.layer_0.w": tensor, ...}``, copying each
    leaf."""
    out: dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, prefix=name + "."))
        elif isinstance(val, torch.Tensor):
            out[name] = val.detach().clone()
        else:
            out[name] = torch.from_numpy(np.array(val, copy=True))
    return out


def params_to_tree(state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """Inverse of :func:`params_from_jax`: nest dotted names back into the
    reference's param tree (leaves stay tensors)."""
    tree: dict[str, Any] = {}
    for name, val in state.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree
