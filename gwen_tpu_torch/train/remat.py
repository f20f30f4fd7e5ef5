"""Remat policy selection from a device memory budget (a copy of
``gwen_tpu.train.remat``: the helpers are arithmetic).

``EncodeProcessDecode.remat`` supports a ladder (fastest → leanest):
``False`` (save everything) → ``"save_agg"`` (save only aggregation
outputs) → ``"save_agg:K"`` (aggs for K of the steps) → ``True`` (full
per-step recompute). This module picks the largest K whose saved
aggregation outputs fit a byte budget, replacing an all-or-nothing choice.
"""

from __future__ import annotations


def agg_bytes_per_step(num_nodes: int, latent: int,
                       dtype_bytes: int = 2) -> int:
    """Bytes one checkpointed aggregation output keeps live: a single
    (N_pad, latent) tensor per process step (GCN processor)."""
    return int(num_nodes) * int(latent) * int(dtype_bytes)


def select_save_agg_steps(
    num_nodes: int,
    latent: int,
    process_steps: int,
    *,
    budget_bytes: int,
    reserved_bytes: int,
    dtype_bytes: int = 2,
) -> int:
    """Largest K with ``reserved + K * agg_bytes <= budget`` (clamped to
    [0, process_steps]). ``reserved_bytes`` is everything else that must
    stay live at the backward's peak (params, optimizer state, the
    recompute working set — measure once per scale, e.g. from
    ``torch.cuda.max_memory_allocated()`` after a full-remat step)."""
    per = agg_bytes_per_step(num_nodes, latent, dtype_bytes)
    if per <= 0:
        return process_steps
    avail = int(budget_bytes) - int(reserved_bytes)
    k = avail // per if avail > 0 else 0
    return max(0, min(int(process_steps), int(k)))


def remat_policy_for_budget(
    num_nodes: int,
    latent: int,
    process_steps: int,
    *,
    budget_bytes: int,
    reserved_bytes: int,
    dtype_bytes: int = 2,
) -> "bool | str":
    """Map the K selection onto the ``EncodeProcessDecode.remat`` ladder:
    K == steps → ``"save_agg"``; 0 < K < steps → ``"save_agg:K"``;
    K == 0 → ``True`` (full remat)."""
    k = select_save_agg_steps(
        num_nodes, latent, process_steps,
        budget_bytes=budget_bytes, reserved_bytes=reserved_bytes,
        dtype_bytes=dtype_bytes,
    )
    if k >= process_steps:
        return "save_agg"
    if k > 0:
        return f"save_agg:{k}"
    return True
