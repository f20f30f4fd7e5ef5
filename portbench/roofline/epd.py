"""Operations and bytes of the encode-process-decode mesh model, from its
shapes.

Counted as the port's kernel table counts them: each input read once,
each output written once, a fixed sparse operator as its nonzeros at 6
bytes each (a bf16 value and an int32 index), an attention neighbour list
as 4 bytes an entry, useful operations only (a multiply-add is two; work
recomputed in the backward is not counted). The mesh is the icosphere of
the configuration's level: ``N = 10·4^L + 2`` nodes and ``E = 60·4^L + N``
directed edges, self loops included. Attention is counted over every edge,
a bound on its in-window share (the escape edges are ~2 % at L7 and the
lists are a small part of its bytes).
"""

from __future__ import annotations

from portbench.roofline import Op

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}
S_NNZ_BYTES = 6
LIST_BYTES = 4


def mesh_size(level: int) -> tuple[int, int]:
    """``(nodes, directed edges with self loops)`` of the icosphere."""
    n = 10 * 4 ** level + 2
    return n, 60 * 4 ** level + n


def _matmul(rows: int, k: int, m: int) -> Op:
    return Op("matmul", 2.0 * rows * k * m, 0.0)


def forward_ops(model_cfg: dict, level: int, batch: int) -> list[Op]:
    """The operator calls of one forward pass over ``batch`` samples or
    members."""
    n, e = mesh_size(level)
    c, lat = model_cfg["channels"], model_cfg["latent_size"]
    elt = ELT[model_cfg["compute_dtype"]]
    rows = n * batch
    field = rows * lat * elt
    ops = [_matmul(rows, c, lat)] + [_matmul(rows, lat, lat)] * (model_cfg["mlp_layers"] - 1)
    for _ in range(model_cfg["process_steps"]):
        if model_cfg["processor"] == "attention":
            ops += [_matmul(rows, lat, lat)] * 4
            ops.append(Op("attn_fwd", 4.0 * e * batch * lat,
                          4 * field + e * LIST_BYTES))
        else:
            ops.append(_matmul(rows, lat, lat))
            ops.append(Op("agg", 2.0 * e * batch * lat, 2 * field + e * S_NNZ_BYTES))
        ops.append(Op("ln_fwd", 0.0, 3 * field))
    ops += [_matmul(rows, lat, lat)] * (model_cfg["mlp_layers"] - 1) + [_matmul(rows, lat, c)]
    return ops


def _backward(op: Op, model_cfg: dict, level: int, batch: int) -> list[Op]:
    n, e = mesh_size(level)
    lat = model_cfg["latent_size"]
    field = n * batch * lat * ELT[model_cfg["compute_dtype"]]
    if op.family == "matmul":  # the input's gradient and the weight's
        return [Op("matmul", 2 * op.flops, 0.0)]
    if op.family == "agg":  # the symmetric operator on the cotangent
        return [op]
    if op.family == "attn_fwd":  # q, k, v and g in, dq, dk and dv out,
        # the neighbour list and its transpose
        return [Op("attn_bwd", 2 * op.flops, 7 * field + 2 * e * LIST_BYTES)]
    return [Op("ln_bwd", 0.0, op.bytes)]


def train_ops(model_cfg: dict, level: int, batch: int) -> list[Op]:
    """The operator calls of one training step (forward and backward) over
    ``batch`` samples."""
    fwd = forward_ops(model_cfg, level, batch)
    return fwd + [b for op in fwd for b in _backward(op, model_cfg, level, batch)]


def smoothing_ops(model_cfg: dict, level: int, members: int, steps: int
                  ) -> list[Op]:
    """The noise smoothing of one ensemble request: ``steps`` aggregations
    of a float32 ``(members, N, C)`` field."""
    n, e = mesh_size(level)
    c = model_cfg["channels"]
    return [Op("agg", 2.0 * e * members * c, 2 * n * members * c * 4 + e * S_NNZ_BYTES)] * steps


def request_ops(model_cfg: dict, level: int, members: int, lead_steps: int,
                smoothing: int) -> list[Op]:
    """One ensemble request: the smoothing, then ``lead_steps`` forward
    passes over the members."""
    return (smoothing_ops(model_cfg, level, members, smoothing)
            + forward_ops(model_cfg, level, members) * lead_steps)


def useful_flops(ops: list[Op]) -> float:
    """The operations that count towards a share of the card's peak: the
    matrix products, the aggregations and attention."""
    return sum(op.flops for op in ops if not op.family.startswith("ln_"))
