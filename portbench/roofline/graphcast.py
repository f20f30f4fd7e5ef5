"""Operations and bytes of GraphCast, from its shapes and its graphs' node
and edge counts (``sizes``: ``grid``, ``mesh``, ``g2m``, ``mesh_edges``,
``m2g``).

Counted as the port's kernel table counts: each input read once, each
output written once, an index as 4 bytes an edge, useful operations only
(a multiply-add is two; work recomputed in the backward is not counted).

* ``matmul``: every product with a weight, forward and (twice its
  operations) backward.
* ``gather`` (:func:`gwen_tpu_torch.ops.edges.gather_join`): forward, the
  edge latent and the sender and receiver node sets read, the joined
  ``E × 3L`` written, two indices; backward, the cotangent's sender and
  receiver parts read (the edge part passes through as a view), the two
  node sets' gradients written, two indices, one add an element.
* ``edge_sum``: forward, ``E × L`` read, ``receivers × L`` written, one
  index, one add an element; backward the other way round (a gather).

A block recomputed in the backward (the configuration's ``remat``) adds
its gathers and edge sums again, with their bytes and no operations: they
count towards the two operators' rooflines, not towards ``mfu``.
"""

from __future__ import annotations

from portbench.roofline import Op

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}
INDEX_BYTES = 4
# The published 0.25° model's counts (Lam et al. 2023, supplement).
PUBLISHED = {"grid": 721 * 1440, "mesh": 40_962, "g2m": 1_618_746,
             "mesh_edges": 327_660, "m2g": 3_114_720}
BLOCKS = ("g2m", "mesh", "m2g")


def remat_blocks(remat) -> set[str]:
    """The blocks a configuration's ``remat`` recomputes (as the program's
    ``parse_block_remat`` reads it)."""
    if remat is True:
        return set(BLOCKS)
    if isinstance(remat, str) and remat.startswith("blocks:"):
        return set(remat[len("blocks:"):].split("+")) - {""}
    return set()


def _mm(rows: int, k: int, n: int) -> Op:
    return Op("matmul", 2.0 * rows * k * n, 0.0)


def _mlp(rows: int, d_in: int, lat: int) -> list[Op]:
    return [_mm(rows, d_in, lat), _mm(rows, lat, lat)]


def _graph(block: str, n: dict) -> tuple[int, int, int]:
    """``(senders, receivers, edges)`` of a block's graph."""
    return {"g2m": (n["grid"], n["mesh"], n["g2m"]),
            "mesh": (n["mesh"], n["mesh"], n["mesh_edges"]),
            "m2g": (n["mesh"], n["grid"], n["m2g"])}[block]


def edge_ops(block: str, n: dict, lat: int, elt: int, batch: int,
             backward: bool = False, recomputed: bool = False) -> list[Op]:
    """A block's gather and edge sum (forward, or their backward)."""
    ns, nr, e = _graph(block, n)
    f = lat * elt * batch
    if not backward:
        useful = 0.0 if recomputed else float(e * lat * batch)
        return [Op("gather", 0.0, (e + ns + nr) * f + 3 * e * f + 2 * e * INDEX_BYTES),
                Op("edge_sum", useful, e * f + nr * f + e * INDEX_BYTES)]
    return [Op("gather", 2.0 * e * lat * batch, 2 * e * f + (ns + nr) * f + 2 * e * INDEX_BYTES),
            Op("edge_sum", 0.0, nr * f + e * f + e * INDEX_BYTES)]


def forward_ops(model_cfg: dict, n: dict, batch: int) -> list[Op]:
    """The forward's products, gathers and edge sums over ``batch``
    samples."""
    lat, cin, cout = model_cfg["latent_size"], model_cfg["channels_in"], model_cfg["channels_out"]
    elt = ELT[model_cfg["compute_dtype"]]
    g, m, em = n["grid"] * batch, n["mesh"] * batch, n["mesh_edges"] * batch
    eg, ed = n["g2m"] * batch, n["m2g"] * batch
    ops = (_mlp(g, cin, lat) + _mlp(m, 3, lat) + _mlp(em, 4, lat)
           + _mlp(eg, 4, lat) + _mlp(eg, 3 * lat, lat) + edge_ops("g2m", n, lat, elt, batch)
           + _mlp(m, 2 * lat, lat) + _mlp(g, lat, lat))
    for _ in range(model_cfg["process_steps"]):
        ops += _mlp(em, 3 * lat, lat) + edge_ops("mesh", n, lat, elt, batch) + _mlp(m, 2 * lat, lat)
    ops += (_mlp(ed, 4, lat) + _mlp(ed, 3 * lat, lat) + edge_ops("m2g", n, lat, elt, batch)
            + _mlp(g, 2 * lat, lat) + [_mm(g, lat, lat), _mm(g, lat, cout)])
    return ops


def train_ops(model_cfg: dict, n: dict, batch: int) -> list[Op]:
    """One training step: the forward, the backward (products twice their
    operations, the gathers' and edge sums' backward) and the recomputed
    blocks' gathers and edge sums."""
    lat, elt = model_cfg["latent_size"], ELT[model_cfg["compute_dtype"]]
    fwd = forward_ops(model_cfg, n, batch)
    ops = fwd + [Op("matmul", 2 * op.flops, 0.0) for op in fwd if op.family == "matmul"]
    counts = {"g2m": 1, "mesh": model_cfg["process_steps"], "m2g": 1}
    redo = remat_blocks(model_cfg["remat"])
    for block, k in counts.items():
        ops += edge_ops(block, n, lat, elt, batch, backward=True) * k
        if block in redo:
            ops += edge_ops(block, n, lat, elt, batch, recomputed=True) * k
    return ops


def param_count(model_cfg: dict) -> int:
    """The model's parameters: 42 MLPs ``d → L → L`` with a LayerNorm
    (``512 d + 264,192`` each at L = 512) and the output ``L → L → C``."""
    lat, cin, cout = model_cfg["latent_size"], model_cfg["channels_in"], model_cfg["channels_out"]
    ins = [cin, 3, 4, 4, 4, 3 * lat, 2 * lat, lat] + [3 * lat, 2 * lat] * model_cfg["process_steps"]
    ins += [3 * lat, 2 * lat]
    mlp = sum(d * lat + lat + lat * lat + lat + 2 * lat for d in ins)
    return mlp + lat * lat + lat + lat * cout + cout


def span_roofline_pct(run, sp, family: str, spans: tuple[str, ...]):
    """The ``family``'s calls' least time on the card (the larger of bytes
    over the memory rate and operations over the bf16 rate, summed) over
    the device time on paths through ``spans``, in %; ``None`` where the run
    holds nothing to read."""
    if sp is None or run.peaks is None:
        return None
    ops = [op for op in run.ops if op.family == family]
    seconds = sp.under(spans)
    if not ops or seconds <= 0:
        return None
    pk = run.peaks
    bound = sum(max(op.bytes / pk["hbm_bytes_per_s"], op.flops / pk["bf16_flops_per_s"])
                for op in ops)
    return 100.0 * bound / seconds
