"""Operations and bytes of GenCast's denoiser training step, from its
shapes and its graphs' counts (``sizes``: ``grid``, ``mesh``, ``g2m``,
``m2g``, ``mesh_edges``, ``pairs``, the k-hop lists' total length).

Counted as ``roofline/graphcast.py`` counts (each input read once, each
output written once, an index as 4 bytes, useful operations only, a block
recomputed in the backward adding its gathers, edge sums and attention
again with their bytes and no operations):

* ``matmul``: every product with a weight, forward and (twice its
  operations) backward: the grid MLPs as GraphCast's, each transformer
  layer's q, k, v and output projections and its FFN, the noise
  embedding and the norms' scales and offsets;
* ``gather`` and ``edge_sum``: grid2mesh's and mesh2grid's
  (:func:`portbench.roofline.graphcast.edge_ops`);
* ``attn_fwd``: a layer's attention over the k-hop lists, ``4 · pairs ·
  L`` operations a sample (``q·k`` and ``p·v`` over every head's
  ``dh``), q, k, v read and the output written once, the lists at 4 bytes
  an entry; ``attn_bwd`` (B6 and B7) twice the operations, q, k, v and
  the output's cotangent read, dq, dk and dv written, the lists and their
  transpose read;
* ``ln_fwd`` and ``ln_bwd``: each conditional norm (:data:`NORMS`; kernels
  B2 and B2b), no useful operations; forward ``m`` read, the residual read
  where the norm adds one, the output written, the float32 scale and
  offset read; backward ``m`` and the cotangent read, ``dm`` written, the
  scale read (the residual's gradient is the cotangent itself). A norm of
  a recomputed block runs its forward again.

The pairs attended a step, :func:`attn_pairs`, are what the program's
counter ``nn.gencast.attn_pairs`` counts.
"""

from __future__ import annotations

from portbench.roofline import Op
from portbench.roofline.graphcast import ELT, INDEX_BYTES, _mlp, _mm, edge_ops, remat_blocks

COND_SIZE, NOISE_IN, NOISE_HIDDEN = 16, 64, 32
# GraphCast's grid graphs at 0.25° with the program's icosahedron on M6,
# and the program's 16-hop lists there (40,962 lists of 681 to 817 nodes).
PROGRAM = {"grid": 721 * 1440, "mesh": 40_962, "g2m": 1_629_780, "m2g": 3_114_720,
           "mesh_edges": 245_760, "pairs": 33_280_722}


# The conditional norms outside the transformer: each one's rows (a key of
# ``sizes``), whether it adds a residual, and the block it runs in
# (None: outside the grid blocks, never recomputed).
NORMS = (("grid", False, None), ("mesh", False, None),  # grid_embed, mesh_embed
         ("g2m", False, "g2m"), ("g2m", False, "g2m"),  # g2m_edge_embed, grid2mesh.edge
         ("mesh", True, "g2m"), ("grid", True, "g2m"),  # grid2mesh.mesh_node, .grid_node
         ("m2g", False, "m2g"), ("m2g", False, "m2g"),  # m2g_edge_embed, mesh2grid.edge
         ("grid", True, "m2g"))  # mesh2grid.grid_node


def norms(model_cfg: dict) -> int:
    """The conditional norms: 9 grid MLPs' and 2 a transformer layer."""
    return len(NORMS) + 2 * model_cfg["process_steps"]


def norm_list(model_cfg: dict) -> list[tuple[str, bool, str]]:
    """Every conditional norm as :data:`NORMS` gives it, each transformer
    layer's two (``attn_norm``, ``ffn_norm``: the mesh's rows, no
    residual) included."""
    return list(NORMS) + [("mesh", False, "mesh")] * (2 * model_cfg["process_steps"])


def ln_ops(model_cfg: dict, n: dict, batch: int, backward: bool = False,
           blocks: set | None = None) -> list[Op]:
    """The conditional norms' B2 calls (or, with ``backward``, their B2b
    calls); with ``blocks``, only the norms of those blocks."""
    lat, elt = model_cfg["latent_size"], ELT[model_cfg["compute_dtype"]]
    out = []
    for rows, residual, block in norm_list(model_cfg):
        if blocks is not None and block not in blocks:
            continue
        field = n[rows] * lat * elt * batch
        if backward:
            out.append(Op("ln_bwd", 0.0, 3 * field + lat * 4))
        else:
            out.append(Op("ln_fwd", 0.0, (3 if residual else 2) * field + 2 * lat * 4))
    return out


def attn_ops(n: dict, lat: int, elt: int, batch: int, recomputed: bool = False) -> list[Op]:
    """One layer's attention forward over ``batch`` samples."""
    field = n["mesh"] * lat * elt * batch
    return [Op("attn_fwd", 0.0 if recomputed else 4.0 * n["pairs"] * lat * batch,
               4 * field + n["pairs"] * INDEX_BYTES)]


def attn_bwd_ops(n: dict, lat: int, elt: int, batch: int) -> list[Op]:
    field = n["mesh"] * lat * elt * batch
    return [Op("attn_bwd", 8.0 * n["pairs"] * lat * batch, 7 * field + 2 * n["pairs"] * INDEX_BYTES)]


def forward_ops(model_cfg: dict, n: dict, batch: int) -> list[Op]:
    """The forward's products, gathers, edge sums and attention over
    ``batch`` samples."""
    lat, cin, cout = model_cfg["latent_size"], model_cfg["channels_in"], model_cfg["channels_out"]
    ffn, elt = model_cfg["ffn_size"], ELT[model_cfg["compute_dtype"]]
    g, m = n["grid"] * batch, n["mesh"] * batch
    eg, ed = n["g2m"] * batch, n["m2g"] * batch
    ops = [_mm(batch, NOISE_IN, NOISE_HIDDEN), _mm(batch, NOISE_HIDDEN, COND_SIZE),
           _mm(batch, COND_SIZE, 2 * lat * norms(model_cfg))]
    ops += (_mlp(g, cin, lat) + _mlp(m, 3, lat) + _mlp(eg, 4, lat) + _mlp(eg, 3 * lat, lat)
            + edge_ops("g2m", n, lat, elt, batch) + _mlp(m, 2 * lat, lat) + _mlp(g, lat, lat))
    for _ in range(model_cfg["process_steps"]):
        ops += ([_mm(m, lat, lat)] * 3 + attn_ops(n, lat, elt, batch) + [_mm(m, lat, lat)]
                + [_mm(m, lat, ffn), _mm(m, ffn, lat)])
    ops += (_mlp(ed, 4, lat) + _mlp(ed, 3 * lat, lat) + edge_ops("m2g", n, lat, elt, batch)
            + _mlp(g, 2 * lat, lat) + [_mm(g, lat, lat), _mm(g, lat, cout)])
    return ops + ln_ops(model_cfg, n, batch)


def train_ops(model_cfg: dict, n: dict, batch: int) -> list[Op]:
    """One training step: the forward, the backward (products twice their
    operations; the gathers', edge sums', attention's and norms' backward)
    and the recomputed blocks' gathers, edge sums, attention and norms."""
    lat, elt = model_cfg["latent_size"], ELT[model_cfg["compute_dtype"]]
    fwd = forward_ops(model_cfg, n, batch)
    ops = fwd + [Op("matmul", 2 * op.flops, 0.0) for op in fwd if op.family == "matmul"]
    redo = remat_blocks(model_cfg["remat"])
    for block in ("g2m", "m2g"):
        ops += edge_ops(block, n, lat, elt, batch, backward=True)
        if block in redo:
            ops += edge_ops(block, n, lat, elt, batch, recomputed=True)
    layers = model_cfg["process_steps"]
    ops += attn_bwd_ops(n, lat, elt, batch) * layers
    if "mesh" in redo:
        ops += attn_ops(n, lat, elt, batch, recomputed=True) * layers
    return (ops + ln_ops(model_cfg, n, batch, backward=True)
            + ln_ops(model_cfg, n, batch, blocks=redo))


def attn_pairs(model_cfg: dict, n: dict, batch: int) -> int:
    """The (row, source) pairs attended in a step: each layer's lists for
    every head and sample, again for each recomputed layer."""
    calls = model_cfg["process_steps"] * (2 if "mesh" in remat_blocks(model_cfg["remat"]) else 1)
    return calls * model_cfg["attn_heads"] * n["pairs"] * batch


def param_count(model_cfg: dict) -> int:
    """The denoiser's parameters by the layer equations."""
    lat, cin, cout = model_cfg["latent_size"], model_cfg["channels_in"], model_cfg["channels_out"]
    ffn = model_cfg["ffn_size"]

    def dense(a, b):
        return a * b + b

    grid = sum(dense(d, lat) + dense(lat, lat)
               for d in (cin, 3, 4, 4, 3 * lat, 2 * lat, lat, 3 * lat, 2 * lat))
    layer = 4 * dense(lat, lat) + dense(lat, ffn) + dense(ffn, lat)
    return (dense(NOISE_IN, NOISE_HIDDEN) + dense(NOISE_HIDDEN, COND_SIZE) + grid
            + model_cfg["process_steps"] * layer + dense(lat, lat) + dense(lat, cout)
            + dense(COND_SIZE, 2 * lat * norms(model_cfg)))
