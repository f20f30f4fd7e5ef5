"""The plain reference of GenCast's denoiser training (Price et al., Nature
637, 2025; arXiv:2312.15796): its graphs, parameters, forward pass, EDM
denoising loss, gradients and AdamW steps.

Plain torch in float32 with TF32 off, one sample at a time; nothing of the
program is imported. The grid side is GraphCast's and is computed by
:mod:`portbench.reference.graphcast`'s plain blocks (its graphs, MLPs,
edge interactions and row chunks), each LayerNorm given the scale and
offset of its conditional norm. What it computes, as the configuration
states it:

* mesh: the icosahedron refined ``refine`` times, its finest vertices
  and finest edges only, in their natural order; each node attends over
  the nodes within ``k_hop`` edges, itself included, found here as
  reachability: a table of booleans, sources by nodes, ORed with itself
  through each node's neighbours once a hop;
* noise embedding ``c = MLP(Fourier(ln σ / 4))``: ``sin`` and ``cos`` of
  ``2π f_k ln σ / 4`` for 32 frequencies ``f_k = 16^{k/31}``, then Linear
  (64 → 32) → GELU → Linear (32 → 16);
* every norm ``LN(x)·(1 + s) + o``, ``(s, o) = W c + b`` (``norm_cond``:
  for each norm of :func:`norm_names` its ``L`` scale columns, then its
  ``L`` offset columns), float32 statistics, eps 1e-6;
* the grid MLPs (Linear → SiLU → Linear → conditional norm): the grid
  inputs, the mesh nodes' 3 features, each grid graph's 4 edge features;
  grid2mesh ``e′ = MLP([e, vG_s, vM_r])``, ``vM += MLP([vM, Σ e′])``,
  ``vG += MLP(vG)``; mesh2grid ``e′ = MLP([e, vM_s, vG_r])``, ``vG +=
  MLP([vG, Σ e′])``; output Linear → SiLU → Linear;
* ``process_steps`` transformer layers: ``x += Wo·MHA(LN_c(x))``, each of
  ``attn_heads`` heads a softmax of ``q_i·k_j / sqrt(dh)`` over every node
  ``j`` of ``i``'s k-hop neighbourhood; then ``x += W2·GELU(W1·LN_c(x))``.
  The attention is computed a block of nearby rows at a time (the mesh cut
  into blocks of at most ``ATTN_ROWS`` nodes by halving along the widest
  coordinate): the block's scores against the union of its rows' lists,
  a dense tile whose entries outside each row's own list are masked out,
  each block checkpointed, so it fits one card at the published size;
* EDM (σ_data 1): ``σ = exp(P_mean + P_std·n1)`` and the noise ``n2``
  drawn on the target's device from a ``torch.Generator`` seeded with the
  step's seed (``randn(B)``, then ``randn(y.shape)``); ``F`` sees ``[c_in
  (y + σ n2), cond]`` and σ; ``D = c_skip (y + σ n2) + c_out F``; the loss
  ``λ(σ)`` times the squared error weighted by latitude (cell area, mean
  1), level (pressure, mean 1) and variable, averaged; AdamW with decay on
  every parameter.

Departures from the paper, as the configuration lists them under
``assumed``: the noise is i.i.d. per grid node (GenCast samples it on the
sphere); the σ distribution is EDM's log-normal; k = 16, the FFN width
and GELU, the ``1 +`` of the conditional scale, the noise embedding's
sizes and the count of forcings and static fields are assumed; inputs and
targets are synthetic. ``cast`` stands where the program rounds to its
compute precision (the identity for the reference, a rounding for the bf16
witness and the float8 control).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import graphcast as gc
from portbench.reference.epd import Cast, identity, no_tf32

Tensor = torch.Tensor
LN_EPS = 1e-6
FREQUENCIES = 32
BASE_PERIOD = 16.0
NOISE_HIDDEN = 32
COND_SIZE = 16
# Rows of one attention block, and source rows a pass of the reachability.
ATTN_ROWS = 512
REACH_ELEMS = 1 << 27
GRID_MLPS = ("grid_embed", "mesh_embed", "g2m_edge_embed", "m2g_edge_embed",
             "grid2mesh.edge", "grid2mesh.mesh_node", "grid2mesh.grid_node",
             "mesh2grid.edge", "mesh2grid.grid_node")
AdamW = gc.AdamW

# ------------------------------------------------------------------ graphs


def reach_lists(edges: np.ndarray, n: int, hops: int, device) -> tuple[Tensor, Tensor]:
    """Every node's ``hops``-hop neighbourhood over the undirected
    ``edges`` ``(E, 2)``: ``(idx, mask)``, ``(n, D)`` long and bool, the
    nodes of row ``i`` ascending in ``idx[i][mask[i]]``."""
    deg = np.bincount(edges.ravel(), minlength=n)
    nbr = np.repeat(np.arange(n)[:, None], deg.max(), axis=1)  # padded with the node
    both = np.concatenate([edges, edges[:, ::-1]])
    both = both[np.argsort(both[:, 0], kind="stable")]
    start = np.concatenate([[0], np.cumsum(deg)])
    nbr[both[:, 0], np.arange(len(both)) - start[both[:, 0]]] = both[:, 1]
    nbr = torch.from_numpy(nbr).to(device)
    width = max(1, REACH_ELEMS // (n * nbr.shape[1]))
    rows = []
    for lo in range(0, n, width):
        src = torch.arange(lo, min(n, lo + width), device=device)
        reached = torch.zeros(len(src), n, dtype=torch.bool, device=device)
        reached[torch.arange(len(src), device=device), src] = True
        for _ in range(hops):
            reached = reached[:, nbr].any(dim=-1)
        rows.append(reached)
    count = [int(r.sum(1).max()) for r in rows]
    d = max(count)
    idx = torch.zeros(n, d, dtype=torch.long, device=device)
    mask = torch.zeros(n, d, dtype=torch.bool, device=device)
    at = 0
    for r in rows:
        i, j = r.nonzero(as_tuple=True)
        pos = torch.arange(len(i), device=device) - torch.searchsorted(i, i)
        idx[at + i, pos] = j
        mask[at + i, pos] = True
        at += len(r)
    return idx, mask


def row_blocks(xyz: np.ndarray, rows: int) -> list[np.ndarray]:
    """The nodes cut into blocks of at most ``rows`` nearby nodes: each
    set halved along its widest coordinate until it fits."""
    out, stack = [], [np.arange(len(xyz))]
    while stack:
        idx = stack.pop()
        if len(idx) <= rows:
            out.append(idx)
            continue
        p = xyz[idx]
        order = idx[np.argsort(p[:, np.argmax(p.max(0) - p.min(0))], kind="stable")]
        stack += [order[len(order) // 2:], order[:len(order) // 2]]
    return out


class DeviceGraphs(gc.DeviceGraphs):
    """GraphCast's grid graphs and loss weights on a device (the multimesh
    unused), the finest mesh's k-hop lists (``nbr_idx``, ``nbr_mask``) and
    its attention blocks: for each, ``(rows, cols, mask)``, the block's
    nodes, the union of their lists (ascending) and the ``(rows, cols)``
    mask of each row's own list; ``block_back`` puts the blocks' rows back
    in node order."""

    def __init__(self, graph_cfg: dict, device, loss_cfg: dict):
        super().__init__(gc.build_graphs(graph_cfg), device, loss_cfg)
        verts, faces = gc.icosphere(graph_cfg["refine"])
        self.nbr_idx, self.nbr_mask = reach_lists(gc._edges_of(faces[-1]), self.n_mesh,
                                                  graph_cfg["k_hop"], device)
        self.blocks = []
        for rows in row_blocks(verts, ATTN_ROWS):
            r = torch.from_numpy(rows).to(device)
            idx, keep = self.nbr_idx[r], self.nbr_mask[r]
            cols = torch.unique(idx[keep])
            mask = torch.zeros(len(r), len(cols), dtype=torch.bool, device=device)
            at = torch.arange(len(r), device=device)[:, None].expand_as(idx)
            mask[at[keep], torch.searchsorted(cols, idx[keep])] = True
            self.blocks.append((r, cols, mask))
        self.block_back = torch.argsort(torch.cat([r for r, _, _ in self.blocks]))


# -------------------------------------------------------------- parameters


def norm_names(layers: int) -> tuple[str, ...]:
    return GRID_MLPS + tuple(f"layer_{i}.{n}" for i in range(layers)
                             for n in ("attn_norm", "ffn_norm"))


def param_shapes(model_cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, as the program's state dict names
    them."""
    lat, ffn = model_cfg["latent_size"], model_cfg["ffn_size"]
    out: dict = {}

    def layers(prefix, dims):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"{prefix}.layer_{i}.w"] = (a, b)
            out[f"{prefix}.layer_{i}.b"] = (b,)

    layers("noise", [2 * FREQUENCIES, NOISE_HIDDEN, COND_SIZE])
    for name, d in (("grid_embed", model_cfg["channels_in"]), ("mesh_embed", 3),
                    ("g2m_edge_embed", 4), ("m2g_edge_embed", 4),
                    ("grid2mesh.edge", 3 * lat), ("grid2mesh.mesh_node", 2 * lat),
                    ("grid2mesh.grid_node", lat), ("mesh2grid.edge", 3 * lat),
                    ("mesh2grid.grid_node", 2 * lat)):
        layers(f"{name}.mlp", [d, lat, lat])
    for i in range(model_cfg["process_steps"]):
        for w in ("wq", "wk", "wv", "wo"):
            out[f"layer_{i}.attn.{w}.w"] = (lat, lat)
            out[f"layer_{i}.attn.{w}.b"] = (lat,)
        layers(f"layer_{i}.ffn", [lat, ffn, lat])
    layers("output", [lat, lat, model_cfg["channels_out"]])
    n = len(norm_names(model_cfg["process_steps"]))
    out["norm_cond.w"] = (COND_SIZE, 2 * n * lat)
    out["norm_cond.b"] = (2 * n * lat,)
    return out


def init_params(model_cfg: dict, generator: torch.Generator) -> dict[str, Tensor]:
    """Drawn in one call on the generator's device: weights Glorot-uniform
    (``norm_cond.w`` over each norm's own ``16 → L`` fans), biases uniform
    in ±0.1; float32."""
    shapes = param_shapes(model_cfg)
    lat = model_cfg["latent_size"]
    u = torch.rand(sum(math.prod(s) for s in shapes.values()), generator=generator,
                   device=generator.device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        v = u[at:at + math.prod(shape)].reshape(shape)
        at += math.prod(shape)
        if len(shape) == 2:
            fan_out = lat if name == "norm_cond.w" else shape[1]
            v = v * math.sqrt(6.0 / (shape[0] + fan_out))
        else:
            v = 0.1 * v
        out[name] = v.clone()
    return out


# ----------------------------------------------------------------- forward


def _dense(p: dict, name: str, x: Tensor, cast: Cast) -> Tensor:
    return cast(cast(x) @ cast(p[f"{name}.w"]) + cast(p[f"{name}.b"]))


def condition(p: dict, model_cfg: dict, sigma: Tensor) -> dict[str, tuple[Tensor, Tensor]]:
    """Each norm's ``(1 + s, o)`` for one noise level, float32."""
    freqs = BASE_PERIOD ** (torch.arange(FREQUENCIES, device=sigma.device) / (FREQUENCIES - 1))
    ang = 2 * math.pi * (torch.log(sigma) / 4) * freqs
    feats = torch.cat([torch.sin(ang), torch.cos(ang)])
    h = F.gelu(feats @ p["noise.layer_0.w"] + p["noise.layer_0.b"])
    c = h @ p["noise.layer_1.w"] + p["noise.layer_1.b"]
    so = (c @ p["norm_cond.w"] + p["norm_cond.b"]).reshape(-1, 2, model_cfg["latent_size"])
    return {n: (1 + so[i, 0], so[i, 1]) for i, n in enumerate(norm_names(model_cfg["process_steps"]))}


def cond_norm(x: Tensor, scale: Tensor, offset: Tensor, cast: Cast) -> Tensor:
    return cast(gc._norm(x) * scale + offset)


def _attend_block(q: Tensor, k: Tensor, v: Tensor, rows: Tensor, cols: Tensor,
                  mask: Tensor, scale: float, cast: Cast) -> Tensor:
    """One block: its rows of ``q`` over the columns ``cols`` of ``k`` and
    ``v`` (all ``(N, H, dh)``), each row's scores outside its own list
    masked out: ``(rows, H, dh)``."""
    qb, kb, vb = q[rows].transpose(0, 1), k[cols].transpose(0, 1), v[cols].transpose(0, 1)
    s = torch.where(mask, torch.matmul(qb, kb.transpose(-1, -2)) * scale, float("-inf"))
    return torch.matmul(cast(torch.softmax(s, dim=-1)), vb).transpose(0, 1)


def attend(q: Tensor, k: Tensor, v: Tensor, dg: DeviceGraphs, scale: float,
           cast: Cast) -> Tensor:
    """Softmax attention of each row of ``q`` over its k-hop list in ``k``
    and ``v``, all ``(N, H, dh)``, a block of rows at a time (each
    checkpointed)."""
    out = torch.cat([checkpoint(_attend_block, q, k, v, rows, cols, mask, scale, cast,
                                use_reentrant=False) for rows, cols, mask in dg.blocks])
    return out[dg.block_back]


def attention(p: dict, name: str, x: Tensor, dg: DeviceGraphs, heads: int,
              cast: Cast) -> Tensor:
    """Multi-head attention over the k-hop lists (:func:`attend`)."""
    n, lat = x.shape
    dh = lat // heads
    q, k, v = (_dense(p, f"{name}.{w}", x, cast).reshape(n, heads, dh) for w in ("wq", "wk", "wv"))
    out = attend(q, k, v, dg, 1.0 / math.sqrt(dh), cast)
    return _dense(p, f"{name}.wo", cast(out.reshape(n, lat)), cast)


def forward(p: dict, model_cfg: dict, dg: DeviceGraphs, x: Tensor, sigma: Tensor,
            cast: Cast = identity) -> Tensor:
    """``F`` for one sample: ``x`` ``(grid nodes, channels_in)``, ``sigma`` a
    0-d tensor → ``(grid nodes, channels_out)``."""
    cond = condition(p, model_cfg, sigma)
    q = dict(p)
    for name in GRID_MLPS:
        q[f"{name}.norm.scale"], q[f"{name}.norm.bias"] = cond[name]
    g2m, m2g = dg.edges["grid2mesh"], dg.edges["mesh2grid"]
    vg = gc._rows(lambda t: gc.mlp(q, "grid_embed", cast(t), cast), dg.n_grid, x)
    vm = gc.mlp(q, "mesh_embed", cast(dg.mesh_features), cast)
    _, agg = gc._interact(q, "grid2mesh.edge", g2m, "g2m_edge_embed", vg, vm, dg.n_mesh,
                          cast, residual=False)
    vm = gc.mlp(q, "grid2mesh.mesh_node", torch.cat([vm, agg], -1), cast, vm)
    vg = gc._rows(lambda t: gc.mlp(q, "grid2mesh.grid_node", t, cast, t), dg.n_grid, vg)
    for i in range(model_cfg["process_steps"]):
        a = cond_norm(vm, *cond[f"layer_{i}.attn_norm"], cast)
        vm = cast(vm + attention(p, f"layer_{i}.attn", a, dg, model_cfg["attn_heads"], cast))
        h = cond_norm(vm, *cond[f"layer_{i}.ffn_norm"], cast)
        h = cast(F.gelu(_dense(p, f"layer_{i}.ffn.layer_0", h, cast)))
        vm = cast(vm + _dense(p, f"layer_{i}.ffn.layer_1", h, cast))
    _, agg = gc._interact(q, "mesh2grid.edge", m2g, "m2g_edge_embed", vm, vg, dg.n_grid,
                          cast, residual=False)
    vg = gc._rows(lambda t, a: gc.mlp(q, "mesh2grid.grid_node", torch.cat([t, a], -1), cast, t),
                  dg.n_grid, vg, agg)
    return gc._rows(lambda t: gc._linear(q, "output.layer_1",
                                         cast(F.silu(gc._linear(q, "output.layer_0", t, cast))),
                                         cast),
                    dg.n_grid, vg)


def draw(seed: int, y: Tensor, opt: dict) -> tuple[Tensor, Tensor]:
    """The step's ``(σ (B,), noise like y)``, drawn as the module docstring
    says."""
    gen = torch.Generator(device=y.device).manual_seed(int(seed))
    sigma = torch.exp(opt["p_mean"] + opt["p_std"] * torch.randn(y.shape[0], generator=gen,
                                                                 device=y.device))
    return sigma, torch.randn(y.shape, generator=gen, device=y.device)


def loss_and_grads(p: dict, model_cfg: dict, dg: DeviceGraphs, cond: Tensor, y: Tensor,
                   seed: int, noise_cfg: dict, cast: Cast = identity
                   ) -> tuple[float, dict[str, Tensor]]:
    """The EDM loss over the batch ``(B, grid nodes, ·)`` and its
    gradients, one sample at a time."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    sigma, noise = draw(seed, y, noise_cfg)
    total, b = 0.0, y.shape[0]
    for i in range(b):
        s = sigma[i]
        root = torch.sqrt(s * s + 1)
        noisy = y[i] + s * noise[i]
        out = forward(leaves, model_cfg, dg, torch.cat([noisy / root, cond[i]], -1), s, cast)
        denoised = noisy / (s * s + 1) + (s / root) * out
        err = ((denoised - y[i]) ** 2 * dg.w_chan).mean(-1)
        loss = (s * s + 1) / (s * s) * (err * dg.w_node).mean() / b
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
            grads[k] += g
        total += float(loss.detach())
    return total, grads


def train_steps(p: dict, model_cfg: dict, opt_cfg: dict, noise_cfg: dict, dg: DeviceGraphs,
                batches: list[tuple[Tensor, Tensor, int]], cast: Cast = identity) -> dict:
    """AdamW steps over ``batches`` ``(cond, y, seed)``: each step's loss,
    the first step's gradients and the parameters after the last step."""
    opt = AdamW(p, opt_cfg)
    losses, first = [], None
    with no_tf32():
        for cond, y, seed in batches:
            loss, grads = loss_and_grads(p, model_cfg, dg, cond, y, seed, noise_cfg, cast)
            losses.append(loss)
            first = grads if first is None else first
            p = opt.step(p, grads)
    return {"losses": losses, "grads": first, "params": p}
