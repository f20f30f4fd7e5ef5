"""The plain reference of GraphCast (Lam et al., Science 2023;
arXiv:2212.12794): its graphs, parameters, forward pass, weighted loss,
gradients and AdamW steps.

Plain torch in float32 with TF32 off, one sample at a time; the graphs
are built here in numpy from the published rules, and nothing of the
program is imported. What it computes, as the configuration states it:

* grid: ``grid_lat`` latitudes from −90° to 90° (poles included) by
  ``grid_lon`` longitudes from 0°, node ``i · grid_lon + j``;
* multimesh: the icosahedron refined ``refine`` times (each triangle into
  4, midpoints pushed to the sphere), its finest vertices with the edges of
  every level, both directions;
* grid2mesh: every (grid node, mesh node) pair at chord distance at most
  ``g2m_radius`` × the longest finest-level edge;
* mesh2grid: each grid node from the 3 vertices of the finest triangle
  that contains it (its coordinates in the triangle's vertices all ≥ 0,
  within ``TIE``); a node on an edge
  or a vertex takes, of the triangles it lies in, the one whose sorted
  vertex numbers come first;
* edge features ``[|d|, d] / max |d|`` over each set, ``d`` the sender −
  receiver difference rotated to the receiver's frame; mesh node features
  cos lat, sin lon, cos lon;
* every MLP ``Linear → SiLU → Linear → LayerNorm`` (eps 1e-6, float32
  statistics), latent and hidden ``latent_size``: five embedders;
  grid2mesh ``e′ = MLP([e, vG_s, vM_r])``, ``vM += MLP([vM, Σ e′])``,
  ``vG += MLP(vG)``; ``process_steps`` layers ``e += MLP([e, vM_s, vM_r])``
  then ``vM += MLP([vM, Σ e])``; mesh2grid ``e′ = MLP([e, vM_s, vG_r])``,
  ``vG += MLP([vG, Σ e′])``; output ``Linear → SiLU → Linear``;
* the loss: the squared error weighted by each latitude row's cell area
  (mean 1), by pressure over the 37 levels (mean 1) and by variable
  (surface: 1, 0.1, 0.1, 0.1, 0.1), averaged; AdamW with decoupled decay on
  every parameter.

Departures from the paper: the icosahedron is the program's (a vertex at
each pole), not GraphCast's rotated one, so the grid2mesh count differs
from the published one; inputs and targets are synthetic.

Edges and grid rows are computed in chunks of ``CHUNK`` rows, each chunk
checkpointed, so float32 fits one card at the published size; chunking
changes only the order of the sums. ``cast`` stands where the program
rounds to its compute precision (the identity for the reference, a
rounding for the bf16 witness and the float8 control).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.epd import Cast, identity, no_tf32

Tensor = torch.Tensor
LN_EPS = 1e-6
CHUNK = 1 << 18
TIE = 1e-9

# ------------------------------------------------------------------ graphs

_PHI = (1.0 + math.sqrt(5.0)) / 2.0
# The program's icosahedron, vertices and faces in its order (the mesh's
# node numbering follows from it).
ICO_VERTS = np.array([[-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
                      [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
                      [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1]])
ICO_FACES = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                      [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                      [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                      [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])


def _edges_of(faces: np.ndarray) -> np.ndarray:
    """A triangulation's undirected edges, ``(low, high)``, sorted."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return np.unique(np.sort(e, axis=1), axis=0)


def icosphere(levels: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """The finest vertices and each level's faces. A new vertex is the
    normalised midpoint of an edge, numbered after the old ones in the
    order of its edge's ``(low, high)`` pair."""
    verts = ICO_VERTS / np.linalg.norm(ICO_VERTS, axis=1, keepdims=True)
    faces, out = ICO_FACES, [ICO_FACES]
    for _ in range(levels):
        edges = _edges_of(faces)
        mid = verts[edges[:, 0]] + verts[edges[:, 1]]
        mid = mid / np.linalg.norm(mid, axis=1, keepdims=True)
        key = {(int(a), int(b)): len(verts) + i for i, (a, b) in enumerate(edges)}
        new = []
        for a, b, c in faces:
            ab, bc, ca = (key[tuple(sorted((int(u), int(v))))] for u, v in ((a, b), (b, c), (c, a)))
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.concatenate([verts, mid]), np.array(new)
        out.append(faces)
    return verts, out


def unit(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    lat, lon = np.broadcast_arrays(lat, lon)
    c = np.cos(lat)
    return np.stack([c * np.cos(lon), c * np.sin(lon), np.sin(lat)], axis=-1)


def grid_points(n_lat: int, n_lon: int) -> np.ndarray:
    lat = np.deg2rad(np.linspace(-90.0, 90.0, n_lat))
    lon = np.deg2rad(np.arange(n_lon) * (360.0 / n_lon))
    return unit(lat[:, None], lon[None, :]).reshape(-1, 3)


def _sorted(s: np.ndarray, r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    order = np.lexsort((s, r))
    return s[order], r[order]


def multimesh_edges(faces: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    e = np.unique(np.concatenate([_edges_of(f) for f in faces]), axis=0)
    return _sorted(np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]]))


def g2m_edges(n_lat: int, n_lon: int, grid: np.ndarray, mesh: np.ndarray,
              radius: float) -> tuple[np.ndarray, np.ndarray]:
    """Every pair within ``radius``: each grid row against the mesh nodes in
    its band of latitude, all of the row's longitudes (``2 − 2 p·q``
    chooses the candidates, the difference's squared norm decides)."""
    lat = np.deg2rad(np.linspace(-90.0, 90.0, n_lat))
    m_lat = np.arcsin(np.clip(mesh[:, 2], -1, 1))
    band = 2 * np.arcsin(radius / 2) + 1e-6
    s, r = [], []
    for i in range(n_lat):
        near = np.nonzero(np.abs(m_lat - lat[i]) <= band)[0]
        row = grid[i * n_lon:(i + 1) * n_lon]
        gi, mi = np.nonzero(2 - 2 * (row @ mesh[near].T) <= radius * radius * (1 + 1e-6))
        d2 = ((row[gi] - mesh[near[mi]]) ** 2).sum(-1)
        keep = d2 <= radius * radius
        s.append(i * n_lon + gi[keep])
        r.append(near[mi[keep]])
    return _sorted(np.concatenate(s), np.concatenate(r))


def _ranges(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(owner, value)`` of every integer in each ``[lo, hi]``."""
    count = np.maximum(hi - lo + 1, 0)
    owner = np.repeat(np.arange(len(lo)), count)
    return owner, lo[owner] + np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)


def m2g_edges(n_lat: int, n_lon: int, grid: np.ndarray, verts: np.ndarray,
              faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """3 edges to each grid node from the vertices of its triangle: each
    triangle against the grid nodes of its box of latitude and longitude
    (widened by its longest side, more than any of its arcs bulges; every
    longitude near a pole)."""
    tri = verts[faces]  # (F, 3 vertices, 3)
    inv = np.linalg.inv(np.transpose(tri, (0, 2, 1)))  # p → its (a, b, c) coordinates
    t_lat = np.arcsin(np.clip(tri[..., 2], -1, 1))
    t_lon = np.arctan2(tri[..., 1], tri[..., 0])
    side = np.linalg.norm(tri - np.roll(tri, 1, axis=1), axis=2).max(1)
    dlat, dlon = np.pi / (n_lat - 1), 2 * np.pi / n_lon
    row_lo = np.clip(np.floor((t_lat.min(1) - side + np.pi / 2) / dlat), 0, n_lat - 1)
    row_hi = np.clip(np.ceil((t_lat.max(1) + side + np.pi / 2) / dlat), 0, n_lat - 1)
    rel = np.mod(t_lon - t_lon[:, :1] + np.pi, 2 * np.pi) - np.pi
    reach = np.abs(t_lat).max(1) + 2 * side
    pad = np.where(reach < np.pi / 2, side / np.cos(np.minimum(reach, np.pi / 2 - 1e-3)), np.pi)
    col_lo = np.floor((t_lon[:, 0] + rel.min(1) - pad) / dlon)
    col_hi = np.ceil((t_lon[:, 0] + rel.max(1) + pad) / dlon)
    whole = (col_hi - col_lo + 1 >= n_lon) | (reach >= np.pi / 2)
    col_lo = np.where(whole, 0, col_lo).astype(np.int64)
    col_hi = np.where(whole, n_lon - 1, col_hi).astype(np.int64)
    f_row, row = _ranges(row_lo.astype(np.int64), row_hi.astype(np.int64))
    pair, col = _ranges(col_lo[f_row], col_hi[f_row])
    face, point = f_row[pair], row[pair] * n_lon + np.mod(col, n_lon)
    coords = np.einsum("pjk,pk->pj", inv[face], grid[point]).min(1)
    inside = coords >= -TIE
    face, point = face[inside], point[inside]
    # Of the triangles a node lies in, the one with the smallest sorted
    # vertex numbers.
    v = np.sort(faces, axis=1).astype(np.int64)
    key = ((v[:, 0] * len(verts) + v[:, 1]) * len(verts) + v[:, 2])[face]
    order = np.lexsort((key, point))
    first = order[np.r_[True, point[order][1:] != point[order][:-1]]]
    if len(first) != n_lat * n_lon:
        raise AssertionError("a grid node lies in no triangle")
    return np.sort(faces[face[first]], axis=1).reshape(-1), np.repeat(point[first], 3)


def edge_feats(xs: np.ndarray, xr: np.ndarray) -> np.ndarray:
    lat = np.arcsin(np.clip(xr[:, 2], -1, 1))
    lon = np.arctan2(xr[:, 1], xr[:, 0])
    d = xs - xr
    rot_z = np.stack([np.cos(lon) * d[:, 0] + np.sin(lon) * d[:, 1],
                      -np.sin(lon) * d[:, 0] + np.cos(lon) * d[:, 1], d[:, 2]], axis=1)
    rel = np.stack([np.cos(lat) * rot_z[:, 0] + np.sin(lat) * rot_z[:, 2], rot_z[:, 1],
                    -np.sin(lat) * rot_z[:, 0] + np.cos(lat) * rot_z[:, 2]], axis=1)
    n = np.sqrt((rel ** 2).sum(1, keepdims=True))
    return (np.concatenate([n, rel], axis=1) / n.max()).astype(np.float32)


def build_graphs(graph_cfg: dict) -> dict:
    """``{"grid2mesh"|"mesh"|"mesh2grid": (senders, receivers, features),
    "mesh_features", "n_grid", "n_mesh", "n_lat", "n_lon"}`` in numpy
    (built once a process for each configuration)."""
    return _graphs(graph_cfg["grid_lat"], graph_cfg["grid_lon"], graph_cfg["refine"],
                   graph_cfg["g2m_radius"])


@functools.lru_cache(maxsize=2)
def _graphs(n_lat: int, n_lon: int, refine: int, radius_factor: float) -> dict:
    verts, faces = icosphere(refine)
    grid = grid_points(n_lat, n_lon)
    e = _edges_of(faces[-1])
    radius = radius_factor * np.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], axis=1).max()
    out = {"n_grid": len(grid), "n_mesh": len(verts), "n_lat": n_lat, "n_lon": n_lon}
    for name, (s, r), xs, xr in (
            ("grid2mesh", g2m_edges(n_lat, n_lon, grid, verts, radius), grid, verts),
            ("mesh", multimesh_edges(faces), verts, verts),
            ("mesh2grid", m2g_edges(n_lat, n_lon, grid, verts, faces[-1]), verts, grid)):
        out[name] = (s, r, edge_feats(xs[s], xr[r]))
    lat = np.arcsin(np.clip(verts[:, 2], -1, 1))
    lon = np.arctan2(verts[:, 1], verts[:, 0])
    out["mesh_features"] = np.stack([np.cos(lat), np.sin(lon), np.cos(lon)], 1).astype(np.float32)
    return out


class DeviceGraphs:
    """:func:`build_graphs` on a device, with the loss's weights: each
    latitude row's cell area (``cos lat · sin(Δ/2)``, ``sin²(Δ/4)`` at the
    poles) and each channel's (``loss_cfg``: the levels' pressures, the
    number of atmospheric variables, the surface variables' weights), each
    at mean 1."""

    def __init__(self, graphs: dict, device, loss_cfg: dict):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        self.n_grid, self.n_mesh = graphs["n_grid"], graphs["n_mesh"]
        self.edges = {k: (t(graphs[k][0]).long(), t(graphs[k][1]).long(), t(graphs[k][2]))
                      for k in ("grid2mesh", "mesh", "mesh2grid")}
        self.mesh_features = t(graphs["mesh_features"])
        n_lat = graphs["n_lat"]
        lat = np.deg2rad(np.linspace(-90.0, 90.0, n_lat))
        delta = np.pi / (n_lat - 1)
        area = np.cos(lat) * np.sin(delta / 2)
        area[0] = area[-1] = np.sin(delta / 4) ** 2
        self.w_node = t(np.repeat(area / area.mean(), graphs["n_lon"])).float()
        lv = np.asarray(loss_cfg["levels_hpa"], np.float64)
        self.w_chan = t(np.concatenate([np.tile(lv / lv.mean(), loss_cfg["atmospheric"]),
                                        loss_cfg["surface_weights"]])).float()


# -------------------------------------------------------------- parameters

def _mlp_shapes(out: dict, prefix: str, d_in: int, lat: int) -> None:
    for i, (a, b) in enumerate(((d_in, lat), (lat, lat))):
        out[f"{prefix}.mlp.layer_{i}.w"] = (a, b)
        out[f"{prefix}.mlp.layer_{i}.b"] = (b,)
    out[f"{prefix}.norm.scale"] = (lat,)
    out[f"{prefix}.norm.bias"] = (lat,)


def param_shapes(model_cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, as the program's state dict names
    them."""
    lat = model_cfg["latent_size"]
    out: dict = {}
    for name, d in (("grid_embed", model_cfg["channels_in"]), ("mesh_embed", 3),
                    ("mesh_edge_embed", 4), ("g2m_edge_embed", 4), ("m2g_edge_embed", 4),
                    ("grid2mesh.edge", 3 * lat), ("grid2mesh.mesh_node", 2 * lat),
                    ("grid2mesh.grid_node", lat)):
        _mlp_shapes(out, name, d, lat)
    for i in range(model_cfg["process_steps"]):
        _mlp_shapes(out, f"process_{i}.edge", 3 * lat, lat)
        _mlp_shapes(out, f"process_{i}.node", 2 * lat, lat)
    _mlp_shapes(out, "mesh2grid.edge", 3 * lat, lat)
    _mlp_shapes(out, "mesh2grid.grid_node", 2 * lat, lat)
    for i, (a, b) in enumerate(((lat, lat), (lat, model_cfg["channels_out"]))):
        out[f"output.layer_{i}.w"] = (a, b)
        out[f"output.layer_{i}.b"] = (b,)
    return out


def init_params(model_cfg: dict, generator: torch.Generator) -> dict[str, Tensor]:
    """Drawn in one call on the generator's device: weights Glorot-uniform,
    biases and LayerNorm offsets uniform in ±0.1, LayerNorm scales in
    1 ± 0.1; float32."""
    shapes = param_shapes(model_cfg)
    u = torch.rand(sum(math.prod(s) for s in shapes.values()), generator=generator,
                   device=generator.device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        v = u[at:at + math.prod(shape)].reshape(shape)
        at += math.prod(shape)
        if len(shape) == 2:
            v = v * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif name.endswith("norm.scale"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.clone()
    return out


# ----------------------------------------------------------------- forward

def _linear(p: dict, name: str, x: Tensor, cast: Cast) -> Tensor:
    return cast(cast(x) @ cast(p[f"{name}.w"]) + cast(p[f"{name}.b"]))


def _norm(m: Tensor) -> Tensor:
    mu = m.mean(dim=-1, keepdim=True)
    var = ((m - mu) ** 2).mean(dim=-1, keepdim=True)
    return (m - mu) * torch.rsqrt(var + LN_EPS)


def mlp(p: dict, name: str, x: Tensor, cast: Cast, residual: Tensor | None = None) -> Tensor:
    """``Linear → SiLU → Linear → LayerNorm`` (+ ``residual``)."""
    h = cast(F.silu(_linear(p, f"{name}.mlp.layer_0", x, cast)))
    h = _norm(_linear(p, f"{name}.mlp.layer_1", h, cast))
    if residual is None:
        return cast(h * cast(p[f"{name}.norm.scale"]) + cast(p[f"{name}.norm.bias"]))
    return cast(h * p[f"{name}.norm.scale"] + p[f"{name}.norm.bias"] + residual)


def _rows(fn, n: int, *tensors: Tensor) -> Tensor:
    """``fn`` over ``CHUNK``-row slices of ``tensors`` (each with ``n``
    rows), each slice checkpointed; the results joined."""
    return torch.cat([checkpoint(fn, *(t[lo:lo + CHUNK] for t in tensors), use_reentrant=False)
                      for lo in range(0, n, CHUNK)])


def _interact(p: dict, name: str, edges, e_or_embed, xs: Tensor, xr: Tensor,
              n_recv: int, cast: Cast, residual: bool):
    """``(new edge latents or None, cast(Σ over each receiver))`` of an
    edge MLP on ``[e, xs_s, xr_r]``, CHUNK edges at a time. ``e_or_embed``
    is the edge latent, or the name of the embedder of the static edge
    features."""
    s, r, feats = edges
    kept, total = [], torch.zeros(n_recv, xr.shape[-1], device=xr.device)
    for lo in range(0, len(s), CHUNK):
        sl = slice(lo, lo + CHUNK)

        def chunk(e_c, xs, xr, s_c, r_c):
            if isinstance(e_or_embed, str):
                e_c = mlp(p, e_or_embed, cast(e_c), cast)
            x = torch.cat([e_c, xs[s_c], xr[r_c]], dim=-1)
            return mlp(p, name, x, cast, e_c if residual else None)

        src = feats[sl] if isinstance(e_or_embed, str) else e_or_embed[sl]
        y = checkpoint(chunk, src, xs, xr, s[sl], r[sl], use_reentrant=False)
        total = total.index_add(0, r[sl], y)
        if residual:
            kept.append(y)
    return (torch.cat(kept) if residual else None), cast(total)


def forward(p: dict, model_cfg: dict, dg: DeviceGraphs, x: Tensor,
            cast: Cast = identity) -> Tensor:
    """One sample: ``x`` ``(grid nodes, channels_in)`` → ``(grid nodes,
    channels_out)``."""
    g2m, mesh, m2g = (dg.edges[k] for k in ("grid2mesh", "mesh", "mesh2grid"))
    vg = _rows(lambda t: mlp(p, "grid_embed", cast(t), cast), dg.n_grid, x)
    vm = mlp(p, "mesh_embed", cast(dg.mesh_features), cast)
    e = mlp(p, "mesh_edge_embed", cast(mesh[2]), cast)
    _, agg = _interact(p, "grid2mesh.edge", g2m, "g2m_edge_embed", vg, vm, dg.n_mesh,
                       cast, residual=False)
    vm = mlp(p, "grid2mesh.mesh_node", torch.cat([vm, agg], -1), cast, vm)
    vg = _rows(lambda t: mlp(p, "grid2mesh.grid_node", t, cast, t), dg.n_grid, vg)
    for i in range(model_cfg["process_steps"]):
        e, agg = _interact(p, f"process_{i}.edge", mesh, e, vm, vm, dg.n_mesh, cast,
                           residual=True)
        vm = mlp(p, f"process_{i}.node", torch.cat([vm, agg], -1), cast, vm)
    _, agg = _interact(p, "mesh2grid.edge", m2g, "m2g_edge_embed", vm, vg, dg.n_grid,
                       cast, residual=False)
    vg = _rows(lambda t, a: mlp(p, "mesh2grid.grid_node", torch.cat([t, a], -1), cast, t),
               dg.n_grid, vg, agg)
    return _rows(lambda t: _linear(p, "output.layer_1",
                                   cast(F.silu(_linear(p, "output.layer_0", t, cast))), cast),
                 dg.n_grid, vg)


def loss_and_grads(p: dict, model_cfg: dict, dg: DeviceGraphs, x: Tensor, y: Tensor,
                   cast: Cast = identity) -> tuple[float, dict[str, Tensor]]:
    """The weighted MSE over the batch ``(B, grid nodes, C)`` and its
    gradients, one sample at a time."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total, b = 0.0, x.shape[0]
    for i in range(b):
        err = ((forward(leaves, model_cfg, dg, x[i], cast) - y[i]) ** 2 * dg.w_chan).mean(-1)
        loss = (err * dg.w_node).mean() / b
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
            grads[k] += g
        total += float(loss.detach())
    return total, grads


class AdamW:
    """AdamW as torch's: decay ``p ← p (1 − lr·wd)`` on every parameter,
    then the bias-corrected Adam step."""

    def __init__(self, params: dict[str, Tensor], opt_cfg: dict):
        self.lr, self.wd, self.eps = opt_cfg["lr"], opt_cfg["weight_decay"], opt_cfg["eps"]
        self.b1, self.b2 = opt_cfg["betas"]
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict[str, Tensor], grads: dict[str, Tensor]) -> dict[str, Tensor]:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            decayed = params[k] * (1 - self.lr * self.wd)
            out[k] = decayed - self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
        return out


def train_steps(p: dict, model_cfg: dict, opt_cfg: dict, dg: DeviceGraphs,
                batches: list[tuple[Tensor, Tensor]], cast: Cast = identity) -> dict:
    """AdamW steps over ``batches``: each step's loss, the first step's
    gradients and the parameters after the last step."""
    opt = AdamW(p, opt_cfg)
    losses, first = [], None
    with no_tf32():
        for x, y in batches:
            loss, grads = loss_and_grads(p, model_cfg, dg, x, y, cast)
            losses.append(loss)
            first = grads if first is None else first
            p = opt.step(p, grads)
    return {"losses": losses, "grads": first, "params": p}
