"""GenCast's graphs (Price et al. 2025, arXiv:2312.15796): GraphCast's grid
encoder and decoder graphs (:mod:`gwen_tpu_torch.graph.graphcast`, reused
as they are) around a mesh of the finest icosphere level alone, whose
transformer attends over each node's ``hops``-hop neighbourhood.

* Mesh: the refinement-``L`` icosphere's vertices and its own edges (no
  multimesh), in a locality order: :func:`~gwen_tpu_torch.graph.reorder.
  kd_patch_order` with leaves of :data:`LEAF` nodes, so the rows a kernel
  block covers form a compact patch whose neighbourhoods overlap.
* Neighbourhoods: every node within ``hops`` edges of a node, itself
  included, found by frontier expansion
  (:func:`~gwen_tpu_torch.graph.graph.khop_lists`): ``1 + 3h(h + 1)``
  nodes on the hexagonal part of the mesh, fewer near the 12 pentagons.
  At M6 and 16 hops, 40,962 lists of 681 to 817 nodes.
* Grid2mesh and mesh2grid: GraphCast's, their mesh node numbers taken to
  the locality order and each edge list sorted again by receiver, then
  sender; each edge keeps its features.

The neighbourhood is symmetric, so the transpose lists the attention's
source-side backward walks are the lists themselves
(:class:`~gwen_tpu_torch.graph.graph.NeighbourListGraph`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from gwen_tpu_torch.graph.build import faces_to_edges
from gwen_tpu_torch.graph.graph import NeighbourListGraph, neighbour_list_graph
from gwen_tpu_torch.graph.graphcast import (
    BipartiteGraph,
    _bipartite,
    grid2mesh_edges,
    grid_xyz,
    icosphere_faces,
    max_edge_length,
    mesh2grid_edges,
    mesh_node_features,
)
from gwen_tpu_torch.graph.reorder import kd_patch_order

Tensor = torch.Tensor
# Nodes a leaf of the mesh's locality order: one kernel block's rows.
LEAF = 64


@dataclass
class GenCastGraphs:
    """GenCast's context: GraphCast's grid2mesh and mesh2grid, the mesh
    nodes' 3 features, the mesh's neighbour lists and ``mesh_perm``
    (mesh row ``i`` is icosphere vertex ``mesh_perm[i]``)."""

    grid2mesh: BipartiteGraph
    mesh2grid: BipartiteGraph
    mesh: NeighbourListGraph
    mesh_features: Tensor
    mesh_perm: Tensor
    grid_shape: tuple[int, int]

    @property
    def num_grid(self) -> int:
        return self.grid_shape[0] * self.grid_shape[1]

    @property
    def num_mesh(self) -> int:
        return int(self.mesh_features.shape[0])

    def to(self, device) -> "GenCastGraphs":
        return replace(self, grid2mesh=self.grid2mesh.to(device),
                       mesh2grid=self.mesh2grid.to(device), mesh=self.mesh.to(device),
                       mesh_features=self.mesh_features.to(device),
                       mesh_perm=self.mesh_perm.to(device))


def _receiver_sorted(s: np.ndarray, r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    order = np.lexsort((s, r))
    return s[order], r[order]


def build_gencast_graphs(n_lat: int = 721, n_lon: int = 1440, refine: int = 6,
                         radius_factor: float = 0.6, hops: int = 16,
                         device="cpu") -> GenCastGraphs:
    """GenCast's graphs at ``n_lat × n_lon`` on the level-``refine`` mesh
    with ``hops``-hop neighbourhoods (the published 0.25° model: 721 ×
    1440, M6, 0.6, 16). The grid graphs are built on the host, the
    neighbour lists on ``device``; all of it lands there."""
    verts, faces = icosphere_faces(refine)
    s, r = faces_to_edges(faces[-1])
    n = len(verts)
    perm = kd_patch_order(verts, s, r, n, leaf_size=LEAF)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    pverts = verts[perm]
    gxyz = grid_xyz(n_lat, n_lon)
    radius = radius_factor * max_edge_length(verts, faces[-1])
    gs, gr = grid2mesh_edges(n_lat, n_lon, verts, radius)
    ds, dr = mesh2grid_edges(n_lat, n_lon, verts, faces)
    gs, gr = _receiver_sorted(gs, inv[gr])
    ds, dr = _receiver_sorted(inv[ds], dr)
    return GenCastGraphs(
        grid2mesh=_bipartite(gs, gr, gxyz, pverts),
        mesh2grid=_bipartite(ds, dr, pverts, gxyz),
        mesh=neighbour_list_graph(inv[s], inv[r], n, hops, device),
        mesh_features=torch.from_numpy(mesh_node_features(pverts)),
        mesh_perm=torch.from_numpy(perm),
        grid_shape=(n_lat, n_lon)).to(device)
