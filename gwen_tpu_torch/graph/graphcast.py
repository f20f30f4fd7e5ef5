"""GraphCast's graphs (Lam et al. 2023, arXiv:2212.12794), built on the host
in numpy: the latitude-longitude grid, the multimesh, grid2mesh and
mesh2grid, each a :class:`BipartiteGraph` with its 4 edge features, and
the mesh nodes' 3 features.

* Grid: ``n_lat`` latitudes from −90° to 90°, poles included, and
  ``n_lon`` longitudes from 0°; node ``i · n_lon + j`` is latitude row
  ``i``, longitude column ``j``.
* Multimesh: the refinement-``L`` icosphere's vertices with the edges of
  every level 0..L (:func:`~gwen_tpu_torch.graph.build.icosphere_multilevel_edges`).
* Grid2mesh: an edge from each grid node to every mesh node whose chord
  distance is at most ``radius_factor`` × the longest level-``L`` edge.
* Mesh2grid: each grid node receives from the 3 vertices of the level-``L``
  triangle that contains it (the triangle its ray from the centre
  crosses), found by descending the refinement from the 20 faces of the
  icosahedron.

Edge features: the length of the sender − receiver position difference
and its 3 components in the receiver's local frame (the rotation that
takes the receiver to latitude 0, longitude 0), all divided by the longest
edge of the set. Mesh node features: cos latitude, sin longitude, cos
longitude. Every edge list is in its natural order: sorted by receiver,
then sender; each graph carries the segment tables that the edge sums walk
(each receiver's span of the edges, the edges in sender order and each
sender's span of that).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from gwen_tpu_torch.graph.build import (
    icosahedron,
    icosphere_multilevel_edges,
    refine_triangulation,
)

Tensor = torch.Tensor
# Points of the grid handled a pass by the containing-triangle descent.
_DESCENT_CHUNK = 1 << 17
# A point whose barycentric coordinates in a face are all ≥ −TIE lies in
# it (on an edge or a vertex, in several faces).
TIE = 1e-9


@dataclass
class BipartiteGraph:
    """COO edges from one node set to another (the same set for the
    multimesh): ``senders`` index the sender set, ``receivers`` the
    receiver set, both int32 and sorted by receiver; ``edge_features`` is
    ``(E, 4)`` float32. The segment tables of the edge sums, int32:
    ``receiver_offsets`` ``(num_receivers + 1,)``, where receiver ``r``'s
    edges are ``receiver_offsets[r]:receiver_offsets[r + 1]``;
    ``sender_order`` ``(E,)``, the edges in sender order (a stable sort),
    and ``sender_offsets`` ``(num_senders + 1,)``, each sender's span of
    it. :meth:`from_edges` builds them."""

    senders: Tensor
    receivers: Tensor
    num_senders: int
    num_receivers: int
    edge_features: Tensor
    receiver_offsets: Tensor
    sender_order: Tensor
    sender_offsets: Tensor

    @classmethod
    def from_edges(cls, senders: np.ndarray, receivers: np.ndarray, num_senders: int,
                   num_receivers: int, edge_features: np.ndarray) -> "BipartiteGraph":
        """The graph of edges sorted by receiver, with its segment tables."""
        if np.any(np.diff(receivers) < 0):
            raise ValueError("the edges must be sorted by receiver")

        def table(a: np.ndarray) -> Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

        return cls(table(senders), table(receivers), num_senders, num_receivers,
                   torch.from_numpy(edge_features),
                   table(segment_offsets(receivers, num_receivers)),
                   table(np.argsort(senders, kind="stable")),
                   table(segment_offsets(senders, num_senders)))

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    def to(self, device) -> "BipartiteGraph":
        return replace(self, **{k: getattr(self, k).to(device) for k in (
            "senders", "receivers", "edge_features", "receiver_offsets",
            "sender_order", "sender_offsets")})


def segment_offsets(index: np.ndarray, n: int) -> np.ndarray:
    """``(n + 1,)``: where each of ``n`` segments starts among the entries
    of ``index`` in sorted order, and the end (a segment with no entry
    starts where the next does)."""
    return np.concatenate([[0], np.cumsum(np.bincount(index, minlength=n))])


@dataclass
class GraphCastGraphs:
    """The three graphs and the mesh node features, the context a
    GraphCast model and its trainer take."""

    grid2mesh: BipartiteGraph
    mesh: BipartiteGraph
    mesh2grid: BipartiteGraph
    mesh_features: Tensor
    grid_shape: tuple[int, int]

    @property
    def num_grid(self) -> int:
        return self.grid_shape[0] * self.grid_shape[1]

    @property
    def num_mesh(self) -> int:
        return int(self.mesh_features.shape[0])

    def to(self, device) -> "GraphCastGraphs":
        return replace(self, grid2mesh=self.grid2mesh.to(device),
                       mesh=self.mesh.to(device),
                       mesh2grid=self.mesh2grid.to(device),
                       mesh_features=self.mesh_features.to(device))


def lat_lon_to_xyz(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Unit vectors ``(..., 3)`` of latitudes and longitudes in radians."""
    c = np.cos(lat)
    return np.stack([c * np.cos(lon), c * np.sin(lon), np.sin(lat)], axis=-1)


def xyz_to_lat_lon(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Latitudes and longitudes in radians of unit vectors ``(..., 3)``."""
    lat = np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0))
    lon = np.arctan2(xyz[..., 1], xyz[..., 0])
    return lat, lon


def grid_lat_lon(n_lat: int, n_lon: int) -> tuple[np.ndarray, np.ndarray]:
    """The grid's latitudes and longitudes in degrees."""
    return np.linspace(-90.0, 90.0, n_lat), np.arange(n_lon) * (360.0 / n_lon)


def grid_xyz(n_lat: int, n_lon: int) -> np.ndarray:
    """``(n_lat · n_lon, 3)`` positions of the grid nodes."""
    lat, lon = grid_lat_lon(n_lat, n_lon)
    la, lo = np.meshgrid(np.deg2rad(lat), np.deg2rad(lon), indexing="ij")
    return lat_lon_to_xyz(la, lo).reshape(-1, 3)


def icosphere_faces(levels: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """The level-``levels`` vertices and the faces of every level
    0..levels. Face ``f`` of level ``l`` (of ``F`` faces) has children
    ``f``, ``F + f``, ``2F + f`` and ``3F + f`` at level ``l + 1``."""
    verts, faces = icosahedron()
    out = [faces]
    for _ in range(levels):
        verts, faces = refine_triangulation(verts, faces, 1)
        out.append(faces)
    return verts, out


def multimesh(levels: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(verts, senders, receivers)`` of the multimesh M0..M``levels``,
    sorted by receiver, then sender."""
    verts, s, r, _ = icosphere_multilevel_edges(levels)
    order = np.lexsort((s, r))
    return verts, s[order], r[order]


def max_edge_length(verts: np.ndarray, faces: np.ndarray) -> float:
    """The longest chord of a triangulation's edges."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return float(np.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], axis=1).max())


def grid2mesh_edges(n_lat: int, n_lon: int, mesh_xyz: np.ndarray,
                    radius: float) -> tuple[np.ndarray, np.ndarray]:
    """``(grid senders, mesh receivers)`` of every pair at chord distance at
    most ``radius``, sorted by receiver, then sender. Each mesh node tests
    the grid rows within the radius's angle of its latitude, and in each
    row the longitudes within reach (the whole row near a pole)."""
    lat_deg, _ = grid_lat_lon(n_lat, n_lon)
    lat = np.deg2rad(lat_deg)
    dlat, dlon = np.pi / (n_lat - 1), 2 * np.pi / n_lon
    ang = 2 * np.arcsin(min(radius / 2, 1.0)) + 1e-9
    m_lat, m_lon = xyz_to_lat_lon(mesh_xyz)
    m_lon = np.mod(m_lon, 2 * np.pi)
    lo = np.clip(np.ceil((m_lat - ang + np.pi / 2) / dlat - 1e-9), 0, n_lat - 1).astype(np.int64)
    hi = np.clip(np.floor((m_lat + ang + np.pi / 2) / dlat + 1e-9), 0, n_lat - 1).astype(np.int64)
    rows_per = hi - lo + 1
    mesh_of_row = np.repeat(np.arange(len(mesh_xyz)), rows_per)
    row = (np.arange(rows_per.sum()) - np.repeat(np.cumsum(rows_per) - rows_per, rows_per)
           + np.repeat(lo, rows_per))
    # The largest longitude gap at which a point of the row lies within reach.
    p1, p2 = m_lat[mesh_of_row], lat[row]
    with np.errstate(divide="ignore", invalid="ignore"):
        cos_gap = (np.cos(ang) - np.sin(p1) * np.sin(p2)) / (np.cos(p1) * np.cos(p2))
    gap = np.where(cos_gap <= -1, np.pi, np.arccos(np.clip(cos_gap, -1.0, 1.0)))
    gap = np.where(np.isfinite(cos_gap), gap, np.pi)
    c_lo = np.ceil((m_lon[mesh_of_row] - gap) / dlon - 1e-9).astype(np.int64)
    c_hi = np.floor((m_lon[mesh_of_row] + gap) / dlon + 1e-9).astype(np.int64)
    cols_per = np.clip(c_hi - c_lo + 1, 0, n_lon)
    cols_per = np.where(gap >= np.pi, n_lon, cols_per)
    c_lo = np.where(cols_per == n_lon, 0, c_lo)
    pair = np.repeat(np.arange(len(row)), cols_per)
    col = (np.arange(cols_per.sum()) - np.repeat(np.cumsum(cols_per) - cols_per, cols_per)
           + c_lo[pair]) % n_lon
    grid = row[pair] * n_lon + col
    mesh = mesh_of_row[pair]
    g_xyz = grid_xyz(n_lat, n_lon)
    d2 = ((g_xyz[grid] - mesh_xyz[mesh]) ** 2).sum(axis=1)
    keep = d2 <= radius * radius
    s, r = grid[keep], mesh[keep]
    order = np.lexsort((s, r))
    return s[order], r[order]


def _barycentric_planes(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """``(F, 3, 3)``: planes whose dot products with a point are its
    barycentric coordinates in the face's vertices (``(b × c) / det`` and
    its turns), so the coordinates of the ray through the point where it
    crosses the face's plane; all ≥ 0 inside the face."""
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    det = np.einsum("ij,ij->i", np.cross(a, b), c)[:, None, None]
    return np.stack([np.cross(b, c), np.cross(c, a), np.cross(a, b)], axis=1) / det


def face_keys(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Each face's sorted vertex numbers as one int64, ``(v0 · n + v1) · n
    + v2``: the order in which faces that share a point give way."""
    v = np.sort(faces, axis=1).astype(np.int64)
    return (v[:, 0] * num_verts + v[:, 1]) * num_verts + v[:, 2]


def containing_faces(points: np.ndarray, verts: np.ndarray,
                     faces: list[np.ndarray]) -> np.ndarray:
    """The index of the finest-level face that contains each point, by
    descent through the levels of :func:`icosphere_faces` (at each level
    the child whose smallest barycentric coordinate is largest). A point
    within ``TIE`` of an edge or a vertex lies in several faces: it takes
    the face, among those around its face's vertices whose coordinates
    are all ≥ −``TIE``, whose sorted vertex numbers come first."""
    out = np.empty(len(points), np.int64)
    planes = [_barycentric_planes(verts, f) for f in faces]
    for lo in range(0, len(points), _DESCENT_CHUNK):
        p = points[lo:lo + _DESCENT_CHUNK]
        face = np.einsum("pk,fek->pfe", p, planes[0]).min(axis=2).argmax(axis=1)
        for lv in range(1, len(faces)):
            kids = face[:, None] + len(faces[lv - 1]) * np.arange(4)[None, :]
            coords = np.einsum("pk,pcek->pce", p, planes[lv][kids]).min(axis=2)
            face = kids[np.arange(len(p)), coords.argmax(axis=1)]
        out[lo:lo + _DESCENT_CHUNK] = face
    fine = faces[-1]
    edge = np.einsum("pk,pek->pe", points, planes[-1][out]).min(axis=1) <= TIE
    if edge.any():
        # The faces around each vertex (5 or 6), padded with the first.
        owner = np.argsort(fine.ravel(), kind="stable") // 3
        count = np.bincount(fine.ravel(), minlength=len(verts))
        start = np.cumsum(count) - count
        ring = owner[start[:, None] + np.minimum(np.arange(6)[None, :], count[:, None] - 1)]
        cand = ring[fine[out[edge]]].reshape(-1, 18)
        coords = np.einsum("pk,pcek->pce", points[edge], planes[-1][cand]).min(axis=2)
        key = np.where(coords >= -TIE, face_keys(fine, len(verts))[cand], np.iinfo(np.int64).max)
        out[edge] = cand[np.arange(len(cand)), key.argmin(axis=1)]
    return out


def mesh2grid_edges(n_lat: int, n_lon: int, verts: np.ndarray,
                    faces: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """``(mesh senders, grid receivers)``: 3 edges to each grid node from
    the vertices of its containing finest-level face, sorted by receiver,
    then sender."""
    face = containing_faces(grid_xyz(n_lat, n_lon), verts, faces)
    s = np.sort(faces[-1][face], axis=1).reshape(-1)
    r = np.repeat(np.arange(n_lat * n_lon), 3)
    return s, r


def edge_features(sender_xyz: np.ndarray, receiver_xyz: np.ndarray
                  ) -> np.ndarray:
    """``(E, 4)`` float32: ``[|d|, d]`` over the set's largest ``|d|``, with
    ``d`` the sender − receiver difference rotated into the receiver's
    local frame (``R_y(lat) · R_z(−lon)``)."""
    lat, lon = xyz_to_lat_lon(receiver_xyz)
    d = sender_xyz - receiver_xyz
    cl, sl = np.cos(lon), np.sin(lon)
    x1 = cl * d[:, 0] + sl * d[:, 1]
    y1 = -sl * d[:, 0] + cl * d[:, 1]
    cp, sp = np.cos(lat), np.sin(lat)
    x2 = cp * x1 + sp * d[:, 2]
    z2 = -sp * x1 + cp * d[:, 2]
    rel = np.stack([x2, y1, z2], axis=1)
    length = np.linalg.norm(rel, axis=1, keepdims=True)
    return (np.concatenate([length, rel], axis=1) / length.max()).astype(np.float32)


def mesh_node_features(verts: np.ndarray) -> np.ndarray:
    """``(M, 3)`` float32: cos latitude, sin longitude, cos longitude."""
    lat, lon = xyz_to_lat_lon(verts)
    return np.stack([np.cos(lat), np.sin(lon), np.cos(lon)], axis=1).astype(np.float32)


def _bipartite(s: np.ndarray, r: np.ndarray, s_xyz: np.ndarray,
               r_xyz: np.ndarray) -> BipartiteGraph:
    return BipartiteGraph.from_edges(s, r, len(s_xyz), len(r_xyz),
                                     edge_features(s_xyz[s], r_xyz[r]))


def build_graphcast_graphs(n_lat: int = 721, n_lon: int = 1440,
                           refine: int = 6, radius_factor: float = 0.6
                           ) -> GraphCastGraphs:
    """GraphCast's graphs at ``n_lat × n_lon`` on the multimesh
    M0..M``refine`` (the published model: 721 × 1440, M6, 0.6)."""
    verts, faces = icosphere_faces(refine)
    gxyz = grid_xyz(n_lat, n_lon)
    _, ms, mr = multimesh(refine)
    radius = radius_factor * max_edge_length(verts, faces[-1])
    gs, gr = grid2mesh_edges(n_lat, n_lon, verts, radius)
    ds, dr = mesh2grid_edges(n_lat, n_lon, verts, faces)
    return GraphCastGraphs(
        grid2mesh=_bipartite(gs, gr, gxyz, verts),
        mesh=_bipartite(ms, mr, verts, verts),
        mesh2grid=_bipartite(ds, dr, verts, gxyz),
        mesh_features=torch.from_numpy(mesh_node_features(verts)),
        grid_shape=(n_lat, n_lon))
