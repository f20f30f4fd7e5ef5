"""The plain reference's mesh: the refined icosahedron, its GCN weights and,
for windowed attention, the set of edges each node attends over.

Numpy only, and nothing of the program: the benchmark's reference works
out again what the program derives from the level and the window (the
node order, the window starts, the escape set), by the rules the program
documents:

* the icosahedron refined ``level`` times (ICON-style: each triangle into
  four, midpoints projected to the sphere), undirected triangle edges in
  both directions;
* symmetric GCN weights with self loops, ``w = 1 / sqrt(d̂(s) d̂(r))`` with
  ``d̂ = degree + 1``;
* the KD-patch order: recursive coordinate bisection into leaves of at
  most 8,192 nodes, reverse Cuthill-McKee inside each leaf;
* the diagonal window of the attention processor: destination blocks of
  ``block`` rows, window starts ``clip(b·block − c, 0, src − W)`` for the
  one offset ``c`` (of a few block-aligned candidates) with the fewest
  out-of-window edges; an edge whose either direction leaves its window
  is an escape, and attention runs over the other edges only.

Node ids are the icosphere's own ("natural") order; the KD order only
decides which edges are in a window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

LEAF_SIZE = 8192


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
         [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
         [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
        dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64)
    return verts, faces


def icosphere(level: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(verts, senders, receivers)``: 10·4^level + 2 nodes, each
    undirected edge in both directions, no self loops."""
    verts, faces = icosahedron()
    for _ in range(level):
        nf = len(faces)
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid = len(verts) + np.arange(len(uniq), dtype=np.int64)
        ab, bc, ca = mid[inv[:nf]], mid[inv[nf:2 * nf]], mid[inv[2 * nf:]]
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        faces = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                                np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
        verts = np.concatenate([verts, mids])
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    return (verts, np.concatenate([e[:, 0], e[:, 1]]),
            np.concatenate([e[:, 1], e[:, 0]]))


def gcn_edges(s: np.ndarray, r: np.ndarray, n: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The edges with self loops appended and their symmetric GCN weights
    (float64)."""
    deg = np.bincount(r, minlength=n).astype(np.float64) + 1.0
    a = 1.0 / np.sqrt(deg)
    loops = np.arange(n, dtype=np.int64)
    s = np.concatenate([s, loops])
    r = np.concatenate([r, loops])
    return s, r, a[s] * a[r]


def rcm(s: np.ndarray, r: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee: new node ``i`` is old node ``perm[i]``. Seeds
    by ascending degree, neighbours visited by ascending degree (stable)."""
    ss = np.concatenate([s, r])
    rr = np.concatenate([r, s])
    order = np.argsort(ss, kind="stable")
    ss, rr = ss[order], rr[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(ss, minlength=n), out=indptr[1:])
    degree = np.diff(indptr)
    visited = np.zeros(n, bool)
    out = np.empty(n, np.int64)
    pos = 0
    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        out[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = out[head]
            head += 1
            nb = rr[indptr[u]:indptr[u + 1]]
            nb = nb[~visited[nb]]
            if nb.size:
                nb = np.unique(nb)
                nb = nb[np.argsort(degree[nb], kind="stable")]
                visited[nb] = True
                out[pos:pos + nb.size] = nb
                pos += nb.size
    return out[::-1].copy()


def kd_patch_order(verts: np.ndarray, s: np.ndarray, r: np.ndarray
                   ) -> np.ndarray:
    """Recursive coordinate bisection (widest axis, lower half first) into
    leaves of at most ``LEAF_SIZE`` nodes, RCM inside each leaf."""
    n = verts.shape[0]
    stack, leaves = [np.arange(n)], []
    while stack:
        idx = stack.pop()
        if idx.size <= LEAF_SIZE:
            leaves.append(idx)
            continue
        pts = verts[idx]
        dim = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        half = idx.size // 2
        part = np.argpartition(pts[:, dim], half)
        stack.append(idx[part[half:]])
        stack.append(idx[part[:half]])
    leaf = np.empty(n, np.int64)
    for i, ids in enumerate(leaves):
        leaf[ids] = i
    local = np.full(n, -1, np.int64)
    parts = []
    for i, ids in enumerate(leaves):
        inside = (leaf[s] == i) & (leaf[r] == i)
        local[ids] = np.arange(ids.size)
        parts.append(ids[rcm(local[s[inside]], local[r[inside]], ids.size)])
    return np.concatenate(parts)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def in_window(s: np.ndarray, r: np.ndarray, n: int, window: int, block: int,
              superblock: int) -> np.ndarray:
    """Which edges of ``(s, r)`` (self loops included, nodes already in
    locality order) lie in their destination block's diagonal window,
    both directions of an edge together."""
    w = _round_up(_round_up(window, 128), block)
    src = _round_up(max(n, 1), block)
    w = min(w, src)
    sb = max(superblock, 1)
    while w + (sb - 1) * block > src and sb > 1:
        sb -= 1
    blocks = _round_up(max(n, 1), block * sb) // block
    blk = r // block
    # The densest block-aligned window start of each destination block,
    # made nondecreasing.
    order = np.lexsort((s, blk))
    so, bo = s[order], blk[order]
    bounds = np.zeros(blocks + 1, np.int64)
    np.cumsum(np.bincount(bo, minlength=blocks), out=bounds[1:])
    dense = np.zeros(blocks, np.int64)
    for b in range(blocks):
        lo, hi = bounds[b], bounds[b + 1]
        if hi == lo:
            continue
        srcs = so[lo:hi]
        cand = np.unique(srcs // block) * block
        cov = (np.searchsorted(srcs, cand + w, side="left")
               - np.searchsorted(srcs, cand, side="left"))
        dense[b] = cand[int(np.argmax(cov))]
    dense = np.maximum.accumulate(dense)
    diag = np.arange(blocks, dtype=np.int64) * block
    cands = np.unique(np.clip(
        (np.percentile(diag - dense, [10, 25, 50, 75, 90]) // block) * block,
        0, w - block).astype(np.int64))
    best, best_out = 0, None
    for c in cands:
        ws = np.clip(diag - c, 0, max(src - w, 0))
        out = int(((s < ws[blk]) | (s >= ws[blk] + w)).sum())
        if best_out is None or out < best_out:
            best, best_out = int(c), out
    ws = np.clip(diag - best, 0, max(src - w, 0))
    out = (s < ws[blk]) | (s >= ws[blk] + w)
    key = np.minimum(s, r) * np.int64(n) + np.maximum(s, r)
    uniq, inv = np.unique(key, return_inverse=True)
    esc = np.zeros(uniq.size, bool)
    np.logical_or.at(esc, inv, out)
    return ~esc[inv]


@dataclass
class Mesh:
    """The reference's mesh in natural node order: edges with self loops,
    their GCN weights, and the attention edges (``None`` for GCN)."""

    num_nodes: int
    senders: np.ndarray
    receivers: np.ndarray
    weights: np.ndarray
    attn_senders: Optional[np.ndarray] = None
    attn_receivers: Optional[np.ndarray] = None


def build_mesh(graph_cfg: dict, attention: bool) -> Mesh:
    """The mesh the configuration's ``graph`` section states."""
    verts, s, r = icosphere(graph_cfg["refine"])
    n = verts.shape[0]
    s, r, w = gcn_edges(s, r, n)
    mesh = Mesh(n, s, r, w)
    if attention:
        perm = kd_patch_order(verts, s[s != r], r[s != r])
        rank = np.empty(n, np.int64)
        rank[perm] = np.arange(n)
        keep = in_window(rank[s], rank[r], n, graph_cfg["diag_window"],
                         graph_cfg["block"], graph_cfg["superblock"])
        mesh.attn_senders, mesh.attn_receivers = s[keep], r[keep]
    return mesh
