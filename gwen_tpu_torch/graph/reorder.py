"""Bandwidth-reducing node orderings (host-side, numpy only).

The window SpMM kernel streams a contiguous *window* of source rows per
128-row destination block (``gwen_tpu_torch.graph.graph.DiagWindowGraph``),
so graph bandwidth — max |i - j| over edges (i, j) — directly sets the
kernel's device-memory traffic. Reverse Cuthill-McKee brings mesh graphs
close to their minimal bandwidth.

A copy of ``gwen_tpu.graph.reorder``: both packages must produce the same
permutations, so the port's graphs match the reference's node for node.
"""

from __future__ import annotations

import numpy as np


def _csr(senders: np.ndarray, receivers: np.ndarray, num_nodes: int):
    """Undirected CSR adjacency (degree-sorted neighbor lists not required)."""
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    order = np.argsort(s, kind="stable")
    s, r = s[order], r[order]
    counts = np.bincount(s, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, r


def rcm_order(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int, native: bool = True
) -> np.ndarray:
    """Reverse Cuthill-McKee permutation. Returns ``perm`` such that new node
    ``i`` is old node ``perm[i]``.

    Uses the C++ implementation (``gwen_tpu_torch.native``) when available —
    minutes → sub-second at ICON-mesh scale; this Python version is the
    fallback and the reference for tests."""
    if native:
        from gwen_tpu_torch import native as _native

        perm = _native.rcm_order(np.asarray(senders), np.asarray(receivers), num_nodes)
        if perm is not None:
            return perm
    indptr, indices = _csr(np.asarray(senders), np.asarray(receivers), num_nodes)
    degree = np.diff(indptr)
    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    pos = 0
    # Process components from lowest-degree unvisited seed (standard CM).
    seeds = np.argsort(degree, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos : pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()


def apply_order(
    perm: np.ndarray, senders: np.ndarray, receivers: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Relabel an edge list under ``perm`` (new i = old perm[i]).

    Returns (new_senders, new_receivers, inverse_perm); node data arrays are
    reordered as ``data[perm]`` and results mapped back with ``inverse_perm``.
    """
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv[np.asarray(senders)], inv[np.asarray(receivers)], inv


def bandwidth(senders: np.ndarray, receivers: np.ndarray) -> int:
    """Graph bandwidth max|s - r| (0 for an empty edge list)."""
    if np.asarray(senders).size == 0:
        return 0
    return int(np.abs(np.asarray(senders) - np.asarray(receivers)).max())


def kd_patch_order(
    verts: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    leaf_size: int = 8192,
) -> np.ndarray:
    """Geometric patch ordering: recursive coordinate bisection into leaves of
    ``<= leaf_size`` nodes, then RCM *within* each leaf's induced subgraph.

    RCM alone is near-optimal for *full* window coverage, but its window is
    the global band (the sphere's equator circumference, ~2.3-2.6 kB rows at
    ICON L8). This ordering trades a small escape set for a much smaller
    window: intra-leaf edges fit a window the size of the leaf's own RCM band
    (measured ~384 rows for 8k-node icosphere leaves at every level L7-L9),
    and the ~2 % of edges that cross leaves go to the sliding layout's
    escape-fixup path (``to_sliding_dense(window_size=...)``). Net effect at
    L8: 7.7x fewer S bytes and matmul flops than the RCM full window.

    Returns ``perm`` with the :func:`rcm_order` convention (new node ``i`` is
    old node ``perm[i]``).
    """
    verts = np.asarray(verts)
    s = np.asarray(senders)
    r = np.asarray(receivers)
    if verts.shape[0] != num_nodes:
        raise ValueError(f"verts has {verts.shape[0]} rows, expected {num_nodes}")
    # Iterative recursive bisection (DFS order keeps sibling leaves adjacent,
    # so many cross-leaf edges still land inside the sliding window).
    stack = [np.arange(num_nodes)]
    leaves: list[np.ndarray] = []
    while stack:
        idx = stack.pop()
        if idx.size <= leaf_size:
            leaves.append(idx)
            continue
        pts = verts[idx]
        dim = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        half = idx.size // 2
        part = np.argpartition(pts[:, dim], half)
        stack.append(idx[part[half:]])  # right pushed first → left pops first
        stack.append(idx[part[:half]])

    leaf_of = np.empty(num_nodes, np.int64)
    for li, ids in enumerate(leaves):
        leaf_of[ids] = li
    intra = leaf_of[s] == leaf_of[r]
    si, ri = s[intra], r[intra]
    sl = leaf_of[si]
    # Group intra-leaf edges by leaf once (avoids an O(leaves * E) scan).
    eorder = np.argsort(sl, kind="stable")
    si, ri, sl = si[eorder], ri[eorder], sl[eorder]
    counts = np.bincount(sl, minlength=len(leaves))
    bounds = np.zeros(len(leaves) + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])

    parts = []
    g2l = np.full(num_nodes, -1, np.int64)
    for li, ids in enumerate(leaves):
        lo, hi = bounds[li], bounds[li + 1]
        g2l[ids] = np.arange(ids.size)
        lperm = rcm_order(g2l[si[lo:hi]], g2l[ri[lo:hi]], ids.size)
        parts.append(ids[lperm])
    return np.concatenate(parts) if parts else np.arange(num_nodes)
