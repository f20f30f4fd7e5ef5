"""Graph containers and the layouts the serving path aggregates over.

Counterpart of ``gwen_tpu.graph.graph``, cut to what
``to_diag_window(packed=False)`` needs. Everything is built on the host with
numpy (the same code as the reference, so both packages agree edge for
edge), then held as plain dataclasses of torch tensors; ``.to(device)``
moves a container and everything inside it.

The port keeps the math and drops the TPU's layout workarounds:

* :class:`SlidingDenseGraph` stores S *window-relative*, ``(N_pad, W)``
  with one start per 128-row block, instead of the reference's ring-buffer
  columns (a VMEM workaround);
* :class:`DiagWindowGraph` stores one window start per block instead of
  ``xbase``/``offsets`` (a superblock DMA workaround), and places escape rows
  with per-block ranges (``esc_ptr``) into the receiver-sorted fix array
  instead of the one-hot ``esc_start``/``esc_lrow`` tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _to(obj, device):
    """Copy of a container with every tensor (and nested container) on
    ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


@dataclass(frozen=True)
class Graph:
    """COO graph, padded to a multiple of ``edge_pad_multiple`` edges.

    ``out[receivers[e]] += weights[e] * x[senders[e]]`` defines aggregation.
    Padding edges have ``weights == 0`` and point at node 0.
    """

    senders: Tensor  # (E_pad,) int64
    receivers: Tensor  # (E_pad,) int64
    weights: Tensor  # (E_pad,) float32, 0 on padding
    num_nodes: int
    num_edges: int

    def to(self, device) -> "Graph":
        return _to(self, device)

    def host_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The real (unpadded) edges as numpy ``(senders, receivers,
        weights)``."""
        e = self.num_edges
        return (self.senders[:e].cpu().numpy().astype(np.int64),
                self.receivers[:e].cpu().numpy().astype(np.int64),
                self.weights[:e].cpu().numpy().astype(np.float32))


@dataclass(frozen=True)
class EscapeFixup:
    """Out-of-window edges of a windowed layout.

    ``senders``/``receivers``/``weights`` hold the receiver-sorted COO list.
    ``nbr``/``w`` are ELL lists over the U unique receivers (``rows``, sorted
    ascending): the fix row of receiver ``rows[u]`` is
    ``Σ_d w[u, d] · x[nbr[u, d]]``. Padding slots repeat the row's first
    sender with weight 0. The set is symmetric (built so), so the operator
    equals its transpose.
    """

    senders: Tensor  # (E_esc,) int64
    receivers: Tensor  # (E_esc,) int64
    weights: Tensor  # (E_esc,) float32
    nbr: Tensor  # (U, deg) int64
    w: Tensor  # (U, deg) float32
    rows: Tensor  # (U,) int64, strictly increasing destination rows
    num_edges: int

    def to(self, device) -> "EscapeFixup":
        return _to(self, device)


@dataclass(frozen=True)
class SlidingDenseGraph:
    """Banded layout with one window start per destination block.

    Block ``b`` (rows ``[b·block, (b+1)·block)``) reads source rows
    ``[window_start[b], window_start[b] + window_size)``;
    ``s_mat[b·block + r, c]`` is the weight of source row
    ``window_start[b] + c``. Starts are block-aligned and nondecreasing.
    """

    s_mat: Tensor  # (N_pad, W) window-relative
    window_start: Tensor  # (num_blocks,) int32
    num_nodes: int
    num_edges: int
    block_size: int
    window_size: int
    num_src_rows: int
    escape: Optional[EscapeFixup] = None

    @property
    def num_padded_nodes(self) -> int:
        return int(self.s_mat.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.window_start.shape[0])

    def to(self, device) -> "SlidingDenseGraph":
        return _to(self, device)


@dataclass(frozen=True)
class DiagWindowGraph:
    """Diagonal-window layout (the serving path's aggregation operator).

    Window starts are implicitly diagonal — ``ws[b] = clip(b·block − c, 0,
    src − W)`` for one global offset ``c`` chosen to minimise escapes — and
    S is window-relative, ``(N_pad, W)``. Out-of-window edges go to
    ``escape``; the escape fix rows of block ``b`` are the contiguous range
    ``[esc_ptr[b], esc_ptr[b + 1])`` of the receiver-sorted fix array.

    With many unique escape receivers (``esc2_graph`` set) the fix array
    is computed by the hierarchical contraction: gather ``x[esc2_src]``, a
    banded SpMM over the RCM-ordered escape graph, and a gather
    ``[esc2_back]`` back to receiver order.

    The transpose tables (:func:`diag_transpose_tables`, ``t_max > 0``)
    are what windowed attention needs. ``t_lo``/``t_cnt``/``t_max`` are
    the reference's: the destination blocks whose windows cover source
    block ``c`` are ``[t_lo[c], t_lo[c] + t_cnt[c])``. The attention
    kernels read the mask ``s_mat != 0`` as neighbour lists instead:
    ``attn_nbr[i]`` holds the absolute source rows of destination row
    ``i`` in ascending order, ``attn_nbr_t[c]`` the destination rows whose
    mask holds source row ``c``, both padded with -1.
    """

    s_mat: Tensor  # (N_pad, W) window-relative
    window_start: Tensor  # (num_blocks,) int32
    num_nodes: int
    num_edges: int
    block_size: int
    window_size: int
    superblock: int
    num_src_rows: int
    escape: Optional[EscapeFixup] = None
    esc_ptr: Optional[Tensor] = None  # (num_blocks + 1,) int32
    esc2_graph: Optional[SlidingDenseGraph] = None
    esc2_src: Optional[Tensor] = None  # (U,) int64, node row per c2 row
    esc2_back: Optional[Tensor] = None  # (U,) int64, c2 row per fix row
    t_lo: Optional[Tensor] = None  # (num_src_rows // block,) int32
    t_cnt: Optional[Tensor] = None  # (num_src_rows // block,) int32
    t_max: int = 0
    attn_nbr: Optional[Tensor] = None  # (N_pad, D) int32, -1 padded
    attn_nbr_t: Optional[Tensor] = None  # (num_src_rows, D_t) int32

    @property
    def num_padded_nodes(self) -> int:
        return int(self.s_mat.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.window_start.shape[0])

    def to(self, device) -> "DiagWindowGraph":
        return _to(self, device)


# ------------------------------------------------------------------ builders


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gcn_normalize(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    self_loops: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric GCN normalization, computed host-side.

    With self loops, ``w_e = 1/sqrt(d̂(s) d̂(r))`` where ``d̂(i) = deg(i) + 1``
    and the appended self-loop edge ``(i, i)`` gets ``1/d̂(i)``. Returns the
    possibly-extended ``(senders, receivers, weights)`` arrays.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    if self_loops:
        deg = deg + 1.0
    inv_sqrt = np.zeros_like(deg)
    nz = deg > 0
    inv_sqrt[nz] = 1.0 / np.sqrt(deg[nz])
    weights = inv_sqrt[senders] * inv_sqrt[receivers]
    if self_loops:
        loops = np.arange(num_nodes, dtype=np.int64)
        senders = np.concatenate([senders, loops])
        receivers = np.concatenate([receivers, loops])
        weights = np.concatenate([weights, inv_sqrt[loops] ** 2])
    return senders, receivers, weights.astype(np.float32)


def build_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    self_loops: bool = True,
    normalize: bool = True,
    weights: Optional[np.ndarray] = None,
    edge_pad_multiple: int = 512,
) -> Graph:
    """Build a padded COO :class:`Graph` (on the CPU) from host edge
    arrays."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if senders.shape != receivers.shape:
        raise ValueError("senders/receivers must have matching shapes")
    if senders.size and (senders.max() >= num_nodes or receivers.max() >= num_nodes):
        raise ValueError("edge index out of range")
    if normalize:
        if weights is not None:
            raise ValueError("pass either normalize=True or explicit weights")
        senders, receivers, w = gcn_normalize(senders, receivers, num_nodes, self_loops)
    else:
        w = (
            np.ones(senders.shape[0], np.float32)
            if weights is None
            else np.asarray(weights, np.float32)
        )
    e = senders.shape[0]
    e_pad = max(_round_up(e, edge_pad_multiple), edge_pad_multiple)
    s = np.zeros(e_pad, np.int64)
    r = np.zeros(e_pad, np.int64)
    ww = np.zeros(e_pad, np.float32)
    s[:e] = senders
    r[:e] = receivers
    ww[:e] = w
    return Graph(
        senders=torch.from_numpy(s),
        receivers=torch.from_numpy(r),
        weights=torch.from_numpy(ww),
        num_nodes=int(num_nodes),
        num_edges=int(e),
    )


def ell_tables(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_dst: int,
    num_src: int,
    *,
    block_size: int = 128,
    window_size: Optional[int] = None,
    lane_multiple: int = 8,
    max_degree: Optional[int] = None,
    forced_window_start: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Build blocked-ELL tables from COO (host-side, as the reference).

    Returns ``(nbr_rel, nbr_weight, window_start, window_size, src_rows)``
    where ``nbr_rel`` indices are relative to each destination block's
    block-aligned source window and ``src_rows`` is the padded source-row
    count every window stays within. ``forced_window_start`` (block-aligned,
    one per destination block) overrides the per-block min-source placement;
    every edge must then fit ``[start, start + window_size)``.
    """
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    w = np.asarray(weights, np.float32)
    e = s.shape[0]

    n_pad = _round_up(max(num_dst, 1), block_size)
    src_pad = _round_up(max(num_src, 1), block_size)
    order = np.argsort(r, kind="stable")
    s, r, w = s[order], r[order], w[order]
    counts = np.bincount(r, minlength=n_pad)
    deg = int(counts.max()) if e else 1
    deg = max(_round_up(deg, lane_multiple), lane_multiple)
    if max_degree is not None:
        if deg > max_degree:
            raise ValueError(f"max degree {deg} exceeds requested {max_degree}")
        deg = max_degree

    nbr = np.zeros((n_pad, deg), np.int32)
    nbr_w = np.zeros((n_pad, deg), np.float32)
    starts = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(e) - starts[r]
    nbr[r, slot] = s
    nbr_w[r, slot] = w

    num_blocks = n_pad // block_size
    blk = r // block_size
    if forced_window_start is not None:
        lo = np.asarray(forced_window_start, np.int64)
        if lo.shape != (num_blocks,):
            raise ValueError(
                f"forced_window_start has shape {lo.shape}, "
                f"expected ({num_blocks},)"
            )
        if (lo % block_size).any():
            raise ValueError("forced_window_start must be block-aligned")
        if window_size is None:
            raise ValueError("forced_window_start requires window_size")
        rel_chk = s - lo[blk]
        if e and (rel_chk.min() < 0 or rel_chk.max() >= int(window_size)):
            raise ValueError(
                "edges escape the forced windows; split escapes first"
            )
        max_span = int(rel_chk.max()) + 1 if e else 1
    else:
        lo = np.full(num_blocks, src_pad, np.int64)
        hi = np.zeros(num_blocks, np.int64)
        np.minimum.at(lo, blk, s)
        np.maximum.at(hi, blk, s + 1)
        empty = lo > hi
        lo[empty], hi[empty] = 0, 1
        lo = (lo // block_size) * block_size
        spans = hi - lo
        max_span = int(spans.max()) if num_blocks else 1
    if window_size is None:
        window_size = max(_round_up(max_span, block_size), block_size)
    window_size = _round_up(int(window_size), block_size)
    window_size = min(window_size, src_pad)
    if max_span > window_size:
        raise ValueError(
            f"graph bandwidth {max_span} exceeds window_size {window_size}; "
            "apply rcm_order() first or increase window_size"
        )
    win_start = np.minimum(lo, src_pad - window_size)
    win_start = np.maximum(win_start, 0).astype(np.int32)
    nbr_rel = nbr - win_start.repeat(block_size)[:, None]
    nbr_rel = np.where(nbr_w != 0, nbr_rel, 0).astype(np.int32)
    return nbr_rel, nbr_w, win_start, int(window_size), src_pad


def _build_s(cols: np.ndarray, nbr_w: np.ndarray, width: int,
             dtype: torch.dtype) -> Tensor:
    """Dense ``(N_pad, width)`` scatter matrix from per-row ``(col, weight)``
    slots; duplicate slots accumulate (in float32, then cast)."""
    n_pad = cols.shape[0]
    s_mat = np.zeros((n_pad, width), np.float32)
    rows = np.repeat(np.arange(n_pad), cols.shape[1])
    np.add.at(s_mat, (rows, cols.ravel()), nbr_w.ravel())
    return torch.from_numpy(s_mat).to(dtype)


def _densest_window_starts(
    s: np.ndarray, r: np.ndarray, num_blocks: int, window: int, block: int
) -> np.ndarray:
    """Per destination block: the block-aligned window start covering the
    most edges, made monotonically nondecreasing (running max)."""
    blk = r // block
    order = np.lexsort((s, blk))
    s_o, blk_o = s[order], blk[order]
    counts = np.bincount(blk_o, minlength=num_blocks)
    bounds = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    ws = np.zeros(num_blocks, np.int64)
    for b in range(num_blocks):
        lo, hi = bounds[b], bounds[b + 1]
        if hi == lo:
            continue
        src = s_o[lo:hi]  # sorted within the block
        cand = np.unique(src // block) * block
        cov = np.searchsorted(src, cand + window, side="left") - np.searchsorted(
            src, cand, side="left"
        )
        ws[b] = cand[int(np.argmax(cov))]
    return np.maximum.accumulate(ws)


def _symmetric_escape_mask(
    s: np.ndarray, r: np.ndarray, esc: np.ndarray, num_nodes: int
) -> np.ndarray:
    """OR the escape flag across each undirected edge pair, so the in-window
    remainder and the escape set both stay symmetric."""
    key = np.minimum(s, r).astype(np.int64) * np.int64(num_nodes) + np.maximum(s, r)
    uniq, inv = np.unique(key, return_inverse=True)
    esc_any = np.zeros(uniq.size, bool)
    np.logical_or.at(esc_any, inv, esc)
    return esc_any[inv]


def _check_weight_symmetry(
    s: np.ndarray, r: np.ndarray, w: np.ndarray, num_nodes: int
) -> None:
    """Verify ``w[a→b] == w[b→a]`` for every off-diagonal edge (and that the
    reverse edge exists). The escape split assumes it: it holds for GCN
    ``D^-1/2 A D^-1/2`` weights and fails loudly for row-normalized ones."""
    off = s != r
    ss, rr, ww = s[off].astype(np.int64), r[off].astype(np.int64), w[off]
    key = np.minimum(ss, rr) * np.int64(num_nodes) + np.maximum(ss, rr)
    order = np.lexsort((ss, key))
    key_o, w_o = key[order], ww[order]
    if key_o.size % 2 or not np.array_equal(key_o[0::2], key_o[1::2]):
        raise ValueError(
            "graph structure is not symmetric: some edge lacks its reverse; "
            "the windowed layouts require a symmetric adjacency"
        )
    a, b = w_o[0::2], w_o[1::2]
    scale = np.maximum(np.abs(a), np.abs(b))
    if not np.all(np.abs(a - b) <= 1e-5 * np.maximum(scale, 1e-30)):
        bad = int(np.argmax(np.abs(a - b) - 1e-5 * np.maximum(scale, 1e-30)))
        raise ValueError(
            "edge weights are not symmetric (w[a->b] != w[b->a], e.g. "
            f"pair {bad}: {a[bad]!r} vs {b[bad]!r}); the windowed layouts "
            "assume w[a->b] == w[b->a] (GCN sym-normalization). Use the "
            "segment path for asymmetric weights."
        )


def _build_escape_fixup(es: np.ndarray, er: np.ndarray,
                        ew: np.ndarray) -> EscapeFixup:
    """Host-side tables of :class:`EscapeFixup` (U rows; no padding rows —
    the reference's extra rows only keep TPU DMA slices in bounds)."""
    n_esc = es.shape[0]
    eorder = np.argsort(er, kind="stable")
    es, er, ew = es[eorder], er[eorder], ew[eorder].astype(np.float32)
    uniq, inv = np.unique(er, return_inverse=True)
    counts = np.bincount(inv)
    deg = max(int(counts.max()), 1)
    nbr = np.zeros((uniq.size, deg), np.int64)
    w_ell = np.zeros((uniq.size, deg), np.float32)
    starts = np.zeros(uniq.size + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(n_esc) - starts[inv]
    nbr[inv, slot] = es
    w_ell[inv, slot] = ew
    pad_slot = np.arange(deg)[None, :] >= counts[:, None]
    nbr[pad_slot] = np.broadcast_to(nbr[:, :1], nbr.shape)[pad_slot]
    return EscapeFixup(
        senders=torch.from_numpy(es.astype(np.int64)),
        receivers=torch.from_numpy(er.astype(np.int64)),
        weights=torch.from_numpy(ew),
        nbr=torch.from_numpy(nbr),
        w=torch.from_numpy(w_ell),
        rows=torch.from_numpy(uniq.astype(np.int64)),
        num_edges=int(n_esc),
    )


def _sliding_monotonic(
    nbr: np.ndarray,
    nbr_w: np.ndarray,
    win_start: np.ndarray,
    block_size: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Monotonically nondecreasing window starts (running max) + absolute
    source indices. Returns ``(ws_mono, abs_idx, required_window)``."""
    ws = win_start.astype(np.int64)
    ws_mono = np.maximum.accumulate(ws)
    abs_idx = nbr.astype(np.int64) + ws.repeat(block_size)[:, None]
    rel_mono = abs_idx - ws_mono.repeat(block_size)[:, None]
    rel_mono = np.where(nbr_w != 0, rel_mono, 0)
    if rel_mono.size and rel_mono.min() < 0:
        raise AssertionError("monotonic window start broke coverage (below)")
    max_rel = int(rel_mono.max()) if rel_mono.size else 0
    return ws_mono, abs_idx, max_rel + 1


def _sliding_tables(
    ws_mono: np.ndarray,
    abs_idx: np.ndarray,
    nbr_w: np.ndarray,
    window: int,
    block_size: int,
    src_pad: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Clamp window starts into the padded source axis (exact: starts only
    move down, and every edge still fits). Returns ``(ws, rel)`` with
    ``rel`` the window-relative column of every ELL slot."""
    ws = np.minimum(ws_mono, max(src_pad - window, 0))
    ws = np.maximum(ws, 0)
    rel = abs_idx - ws.repeat(block_size)[:, None]
    rel = np.where(nbr_w != 0, rel, 0)
    if rel.size and (rel.min() < 0 or rel.max() >= window):
        raise AssertionError("sliding window clamp broke coverage")
    return ws, rel


def to_sliding_dense(
    graph: Graph,
    *,
    block_size: int = 128,
    dtype: torch.dtype = torch.float32,
    window_size: Optional[int] = None,
) -> SlidingDenseGraph:
    """Build the banded layout (monotone starts, window-relative S).

    The window and starts are those of the reference's
    ``to_sliding_dense``; only the storage of S differs (window-relative
    columns instead of ring columns). ``window_size`` narrows the window:
    per block the densest block-aligned window is chosen and the edges that
    do not fit (symmetrized) go to ``.escape``.
    """
    n = graph.num_nodes
    e = graph.num_edges
    s_np, r_np, w_np = graph.host_edges()
    escape: Optional[EscapeFixup] = None
    forced_ws = None
    if window_size is not None:
        window_size = _round_up(int(window_size), block_size)
        n_pad = _round_up(max(n, 1), block_size)
        src_pad = n_pad
        num_blocks = n_pad // block_size
        ws = _densest_window_starts(s_np, r_np, num_blocks, window_size, block_size)
        ws = np.clip(ws, 0, max(src_pad - window_size, 0))
        blk = r_np // block_size
        out_of_win = (s_np < ws[blk]) | (s_np >= ws[blk] + window_size)
        esc_mask = _symmetric_escape_mask(s_np, r_np, out_of_win, n)
        if esc_mask.any():
            _check_weight_symmetry(s_np, r_np, w_np, n)
            escape = _build_escape_fixup(
                s_np[esc_mask], r_np[esc_mask], w_np[esc_mask])
            keep = ~esc_mask
            s_np, r_np, w_np = s_np[keep], r_np[keep], w_np[keep]
        forced_ws = ws
    nbr, nbr_w, win_start, window, src_pad = ell_tables(
        s_np, r_np, w_np,
        num_dst=n,
        num_src=n,
        block_size=block_size,
        window_size=window_size,
        forced_window_start=forced_ws,
    )
    ws_mono, abs_idx, required = _sliding_monotonic(
        nbr, nbr_w, win_start, block_size
    )
    window = max(window, _round_up(required, block_size))
    window = min(window, src_pad)
    if required > window:
        raise ValueError("window cannot cover spans after monotonic adjustment")
    ws, rel = _sliding_tables(ws_mono, abs_idx, nbr_w, window, block_size,
                              src_pad)
    return SlidingDenseGraph(
        s_mat=_build_s(rel, nbr_w, window, dtype),
        window_start=torch.from_numpy(ws.astype(np.int32)),
        num_nodes=n,
        num_edges=e,
        block_size=block_size,
        window_size=int(window),
        num_src_rows=src_pad,
        escape=escape,
    )


def to_diag_window(
    graph: Graph,
    *,
    window_size: int,
    block_size: int = 128,
    superblock: int = 8,
    dtype: torch.dtype = torch.float32,
    esc2_min_rows: int = 4096,
    transpose_tables: bool = False,
) -> DiagWindowGraph:
    """Build the diagonal-window layout (see :class:`DiagWindowGraph`),
    as the reference's ``to_diag_window(packed=False)`` does: same window,
    same padded row count, same diagonal offset, same escape set, same
    esc2 permutation. Requires a locality ordering such as
    :func:`gwen_tpu_torch.graph.reorder.kd_patch_order`.

    ``superblock`` only sets the row padding (``N_pad`` is a multiple of
    ``block_size · superblock``, shrunk on tiny graphs as the reference
    does), so that both packages pad alike. ``transpose_tables`` attaches
    the tables windowed attention needs (:func:`diag_transpose_tables`).
    """
    e = graph.num_edges
    n = graph.num_nodes
    s_np, r_np, w_np = graph.host_edges()

    block = block_size
    W = _round_up(_round_up(int(window_size), 128), block)
    t_sb = max(int(superblock), 1)
    src_alloc = _round_up(max(n, 1), block)
    W = min(W, src_alloc)
    while W + (t_sb - 1) * block > src_alloc and t_sb > 1:
        t_sb -= 1
    n_pad = _round_up(max(n, 1), block * t_sb)
    num_blocks = n_pad // block

    # The global diagonal offset c minimizing escapes, over a few
    # block-aligned candidates derived from the densest starts.
    dense_ws = _densest_window_starts(s_np, r_np, num_blocks, W, block)
    diag = np.arange(num_blocks, dtype=np.int64) * block
    cands = np.unique(
        np.clip(
            (np.percentile(diag - dense_ws, [10, 25, 50, 75, 90]) // block)
            * block,
            0,
            W - block,
        ).astype(np.int64)
    )
    blk = r_np // block
    best_c, best_esc = 0, None
    for c in cands:
        ws_c = np.clip(diag - c, 0, max(src_alloc - W, 0))
        esc_c = int(((s_np < ws_c[blk]) | (s_np >= ws_c[blk] + W)).sum())
        if best_esc is None or esc_c < best_esc:
            best_c, best_esc = int(c), esc_c
    ws = np.clip(diag - best_c, 0, max(src_alloc - W, 0))

    out_of_win = (s_np < ws[blk]) | (s_np >= ws[blk] + W)
    esc_mask = _symmetric_escape_mask(s_np, r_np, out_of_win, n)
    escape = esc_ptr = None
    esc2_graph = esc2_src = esc2_back = None
    n_esc = int(esc_mask.sum())
    if n_esc:
        _check_weight_symmetry(s_np, r_np, w_np, n)
        w_esc = w_np[esc_mask]
        escape = _build_escape_fixup(s_np[esc_mask], r_np[esc_mask], w_esc)
        uniq = escape.rows.numpy()
        # Receivers are sorted, so each block's fix rows are one range.
        esc_ptr = torch.from_numpy(np.searchsorted(
            uniq, np.arange(num_blocks + 1, dtype=np.int64) * block
        ).astype(np.int32))

        # Hierarchical contraction for large escape sets: compact to the U
        # unique endpoints (receivers == senders, the set is symmetric), RCM
        # the compacted escape graph (its band is small) and contract it
        # with the banded SpMM. Same edges, same weights, reordered.
        if uniq.size >= esc2_min_rows:
            from gwen_tpu_torch.graph.reorder import rcm_order

            es2 = np.searchsorted(uniq, s_np[esc_mask])
            er2 = np.searchsorted(uniq, r_np[esc_mask])
            perm2 = rcm_order(es2, er2, uniq.size)
            inv2 = np.empty_like(perm2)
            inv2[perm2] = np.arange(perm2.size)
            g2 = Graph(
                senders=torch.from_numpy(inv2[es2].astype(np.int64)),
                receivers=torch.from_numpy(inv2[er2].astype(np.int64)),
                weights=torch.from_numpy(w_esc.astype(np.float32)),
                num_nodes=int(uniq.size),
                num_edges=n_esc,
            )
            esc2_graph = to_sliding_dense(g2, block_size=128, dtype=dtype)
            esc2_src = torch.from_numpy(uniq[perm2].astype(np.int64))
            esc2_back = torch.from_numpy(inv2.astype(np.int64))
        keep = ~esc_mask
        s_np, r_np, w_np = s_np[keep], r_np[keep], w_np[keep]

    nbr_rel, nbr_w, _, _, _ = ell_tables(
        s_np, r_np, w_np,
        num_dst=n_pad,
        num_src=src_alloc,
        block_size=block,
        window_size=W,
        forced_window_start=ws,
    )
    out = DiagWindowGraph(
        s_mat=_build_s(nbr_rel, nbr_w, W, dtype),
        window_start=torch.from_numpy(ws.astype(np.int32)),
        num_nodes=n,
        num_edges=e,
        block_size=block,
        window_size=int(W),
        superblock=t_sb,
        num_src_rows=src_alloc,
        escape=escape,
        esc_ptr=esc_ptr,
        esc2_graph=esc2_graph,
        esc2_src=esc2_src,
        esc2_back=esc2_back,
    )
    return diag_transpose_tables(out) if transpose_tables else out


def _padded_lists(keys: np.ndarray, vals: np.ndarray, rows: int) -> np.ndarray:
    """``(rows, D)`` int32 table: row ``r`` holds the ``vals`` of the pairs
    whose key is ``r``, in the order given, padded with -1 (``D`` is the
    largest count, at least 1)."""
    counts = np.bincount(keys, minlength=rows)
    table = np.full((rows, max(int(counts.max(initial=0)), 1)), -1, np.int32)
    starts = np.zeros(rows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    table[keys, np.arange(keys.size) - starts[keys]] = vals
    return table


def diag_transpose_tables(graph: DiagWindowGraph) -> DiagWindowGraph:
    """Attach the transpose tables of the reference's
    ``diag_transpose_tables`` (``t_lo``, ``t_cnt``, ``t_max``, from the
    per-block window starts) and the port's attention neighbour lists
    (``attn_nbr``, ``attn_nbr_t``, from the mask ``s_mat != 0`` itself) to
    a diag-window graph; see :class:`DiagWindowGraph`. Host-side; the
    tables land on the graph's device."""
    if graph.t_max:
        return graph
    block, w = graph.block_size, graph.window_size
    if w % block:
        raise ValueError(f"window {w} not a multiple of block {block}")
    device = graph.s_mat.device
    starts = graph.window_start.cpu().numpy().astype(np.int64)
    if (np.diff(starts) < 0).any():
        raise AssertionError("diag-window starts are not monotonic")
    # Source block c is covered by dst block j iff start_j ≤ c·block <
    # start_j + W; starts are nondecreasing, so the j form one range.
    c_rows = np.arange(graph.num_src_rows // block, dtype=np.int64) * block
    t_lo = np.searchsorted(starts, c_rows - w, side="right")
    t_cnt = np.searchsorted(starts, c_rows, side="right") - t_lo

    rows, cols = np.nonzero((graph.s_mat != 0).cpu().numpy())
    src = starts[rows // block] + cols  # row-major: ascending per dst row
    attn_nbr = _padded_lists(rows, src, graph.num_padded_nodes)
    by_src = np.lexsort((rows, src))
    attn_nbr_t = _padded_lists(src[by_src], rows[by_src], graph.num_src_rows)
    return dataclasses.replace(
        graph,
        t_lo=torch.from_numpy(t_lo.astype(np.int32)).to(device),
        t_cnt=torch.from_numpy(t_cnt.astype(np.int32)).to(device),
        t_max=int(max(1, t_cnt.max(initial=0))),
        attn_nbr=torch.from_numpy(attn_nbr).to(device),
        attn_nbr_t=torch.from_numpy(attn_nbr_t).to(device))
