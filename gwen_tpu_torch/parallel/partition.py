"""Host-side contiguous-chunk graph partitioning for halo-exchange
parallelism: counterpart of ``gwen_tpu.parallel.partition`` (numpy only).

After RCM reordering a weather mesh's adjacency is banded: edges reach at
most ``bandwidth`` positions away. Splitting the node axis into equal
contiguous chunks then puts every cross-partition edge within ``halo =
bandwidth`` rows of a chunk boundary, so the ring exchange of
:mod:`gwen_tpu_torch.parallel.halo` is exact: halos are contiguous row
ranges, one send and one receive per side, no gather.

All per-partition tables share their shapes (max degree, window, rows) and
are stacked along a leading partition axis; each rank takes its slice
(:func:`gwen_tpu_torch.parallel.apply.make_partitioned_apply`).

Where the port's layouts differ from the reference's, so do the tables: the
sliding layout stores S window-relative (no ring columns, no per-block
deltas), and the diag layout keeps one window start per block (no
``xbase``/``offsets``) and places escape rows with per-block ranges into the
receiver-sorted local fix rows (no one-hot ``esc_start``/``esc_lrow``, no
``cnt_pad``). The math is the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gwen_tpu_torch.graph.graph import (
    Graph,
    SlidingDenseGraph,
    _build_s,
    _round_up,
    _sliding_monotonic,
    _sliding_tables,
    ell_tables,
    gcn_normalize,
    to_diag_window,
)
from gwen_tpu_torch.graph.reorder import apply_order, bandwidth, rcm_order

LAYOUTS = ("ell", "dense", "sliding", "diag")


@dataclass
class PartitionedGraph:
    """Stacked per-partition tables and the node permutation."""

    nbr: np.ndarray  # (P, n_local, D) int32, ext-space window-relative
    nbr_weight: np.ndarray  # (P, n_local, D) float32
    window_start: np.ndarray  # (P, n_local // block) int32 into ext space
    s_dense: Optional[np.ndarray]  # (P, n_local, window) float32
    perm: np.ndarray  # new i = old perm[i]
    inv_perm: np.ndarray
    num_parts: int
    n_local: int
    halo: int
    block_size: int
    window_size: int
    num_nodes: int  # global, before padding
    num_edges: int
    edges_per_part: np.ndarray  # (P,) edge counts (incl. self loops)
    # Banded layout (layout="sliding"): S window-relative, monotone clamped
    # starts; the window is shared (maxed) across partitions.
    s_sliding: Optional[torch.Tensor] = None  # (P, n_local, sliding_window)
    sliding_window_start: Optional[np.ndarray] = None  # (P, n_local // block)
    sliding_window: int = 0
    layout: str = "ell"
    # Diag-window layout (layout="diag"): the GLOBAL diag layout sliced per
    # partition (contiguous chunks, so S rows reshape; window starts
    # re-expressed relative to the halo-extended local array). Its halo is
    # the window, O(1) in mesh size, where the RCM layouts need the whole
    # band. Escapes ride the hierarchical contraction with one all_gather of
    # the boundary-skeleton rows (see parallel.halo.HaloDiagGraph).
    s_diag: Optional[torch.Tensor] = None  # (P, n_local, W)
    diag_window_start: Optional[np.ndarray] = None  # (P, n_local // block)
    diag_window: int = 0
    diag_superblock: int = 0
    diag_u_pp: int = 0  # padded per-partition skeleton-row count
    diag_u_count: Optional[np.ndarray] = None  # (P,) skeleton rows held
    diag_esc_ptr: Optional[np.ndarray] = None  # (P, n_local // block + 1)
    diag_loc_idx: Optional[np.ndarray] = None  # (P, U_pp) local x rows
    diag_back_loc: Optional[np.ndarray] = None  # (P, U_pp) c2 rows
    diag_idx2: Optional[np.ndarray] = None  # (U,) into the gathered layout
    # Transpose coverage ranges per partition (see
    # graph.diag_transpose_tables): per halo-extended source block, the
    # range of covering local destination blocks.
    diag_t_lo: Optional[np.ndarray] = None  # (P, n_ext // block) int32
    diag_t_cnt: Optional[np.ndarray] = None  # (P, n_ext // block) int32
    diag_t_max: int = 0
    esc2_graph: Optional[SlidingDenseGraph] = None  # replicated c2 graph

    @property
    def padded_nodes(self) -> int:
        return self.num_parts * self.n_local

    # ------------------------------------------------------------ features
    def pad_nodes(self, x: np.ndarray, node_axis: int = -2) -> np.ndarray:
        """Reorder node data by ``perm`` and zero-pad to ``padded_nodes``."""
        x = np.asarray(x)
        x = np.take(x, self.perm, axis=node_axis)
        pad = self.padded_nodes - x.shape[node_axis]
        if pad:
            widths = [(0, 0)] * x.ndim
            widths[node_axis % x.ndim] = (0, pad)
            x = np.pad(x, widths)
        return x

    def unpad_nodes(self, x: np.ndarray, node_axis: int = -2) -> np.ndarray:
        """Crop padding and restore the original node order."""
        x = np.take(x, np.arange(self.num_nodes), axis=node_axis)
        return np.take(x, self.inv_perm, axis=node_axis)


def partition_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    block_size: int = 128,
    self_loops: bool = True,
    reorder: bool = True,
    halo: Optional[int] = None,
    dense_s: bool = False,
    layout: str = "ell",
    s_dtype: torch.dtype = torch.float32,
    diag_window: int = 384,
    diag_superblock: int = 8,
) -> PartitionedGraph:
    """Partition a (symmetric) graph into ``num_parts`` contiguous chunks.

    ``layout`` picks the local-aggregation tables every partition carries:

    * ``"ell"`` — blocked-ELL only (compact; kernel B12).
    * ``"dense"`` — plus per-partition windowed-dense scatter matrices,
      float32 (kernel B11; the legacy ``dense_s=True``).
    * ``"sliding"`` — plus per-partition banded tables in ``s_dtype``
      (kernels B3/B10); the window is shared across partitions.
    * ``"diag"`` — the global diag-window layout sliced per partition
      (kernels B1/B4, escapes through B3/B10 on the replicated c2 graph).
      Callers order the edge list with ``kd_patch_order`` first and pass
      ``reorder=False`` (the diag windows want patch locality).
    """
    if dense_s:
        layout = "dense"
    if layout not in LAYOUTS:
        raise ValueError(f"unknown partition layout {layout!r}")
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if reorder:
        perm = rcm_order(senders, receivers, num_nodes)
        senders, receivers, _ = apply_order(perm, senders, receivers)
    else:
        perm = np.arange(num_nodes, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_nodes)

    s, r, w = gcn_normalize(senders, receivers, num_nodes, self_loops=self_loops)

    if layout == "diag":
        return _partition_diag(
            s, r, w, num_nodes, num_parts, perm, inv,
            block_size=block_size, window_size=diag_window,
            superblock=diag_superblock, s_dtype=s_dtype,
        )

    n_local = _round_up(-(-num_nodes // num_parts), block_size)
    bw = bandwidth(s, r)
    halo_eff = halo if halo is not None else _round_up(max(bw, 1), block_size)
    if halo_eff < bw:
        raise ValueError(f"halo {halo_eff} < graph bandwidth {bw}")
    if halo_eff > n_local:
        raise ValueError(
            f"halo {halo_eff} exceeds partition size {n_local}: too many "
            f"partitions for this graph's bandwidth — reduce num_parts"
        )
    n_ext = n_local + 2 * halo_eff

    part = r // n_local
    per_part = []
    max_deg = 0
    for p in range(num_parts):
        m = part == p
        sp, rp, wp = s[m], r[m], w[m]
        r_rel = rp - p * n_local
        s_rel = sp - (p * n_local - halo_eff)
        if s_rel.size and (s_rel.min() < 0 or s_rel.max() >= n_ext):
            raise AssertionError("edge escapes halo window (bandwidth bound broken)")
        per_part.append((s_rel, r_rel, wp))
        if rp.size:
            max_deg = max(max_deg, int(np.bincount(r_rel, minlength=n_local).max()))
    max_deg = max(_round_up(max_deg, 8), 8)

    # Shared window across partitions: max span per destination block,
    # computed directly from the edge lists.
    window = block_size
    for s_rel, r_rel, _ in per_part:
        if not len(r_rel):
            continue
        nblk = n_local // block_size
        lo = np.full(nblk, n_ext, np.int64)
        hi = np.zeros(nblk, np.int64)
        blk = r_rel // block_size
        np.minimum.at(lo, blk, s_rel)
        np.maximum.at(hi, blk, s_rel + 1)
        lo = np.where(lo > hi, 0, (lo // block_size) * block_size)
        span = int((hi - lo).max())
        window = max(window, _round_up(span, block_size))
    window = min(window, _round_up(n_ext, block_size))
    nbrs, nws, wss, counts = [], [], [], []
    for s_rel, r_rel, wp in per_part:
        nbr, nw, ws, _, _ = ell_tables(
            s_rel, r_rel, wp, num_dst=n_local, num_src=n_ext,
            block_size=block_size, window_size=window, max_degree=max_deg,
        )
        nbrs.append(nbr)
        nws.append(nw)
        wss.append(ws)
        counts.append(len(wp))

    s_dense = None
    if layout == "dense":
        s_dense = np.zeros((num_parts, n_local, window), np.float32)
        rows = np.repeat(np.arange(n_local), max_deg)
        for p in range(num_parts):
            np.add.at(s_dense[p], (rows, nbrs[p].ravel()), nws[p].ravel())

    s_sliding = sl_ws = None
    sl_window = 0
    if layout == "sliding":
        # Two passes, so that the window is shared across partitions.
        src_pad_ext = _round_up(n_ext, block_size)
        monos = [
            _sliding_monotonic(nbrs[p], nws[p], wss[p], block_size)
            for p in range(num_parts)
        ]
        sl_window = max(
            window,
            max(_round_up(req, block_size) for _, _, req in monos),
        )
        sl_window = min(sl_window, src_pad_ext)
        s_parts, ws_parts = [], []
        for p, (ws_mono, abs_idx, _) in enumerate(monos):
            ws_p, rel = _sliding_tables(ws_mono, abs_idx, nws[p], sl_window,
                                        block_size, src_pad_ext)
            s_parts.append(_build_s(rel, nws[p], sl_window, s_dtype))
            ws_parts.append(ws_p.astype(np.int32))
        s_sliding = torch.stack(s_parts)
        sl_ws = np.stack(ws_parts)

    return PartitionedGraph(
        nbr=np.stack(nbrs),
        nbr_weight=np.stack(nws),
        window_start=np.stack(wss),
        s_dense=s_dense,
        perm=perm,
        inv_perm=inv,
        num_parts=num_parts,
        n_local=n_local,
        halo=halo_eff,
        block_size=block_size,
        window_size=window,
        num_nodes=num_nodes,
        num_edges=len(s),
        edges_per_part=np.asarray(counts),
        s_sliding=s_sliding,
        sliding_window_start=sl_ws,
        sliding_window=sl_window,
        layout=layout,
    )


def _partition_diag(
    s: np.ndarray,
    r: np.ndarray,
    w: np.ndarray,
    num_nodes: int,
    num_parts: int,
    perm: np.ndarray,
    inv: np.ndarray,
    *,
    block_size: int,
    window_size: int,
    superblock: int,
    s_dtype: torch.dtype,
) -> PartitionedGraph:
    """Partition via the GLOBAL diag-window layout.

    Contiguous chunks make the slicing trivial: S rows reshape to ``(P,
    n_local, W)`` and the window starts re-express relative to each
    partition's halo-extended array with ``halo = round_up(W, block)``.
    Escape edges keep the hierarchical contraction: each rank extracts its
    slice of the U boundary-skeleton rows (``loc_idx``), one ``all_gather``
    rebuilds the compacted x (``idx2``), the banded c2 product runs
    replicated, and each rank reads its fix rows back (``back_loc``) and
    places them by the per-block ranges ``esc_ptr`` (its skeleton rows are
    its escape receivers: the escape set is symmetric).
    """
    block = block_size
    t_sb = max(int(superblock), 1)
    n_local = _round_up(-(-num_nodes // num_parts), block * t_sb)
    n_pad = num_parts * n_local
    g_norm = Graph(
        senders=torch.from_numpy(s.astype(np.int64)),
        receivers=torch.from_numpy(r.astype(np.int64)),
        weights=torch.from_numpy(w.astype(np.float32)),
        num_nodes=num_nodes, num_edges=len(s),
    )
    dwg = to_diag_window(
        g_norm, window_size=window_size, block_size=block, superblock=t_sb,
        dtype=s_dtype, esc2_min_rows=1, n_pad=n_pad,
    )
    if dwg.superblock != t_sb:
        raise ValueError(
            f"graph too small for partitioned diag layout at superblock="
            f"{t_sb} (shrunk to {dwg.superblock}); reduce superblock or "
            f"num_parts"
        )
    W = dwg.window_size
    buf = W + (t_sb - 1) * block
    halo_eff = _round_up(W, block)
    if halo_eff > n_local:
        raise ValueError(
            f"diag halo {halo_eff} (= window) exceeds partition size "
            f"{n_local}: too many partitions for this window — reduce "
            f"num_parts or diag_window"
        )
    n_ext = n_local + 2 * halo_eff
    if buf > n_ext:
        raise ValueError(
            f"diag superblock buffer {buf} exceeds halo-extended partition "
            f"{n_ext}; reduce superblock or increase partition size"
        )
    nb_loc = n_local // block

    # Global window starts, re-expressed relative to each partition's
    # halo-extended local array [left-halo | local | right-halo].
    ws_glob = dwg.window_start.numpy().astype(np.int64)
    ws_l = ws_glob.reshape(num_parts, nb_loc) - (
        np.arange(num_parts, dtype=np.int64)[:, None] * n_local - halo_eff
    )
    if ws_l.min() < 0 or ws_l.max() > n_ext - W:
        raise AssertionError("diag window escapes the halo-extended array")

    # Transpose coverage ranges: local window starts are monotone per
    # partition, so the covering blocks per ext source block are one range.
    ns_ext = n_ext // block
    c_rows = np.arange(ns_ext, dtype=np.int64) * block
    t_lo_l = np.zeros((num_parts, ns_ext), np.int32)
    t_cnt_l = np.zeros((num_parts, ns_ext), np.int32)
    for p in range(num_parts):
        lo = np.searchsorted(ws_l[p], c_rows - W, side="right")
        hi = np.searchsorted(ws_l[p], c_rows, side="right")
        t_lo_l[p] = lo.astype(np.int32)
        t_cnt_l[p] = (hi - lo).astype(np.int32)
    t_max = int(max(1, t_cnt_l.max()))

    # ---- escape (boundary-skeleton) tables, partitioned ------------------
    u_pp = 0
    u_count = esc_ptr_l = loc_idx = back_loc = idx2 = None
    if dwg.escape is not None:
        assert dwg.esc2_graph is not None  # esc2_min_rows=1 forces it
        esc2_src = dwg.esc2_src.numpy().astype(np.int64)
        uniq = np.sort(esc2_src)
        inv2 = dwg.esc2_back.numpy().astype(np.int64)
        bounds = np.arange(num_parts + 1, dtype=np.int64) * n_local
        ulo = np.searchsorted(uniq, bounds[:-1])
        uhi = np.searchsorted(uniq, bounds[1:])
        u_count = (uhi - ulo).astype(np.int64)
        u_pp = max(_round_up(int(u_count.max()), 8), 8)
        loc_idx = np.zeros((num_parts, u_pp), np.int32)
        back_loc = np.zeros((num_parts, u_pp), np.int32)
        esc_ptr_l = np.zeros((num_parts, nb_loc + 1), np.int32)
        blk_bounds = np.arange(nb_loc + 1, dtype=np.int64) * block
        for p in range(num_parts):
            k = int(u_count[p])
            u_loc = uniq[ulo[p]:uhi[p]] - p * n_local  # sorted, in [0, n_local)
            loc_idx[p, :k] = u_loc
            back_loc[p, :k] = inv2[ulo[p]:uhi[p]]
            esc_ptr_l[p] = np.searchsorted(u_loc, blk_bounds)
        # c2 row k reads gathered-layout row owner*u_pp + (cpos - ulo[owner])
        cpos = np.searchsorted(uniq, esc2_src)
        owner = uniq[cpos] // n_local
        idx2 = (owner * u_pp + (cpos - ulo[owner])).astype(np.int32)

    counts = np.bincount(
        np.minimum(r // n_local, num_parts - 1), minlength=num_parts
    )
    return PartitionedGraph(
        nbr=np.zeros((num_parts, 1, 1), np.int32),
        nbr_weight=np.zeros((num_parts, 1, 1), np.float32),
        window_start=np.zeros((num_parts, 1), np.int32),
        s_dense=None,
        perm=perm,
        inv_perm=inv,
        num_parts=num_parts,
        n_local=n_local,
        halo=halo_eff,
        block_size=block,
        window_size=W,
        num_nodes=num_nodes,
        num_edges=len(s),
        edges_per_part=np.asarray(counts),
        layout="diag",
        s_diag=dwg.s_mat.reshape(num_parts, n_local, W),
        diag_window_start=ws_l.astype(np.int32),
        diag_window=W,
        diag_superblock=t_sb,
        diag_u_pp=u_pp,
        diag_u_count=u_count,
        diag_esc_ptr=esc_ptr_l,
        diag_loc_idx=loc_idx,
        diag_back_loc=back_loc,
        diag_idx2=idx2,
        esc2_graph=dwg.esc2_graph,
        diag_t_lo=t_lo_l,
        diag_t_cnt=t_cnt_l,
        diag_t_max=t_max,
    )
