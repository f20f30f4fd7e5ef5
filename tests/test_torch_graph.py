"""The port's graph building against the reference package (CPU).

Host code copied from ``gwen_tpu`` must give array-equal results, and the
port's windowed layouts must describe the same operator as the
reference's: window starts, S seen window-relative, escape edges and the
esc2 permutation. Byte layouts differ by design (no ring columns, no
one-hot escape tables).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.graph.reorder import rcm_order as j_rcm
from gwen_tpu_torch.graph.reorder import rcm_order as p_rcm


def _ordered(levels, leaf_size):
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    perm = J.kd_patch_order(verts, s, r, n, leaf_size=leaf_size)
    s2, r2, _ = J.apply_order(perm, s, r)
    return s2, r2, n


@pytest.mark.parametrize("levels", [3, 4, 5])
def test_host_graph_code_matches_reference(levels):
    vj, sj, rj = J.icosphere_edges(levels)
    vp, sp, rp = P.icosphere_edges(levels)
    np.testing.assert_array_equal(vj, vp)
    np.testing.assert_array_equal(sj, sp)
    np.testing.assert_array_equal(rj, rp)
    n = vj.shape[0]
    np.testing.assert_array_equal(j_rcm(sj, rj, n), p_rcm(sp, rp, n))
    np.testing.assert_array_equal(j_rcm(sj, rj, n, native=False),
                                  p_rcm(sp, rp, n, native=False))
    leaf = max(n // 5, 64)
    perm_j = J.kd_patch_order(vj, sj, rj, n, leaf_size=leaf)
    perm_p = P.kd_patch_order(vp, sp, rp, n, leaf_size=leaf)
    np.testing.assert_array_equal(perm_j, perm_p)
    s2j, r2j, invj = J.apply_order(perm_j, sj, rj)
    s2p, r2p, invp = P.apply_order(perm_p, sp, rp)
    np.testing.assert_array_equal(invj, invp)
    assert J.bandwidth(s2j, r2j) == P.bandwidth(s2p, r2p)
    gj, gp = J.build_graph(s2j, r2j, n), P.build_graph(s2p, r2p, n)
    assert (gj.num_nodes, gj.num_edges) == (gp.num_nodes, gp.num_edges)
    np.testing.assert_array_equal(gj.senders, gp.senders.numpy())
    np.testing.assert_array_equal(gj.receivers, gp.receivers.numpy())
    np.testing.assert_array_equal(gj.weights, gp.weights.numpy())


def _window_relative(s_mat, ws, window, ring=None):
    """(num_blocks, block, window) view of S with column c = source
    ``ws[b] + c`` (reads the reference's ring columns when ``ring``)."""
    s_mat = np.asarray(s_mat, np.float32)
    nb = ws.shape[0]
    blocks = s_mat.reshape(nb, -1, s_mat.shape[1])
    if ring is None:
        return blocks
    cols = (ws[:, None] + np.arange(window)[None, :]) % ring
    return np.take_along_axis(blocks, cols[:, None, :], axis=2)


def _assert_escape_equal(ej, ep):
    assert ej.num_edges == ep.num_edges
    e = ej.num_edges
    want = sorted(zip(np.asarray(ej.senders[:e]).tolist(),
                      np.asarray(ej.receivers[:e]).tolist(),
                      np.asarray(ej.weights[:e]).tolist()))
    got = sorted(zip(ep.senders.tolist(), ep.receivers.tolist(),
                     ep.weights.tolist()))
    assert want == got
    u = ep.rows.shape[0]
    np.testing.assert_array_equal(np.asarray(ej.rows[:u]), ep.rows.numpy())


def _assert_sliding_equal(sj, sp):
    assert sj.window_size == sp.window_size
    assert sj.num_src_rows == sp.num_src_rows
    assert sj.num_padded_nodes == sp.num_padded_nodes
    ws = np.asarray(sj.window_start)
    np.testing.assert_array_equal(ws, sp.window_start.numpy())
    np.testing.assert_array_equal(
        _window_relative(sj.s_mat, ws, sj.window_size, sj.ring_rows),
        _window_relative(sp.s_mat.float().numpy(), ws, sp.window_size))


@pytest.mark.parametrize("kw", [
    dict(levels=3, leaf=128, window_size=256, block_size=32, superblock=4),
    dict(levels=3, leaf=128, window_size=256, block_size=32, superblock=4,
         esc2_min_rows=1),
    dict(levels=4, leaf=512, window_size=256, esc2_min_rows=1),
    dict(levels=5, leaf=2048, window_size=384),
])
def test_to_diag_window_matches_reference(kw):
    kw = dict(kw)
    s, r, n = _ordered(kw.pop("levels"), kw.pop("leaf"))
    dj = J.to_diag_window(J.build_graph(s, r, n), **kw)
    dp = P.to_diag_window(P.build_graph(s, r, n), **kw)
    assert (dp.num_padded_nodes, dp.window_size, dp.num_src_rows,
            dp.superblock) == (dj.num_padded_nodes, dj.window_size,
                               dj.num_src_rows, dj.superblock)
    ws = (np.asarray(dj.xbase)[np.arange(dj.num_blocks) // dj.superblock]
          + np.asarray(dj.offsets))
    np.testing.assert_array_equal(ws, dp.window_start.numpy())
    np.testing.assert_array_equal(np.asarray(dj.s_mat), dp.s_mat.numpy())
    assert (dj.escape is None) == (dp.escape is None)
    if dp.escape is not None:
        _assert_escape_equal(dj.escape, dp.escape)
        # Block b's fix rows are the contiguous range [esc_ptr[b], esc_ptr[b+1]).
        rows = dp.escape.rows.numpy()
        ptr = dp.esc_ptr.numpy()
        blk = np.repeat(np.arange(dp.num_blocks), np.diff(ptr))
        np.testing.assert_array_equal(rows // dp.block_size, blk)
    assert (dj.esc2_graph is None) == (dp.esc2_graph is None)
    if dp.esc2_graph is not None:
        np.testing.assert_array_equal(np.asarray(dj.esc2_src),
                                      dp.esc2_src.numpy())
        u = dp.esc2_back.shape[0]
        np.testing.assert_array_equal(np.asarray(dj.esc2_back)[:u],
                                      dp.esc2_back.numpy())
        _assert_sliding_equal(dj.esc2_graph, dp.esc2_graph)


@pytest.mark.parametrize("window_size", [None, 256])
def test_to_sliding_dense_matches_reference(window_size):
    s, r, n = _ordered(3, 128)
    sj = J.to_sliding_dense(J.build_graph(s, r, n), block_size=32,
                            window_size=window_size)
    sp = P.to_sliding_dense(P.build_graph(s, r, n), block_size=32,
                            window_size=window_size)
    _assert_sliding_equal(sj, sp)
    assert (sj.escape is None) == (sp.escape is None)
    if sp.escape is not None:
        _assert_escape_equal(sj.escape, sp.escape)


def test_graph_to_moves_nested_containers():
    s, r, n = _ordered(3, 128)
    dp = P.to_diag_window(P.build_graph(s, r, n), window_size=256,
                          block_size=32, superblock=4, esc2_min_rows=1,
                          dtype=torch.bfloat16)
    moved = dp.to("meta")
    assert moved.s_mat.device.type == "meta"
    assert moved.s_mat.dtype == torch.bfloat16
    assert moved.escape.nbr.device.type == "meta"
    assert moved.esc2_graph.s_mat.device.type == "meta"
    assert dp.s_mat.device.type == "cpu"


def test_escape_build_rejects_asymmetric_weights():
    s, r, n = _ordered(3, 128)
    deg = np.bincount(r, minlength=n).astype(np.float32)
    g = P.build_graph(s, r, n, normalize=False, weights=1.0 / deg[r])
    with pytest.raises(ValueError, match="not symmetric"):
        P.to_diag_window(g, window_size=256, block_size=32)


def test_port_imports_neither_jax_nor_reference():
    root = Path(__file__).resolve().parents[1]
    banned = {"jax", "jaxlib", "flax", "optax", "gwen_tpu"}
    found = []
    sources = [p for p in (root / "gwen_tpu_torch").rglob("*.py")
               if "_build" not in p.parts]  # build outputs are not sources
    for path in [*sources, root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {m}" for m in names
                      if m.split(".")[0] in banned]
    assert not found, found
