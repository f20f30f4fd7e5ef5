"""The unfused operators' plain versions at the kernels' shapes, against the
reference package (CPU), and the wrappers' dispatch to the kernels.

``tests/test_torch_unfused.py`` works on 32-row blocks, which the kernels
of ``csrc/window_unfused.cu`` (B8, the SDDMM; B9 and B9b, the transpose
SpMM) do not take. Here the graph is the one they are built for: the L4
icosphere in KD-patch order with 128-row blocks, a 384-row window and the
transpose tables (2,562 nodes in 24 destination and 21 source blocks, 2 to
7 covering blocks a source block). ``sddmm_plain`` and ``spmm_t_plain`` are
held against ``gwen_tpu``'s ``diag_sddmm`` and ``diag_spmm_t`` (Pallas in
interpret mode) and, for 3-d operands, against the reference's batched
transpose kernel as its dispatch calls it (``_spmm_t_chunked``): feature
widths 8, 48, 130 and 264 (across the kernels' 64- and 128-feature slices
and B8's resident limit of 256), 1, 3 and 8 items, operands with as many
rows as the graph has nodes, fewer, or as many as it pads to. float32
results are held to rtol = atol = 1e-4, bf16 inputs to
2e-2·max|reference|. A fake library stands in for the built one to hold
each wrapper's one launch and its arguments.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops import attention_pallas as jap
from gwen_tpu_torch.ops import unfused_cuda
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(window_size=384, block_size=128, transpose_tables=True)
SHORT = 162  # rows fewer than the nodes in a "short" operand


@functools.lru_cache(maxsize=None)
def _graphs():
    """The reference's and the port's L4 diag-window graphs (KD order)."""
    verts, s, r = J.icosphere_edges(4)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.kd_patch_order(verts, s, r, n), s, r)
    return (J.to_diag_window(J.build_graph(s, r, n), **KW),
            P.to_diag_window(P.build_graph(s, r, n), **KW), n)


def _rows(kind: str, n: int, padded: int) -> int:
    return {"nodes": n, "short": n - SHORT, "padded": padded}[kind]


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got: torch.Tensor, want, dtype, what: str) -> None:
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.float().numpy(), want, **TOL, err_msg=what)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), f"{what}: {err}"


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
# Each feature width with one row count: as many rows as the nodes, fewer,
# or as many as the graph pads to.
WIDTHS = pytest.mark.parametrize("f,rows", [(8, "nodes"), (48, "short"),
                                            (130, "padded"), (264, "short")])


def test_graph_has_the_kernel_shapes():
    """The graph these tests run on: 128-row blocks, window 384, and source
    blocks covered by more than three destination blocks."""
    dj, dp, n = _graphs()
    assert (dp.block_size, dp.window_size) == (128, 384) and n == 2562
    assert dp.num_blocks == 24 and dp.t_lo.shape == (21,)
    assert int(dp.t_cnt.min()) == 2 and int(dp.t_cnt.max()) == 7
    np.testing.assert_array_equal(dp.t_cnt.numpy(), np.asarray(dj.t_cnt))
    assert dp.num_src_rows == 21 * 128


@WIDTHS
@DTYPES
def test_sddmm_plain_matches_reference(f, rows, dtype):
    """B8's plain version, one item."""
    dj, dp, n = _graphs()
    a, b = _rand(f, (_rows(rows, n, dp.num_padded_nodes), f),
                 (_rows(rows, n, dp.num_src_rows), f))
    want = jap.diag_sddmm(dj, jnp.asarray(a, _jdt(dtype)),
                          jnp.asarray(b, _jdt(dtype)))
    got = unfused_cuda.sddmm_plain(dp, torch.from_numpy(a).to(dtype),
                                   torch.from_numpy(b).to(dtype))
    assert got.shape == (dp.num_padded_nodes, 384) and got.dtype == torch.float32
    _close(got, want, dtype, f"sddmm f={f} {rows}")


@pytest.mark.parametrize("nb,f", [(3, 130), (8, 48)])
def test_sddmm_plain_batched_matches_reference(nb, f):
    """B8 on 3-d operands: each item against the reference's call on it."""
    dj, dp, n = _graphs()
    a, b = _rand(nb + f, (nb, n - SHORT, f), (nb, n, f))
    got = unfused_cuda.sddmm_plain(dp, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (nb, dp.num_padded_nodes, 384)
    for i in range(nb):
        want = jap.diag_sddmm(dj, jnp.asarray(a[i]), jnp.asarray(b[i]))
        _close(got[i], want, torch.float32, f"sddmm item {i}")


@WIDTHS
@DTYPES
def test_spmm_t_plain_matches_reference(f, rows, dtype):
    """B9's plain version, one item."""
    dj, dp, n = _graphs()
    s, g = _rand(f + 1, tuple(dp.s_mat.shape),
                 (_rows(rows, n, dp.num_padded_nodes), f))
    want = jap.diag_spmm_t(dj, jnp.asarray(s), jnp.asarray(g, _jdt(dtype)))
    got = unfused_cuda.spmm_t_plain(dp, torch.from_numpy(s),
                                    torch.from_numpy(g).to(dtype))
    assert got.shape == (dp.num_src_rows, f) and got.dtype == dtype
    _close(got, want, dtype, f"spmm_t f={f} {rows}")


@pytest.mark.parametrize("nb,f,rows", [(1, 264, "short"), (3, 130, "nodes"),
                                       (8, 8, "padded")])
@DTYPES
def test_spmm_t_plain_batched_matches_reference(nb, f, rows, dtype):
    """B9b on 3-d operands (every item its own tile ``s``) against the
    reference's batched transpose kernel, called as its dispatch calls it:
    g padded to the padded rows and to a multiple of 128 features."""
    dj, dp, n = _graphs()
    s, g = _rand(nb + f, (nb, *dp.s_mat.shape),
                 (nb, _rows(rows, n, dp.num_padded_nodes), f))
    f_pad = -(-f // 128) * 128
    gp = np.zeros((nb, dp.num_padded_nodes, f_pad), np.float32)
    gp[:, :g.shape[1], :f] = g
    jdt = _jdt(dtype)
    want = jap._spmm_t_chunked(dj.t_lo, dj.t_cnt, dj.offsets, dj.xbase,
                               jnp.asarray(s, jdt), jnp.asarray(gp, jdt),
                               dj.block_size, dj.superblock, dj.t_max)
    got = unfused_cuda.spmm_t_plain(dp, torch.from_numpy(s),
                                    torch.from_numpy(g).to(dtype))
    assert got.shape == (nb, dp.num_src_rows, f) and got.dtype == dtype
    _close(got, np.asarray(want, np.float32)[:, :dp.num_src_rows, :f], dtype,
           f"spmm_t nb={nb} f={f} {rows}")


# ------------------------------------------------- dispatch to the kernels


@pytest.mark.parametrize("f", [8, 130, 264])
@pytest.mark.parametrize("lead", [(), (3,), (8,)], ids=["2d", "nb3", "nb8"])
@DTYPES
def test_wrappers_launch_one_kernel_each(dtype, lead, f, fake_lib):
    """B8 is one ``gwen_sddmm`` call and B9 one ``gwen_spmm_t`` call, at any
    width and item count: the items, the blocks, the window, f padded to a
    16-byte vector, the operands' rows and the dtype code as the kernels
    take them, each counted once; B9's output cut back to f."""
    _, dp, n = _graphs()
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    fp = -(-f // vec) * vec
    code = 1 if dtype == torch.bfloat16 else 0
    nb = lead[0] if lead else 1
    a = torch.zeros(*lead, n - SHORT, f, dtype=dtype)
    b = torch.zeros(*lead, n, f, dtype=dtype)
    b8, b9 = unfused_cuda.sddmm.launches, unfused_cuda.spmm_t.launches
    scores = unfused_cuda.sddmm(dp, a, b)
    assert unfused_cuda.sddmm.launches == b8 + 1
    assert scores.shape == (*lead, dp.num_padded_nodes, 384)
    assert scores.dtype == torch.float32
    s = torch.zeros(*lead, dp.num_padded_nodes, 384)
    out = unfused_cuda.spmm_t(dp, s, a)
    assert unfused_cuda.spmm_t.launches == b9 + 1
    assert out.shape == (*lead, dp.num_src_rows, f) and out.dtype == dtype
    assert [c[0] for c in fake_lib.calls] == ["gwen_sddmm", "gwen_spmm_t"]
    (_, a8), (_, a9) = fake_lib.calls
    assert a8[2] == dp.window_start.data_ptr() and a8[3] == scores.data_ptr()
    assert list(a8[4:]) == [nb, dp.num_blocks, 384, fp, n - SHORT, n, code, 0]
    assert list(a9[2:5]) == [dp.window_start.data_ptr(), dp.t_lo.data_ptr(),
                             dp.t_cnt.data_ptr()]
    assert list(a9[6:]) == [nb, dp.num_blocks, 21, 384, fp, n - SHORT, code, 0]
