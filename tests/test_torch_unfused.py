"""The port's unfused attention operators against the reference (CPU).

``diag_sddmm``, ``diag_spmm_t``, ``diag_matvec`` and
``windowed_attention(backend="unfused")`` on the L3 icosphere in KD-patch
order (block 32, window 128, as the reference's ``tests/test_attention.py``).
The JAX side runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions (CPU tensors). Inputs come from numpy seeds.
float32 results are held to rtol = atol = 1e-4, bf16 inputs to
2e-2·max|reference|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops import attention_pallas as jap
from gwen_tpu_torch.ops import (diag_matvec, diag_sddmm, diag_spmm_t,
                                unfused_cuda, windowed_attention)
from test_torch_attention import _graphs, _rand, _t

TOL = dict(rtol=1e-4, atol=1e-4)


def _bf16_close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), f"{what}: {err}"


def _packed_graphs():
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    perm = J.kd_patch_order(verts, s, r, n, leaf_size=64)
    s, r, _ = J.apply_order(perm, s, r)
    kw = dict(window_size=128, block_size=32, superblock=4,
              transpose_tables=True, packed=True)
    return (J.to_diag_window(J.build_graph(s, r, n), **kw),
            P.to_diag_window(P.build_graph(s, r, n), **kw), n)


# ------------------------------------------------------------ the operators


@pytest.mark.parametrize("f", [48, 130])
def test_sddmm_matches_reference(f):
    dj, dp, n = _graphs()
    a, b = _rand(f, (n, f), (n, f))
    want = np.asarray(jap.diag_sddmm(dj, jnp.asarray(a), jnp.asarray(b)))
    got = diag_sddmm(dp, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (dp.num_padded_nodes, dp.window_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sddmm_bf16_inputs():
    dj, dp, n = _graphs()
    a, b = _rand(3, (n, 64), (n, 64))
    want = jap.diag_sddmm(dj, jnp.asarray(a, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16))
    got = diag_sddmm(dp, torch.from_numpy(a).bfloat16(),
                     torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.float32
    _bf16_close(got, want, "sddmm bf16")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_spmm_t_matches_reference(dtype):
    dj, dp, n = _graphs()
    s, g = _rand(1, tuple(dp.s_mat.shape), (dp.num_padded_nodes, 40))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jap.diag_spmm_t(dj, jnp.asarray(s), jnp.asarray(g, jdt))
    got = diag_spmm_t(dp, torch.from_numpy(s), torch.from_numpy(g).to(dtype))
    assert got.shape == (dp.num_src_rows, 40) and got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        _bf16_close(got, want, "spmm_t bf16")


def test_spmm_t_batched_matches_reference():
    """3-d operands (kernel B9b): every item has its own tile ``s``. The
    reference's batched kernel is called as its transpose-kernel dispatch
    calls it, on padded operands."""
    dj, dp, n = _graphs()
    nb, f = 3, 128
    s, g = _rand(2, (nb, *dp.s_mat.shape), (nb, n, f))
    gp = np.zeros((nb, dp.num_padded_nodes, f), np.float32)
    gp[:, :n] = g
    want = jap._spmm_t_chunked(dj.t_lo, dj.t_cnt, dj.offsets, dj.xbase,
                               jnp.asarray(s), jnp.asarray(gp), dj.block_size,
                               dj.superblock, dj.t_max)
    got = diag_spmm_t(dp, torch.from_numpy(s), torch.from_numpy(g))
    assert got.shape == (nb, dp.num_src_rows, f)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want)[:, : dp.num_src_rows], **TOL)
    for i in range(nb):  # and item by item through the 2-d form
        one = diag_spmm_t(dp, torch.from_numpy(s[i]), torch.from_numpy(g[i]))
        np.testing.assert_allclose(one.numpy(), got[i].numpy(), **TOL)


def test_matvec_forward_and_grads_match_reference():
    dj, dp, n = _graphs()
    s, x, cot = _rand(4, tuple(dp.s_mat.shape), (n, 36), (n, 36))
    want = jap.diag_matvec(dj, jnp.asarray(s), jnp.asarray(x))
    ts, tx = _t(s, x)
    got = diag_matvec(dp, ts, tx)
    assert got.shape == (n, 36)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ws, wx = jax.grad(lambda s_, x_: jnp.sum(jap.diag_matvec(dj, s_, x_)
                                             * jnp.asarray(cot)),
                      argnums=(0, 1))(jnp.asarray(s), jnp.asarray(x))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ws), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wx), **TOL)


def test_matvec_bf16_inputs():
    dj, dp, n = _graphs()
    s, x = _rand(5, tuple(dp.s_mat.shape), (n, 64))
    want = jap.diag_matvec(dj, jnp.asarray(s, jnp.bfloat16),
                           jnp.asarray(x, jnp.bfloat16))
    got = diag_matvec(dp, torch.from_numpy(s).bfloat16(),
                      torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want, "matvec bf16")


def test_sddmm_grads_match_reference():
    dj, dp, n = _graphs()
    a, b = _rand(6, (n, 40), (n, 40))
    (cot,) = _rand(7, (dp.num_padded_nodes, dp.window_size))
    wa, wb = jax.grad(lambda a_, b_: jnp.sum(jap.diag_sddmm(dj, a_, b_)
                                             * jnp.asarray(cot)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a, b)
    diag_sddmm(dp, ta, tb).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(wb), **TOL)


def test_plain_versions_match_the_dense_operator():
    """The three plain versions against the dense (N_pad, src) matrix
    expanded from the layout."""
    _, dp, n = _graphs()
    s, a, b = _rand(8, tuple(dp.s_mat.shape), (dp.num_padded_nodes, 24),
                    (dp.num_src_rows, 24))
    dense = np.zeros((dp.num_padded_nodes, dp.num_src_rows))
    starts = dp.window_start.numpy()
    bs, w = dp.block_size, dp.window_size
    for blk in range(dp.num_blocks):
        dense[blk * bs:(blk + 1) * bs, starts[blk]:starts[blk] + w] = \
            s[blk * bs:(blk + 1) * bs]
    ts, ta, tb = map(torch.from_numpy, (s, a, b))
    np.testing.assert_allclose(unfused_cuda.matvec_plain(dp, ts, tb).numpy(),
                               dense @ b, **TOL)
    np.testing.assert_allclose(unfused_cuda.spmm_t_plain(dp, ts, ta).numpy(),
                               dense.T @ a, **TOL)
    full = a @ b.T
    got = unfused_cuda.sddmm_plain(dp, ta, tb).numpy()
    for blk in range(dp.num_blocks):
        np.testing.assert_allclose(
            got[blk * bs:(blk + 1) * bs],
            full[blk * bs:(blk + 1) * bs, starts[blk]:starts[blk] + w], **TOL)


def test_operators_refuse_what_the_reference_refuses():
    _, dp, n = _graphs()
    plain = P.to_diag_window(P.build_graph(*J.icosphere_edges(2)[1:], 162),
                             window_size=128, block_size=32)
    x = torch.zeros(162, 8)
    for fn in (diag_sddmm, diag_matvec, diag_spmm_t):
        with pytest.raises(ValueError, match="transpose tables"):
            fn(plain, x, x)
        with pytest.raises(TypeError, match="DiagWindowGraph"):
            fn(P.build_graph(*J.icosphere_edges(2)[1:], 162), x, x)
    with pytest.raises(ValueError, match="2-d"):
        diag_sddmm(dp, torch.zeros(2, n, 8), torch.zeros(2, n, 8))
    with pytest.raises(ValueError, match="s must be"):
        diag_spmm_t(dp, torch.zeros(n, 8), torch.zeros(n, 8))


def test_kernel_operand_checks():
    """What the CUDA wrappers raise on, checked on CPU tensors: the kernels
    fix 128-row blocks, one type, and the graph's row counts."""
    _, dp, n = _graphs()  # block 32: no kernel
    a = torch.zeros(n, 8)
    with pytest.raises(ValueError, match="128-row blocks"):
        unfused_cuda._check(dp, "B8", a, a, dp.num_padded_nodes,
                            dp.num_src_rows, tables=False)
    verts, s, r = J.icosphere_edges(3)
    g128 = P.to_diag_window(P.build_graph(s, r, verts.shape[0]),
                            window_size=256, block_size=128, superblock=2,
                            transpose_tables=True)
    a = torch.zeros(g128.num_padded_nodes, 8)
    unfused_cuda._check(g128, "B9", a, a, g128.num_padded_nodes,
                        g128.num_padded_nodes, tables=True)
    with pytest.raises(TypeError, match="both be float32 or both"):
        unfused_cuda._check(g128, "B8", a, a.bfloat16(), 10**6, 10**6, False)
    with pytest.raises(ValueError, match="rows"):
        unfused_cuda._check(g128, "B8", torch.zeros(10**4, 8),
                            torch.zeros(10**4, 8), g128.num_padded_nodes,
                            g128.num_src_rows, False)
    with pytest.raises(ValueError, match="2-d or both 3-d"):
        unfused_cuda._check(g128, "B8", a, a[None], 10**6, 10**6, False)
    with pytest.raises(ValueError, match="contiguous"):
        unfused_cuda._check(g128, "B8", a.T.contiguous().T, a, 10**6, 10**6,
                            False)
    assert unfused_cuda._vec_pad(torch.zeros(3, 5)).shape == (3, 8)
    assert unfused_cuda._vec_pad(torch.zeros(3, 5).bfloat16()).shape == (3, 8)
    assert unfused_cuda._vec_pad(a) is a


# ------------------------------------------------- the unfused attention path


@pytest.mark.parametrize("graphs", [_graphs, _packed_graphs],
                         ids=["weighted", "packed"])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "batched"])
def test_unfused_attention_matches_reference_and_auto(graphs, lead):
    """Forward and the q, k, v gradients of ``backend="unfused"`` against
    the reference's unfused backend and against the port's fused one."""
    dj, dp, n = graphs()
    q, k, v, g = _rand(11 + len(lead), *[(*lead, n, 32)] * 4)
    want, vjp = jax.vjp(
        lambda a, b, c: jap.windowed_attention(dj, a, b, c, backend="unfused"),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    outs = {}
    for backend in ("unfused", "auto"):
        ts = _t(q, k, v)
        out = windowed_attention(dp, *ts, backend=backend)
        out.backward(torch.from_numpy(g))
        outs[backend] = [out.detach()] + [t.grad for t in ts]
    assert outs["unfused"][0].shape == q.shape
    for got, w, name in zip(outs["unfused"], (want, *want_grads),
                            ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    # The reference holds its fused to its unfused backend at 2e-5 forward
    # and 2e-4 on the gradients.
    for got, w, name, tol in zip(outs["unfused"], outs["auto"],
                                 ("out", "dq", "dk", "dv"),
                                 (2e-5, 2e-4, 2e-4, 2e-4)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{name} vs auto")


def test_unfused_attention_pack():
    """``pack=True``: two 64-wide heads in 128 lanes, with leading axes."""
    dj, dp, n = _graphs()
    q, k, v = _rand(13, *[(2, n, 128)] * 3)
    for t in (q, k, v):  # each sub-head holds 48 real lanes
        t[..., 48:64] = 0
        t[..., 112:] = 0
    scale = 48 ** -0.5
    want = jap.windowed_attention(dj, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=scale,
                                  backend="unfused", pack=True)
    got = windowed_attention(dp, *map(torch.from_numpy, (q, k, v)),
                             scale=scale, backend="unfused", pack=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unfused_attention_bf16_inputs():
    dj, dp, n = _graphs(dtype=jnp.bfloat16)
    q, k, v = _rand(14, *[(n, 64)] * 3)
    want = jap.windowed_attention(dj, *(jnp.asarray(t, jnp.bfloat16)
                                        for t in (q, k, v)), backend="unfused")
    got = windowed_attention(dp, *(torch.from_numpy(t).bfloat16()
                                   for t in (q, k, v)), backend="unfused")
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want, "unfused attention bf16")
