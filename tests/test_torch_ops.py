"""The port's aggregation and fused-LayerNorm ops against the reference
package on the CPU.

On CPU tensors the kernel wrappers run their plain versions; the reference
runs its Pallas kernels in interpret mode, as its own tests do. Same numpy
inputs; f32 tolerance ``rtol = atol = 1e-4`` (as ``tests/test_spmm.py``),
bf16 ``1e-2``. Gradients are held against ``jax.vjp`` of the reference.

The esc2 layouts order their compact space by RCM. Both packages must take
the same RCM (native or pure Python) for those layouts to agree row for
row: the ``same_rcm`` fixture pins them (see ``pin_rcm``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu.native as j_native
import gwen_tpu_torch.graph as P
import gwen_tpu_torch.native as p_native
from gwen_tpu.ops.fused_ln import fused_residual_layernorm as j_fused_ln
from gwen_tpu.ops.spmm_pallas import spmm_diag_window as j_diag
from gwen_tpu.ops.spmm_pallas import spmm_sliding_dense as j_sliding
from gwen_tpu_torch.ops import aggregate, aggregate_segment, spmm_cuda
from gwen_tpu_torch.ops.fused_ln import (
    fused_residual_layernorm,
    residual_layernorm,
    residual_layernorm_bwd,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def pin_rcm(monkeypatch, native: bool) -> None:
    """Make both packages take the same RCM. The reference builds its
    native library in place, and a test worker can read it half-written and
    fall back to Python for good; it is complete by now, so retry its
    loader once. Where it still has no library, keep the port off its own
    as well."""
    if native:
        if j_native.get_lib() is None:
            monkeypatch.setattr(j_native, "_TRIED", False)
            j_native.get_lib()
        if j_native.get_lib() is None:
            monkeypatch.setattr(p_native, "get_lib", lambda: None)
    else:
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(p_native, "get_lib", lambda: None)


@pytest.fixture
def same_rcm(monkeypatch):
    pin_rcm(monkeypatch, native=True)


def _ordered(levels, leaf_size):
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    perm = J.kd_patch_order(verts, s, r, n, leaf_size=leaf_size)
    s2, r2, _ = J.apply_order(perm, s, r)
    return s2, r2, n


def _x(rows, f, seed):
    return np.random.default_rng(seed).normal(size=(rows, f)).astype(np.float32)


# (graph kwargs, F, pre-padded input)
DIAG_CASES = [
    (dict(window_size=256, block_size=32, superblock=4), 24, False),
    (dict(window_size=256, block_size=32, superblock=4, esc2_min_rows=1), 24, False),
    (dict(window_size=256, block_size=32, superblock=4, esc2_min_rows=1), 128, True),
    (dict(window_size=256), 128, True),
    (dict(window_size=256), 96, False),
]


@pytest.mark.parametrize("kw,f,prepadded", DIAG_CASES)
def test_spmm_diag_window_matches_reference(kw, f, prepadded, same_rcm):
    s, r, n = _ordered(3, 128)
    dj = J.to_diag_window(J.build_graph(s, r, n), **kw)
    gp = P.build_graph(s, r, n)
    dp = P.to_diag_window(gp, **kw)
    assert dp.escape is not None
    assert (dp.esc2_graph is not None) == ("esc2_min_rows" in kw)
    rows = dp.num_padded_nodes if prepadded else n
    x = _x(rows, f, seed=f + rows)
    if prepadded:
        x[n:] = 0.5  # pad rows hold finite garbage that no real row reads
    want = np.asarray(j_diag(dj, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    before = spmm_cuda.diag_window_spmm.launches
    got = spmm_cuda.spmm_diag_window(dp, xt)
    assert spmm_cuda.diag_window_spmm.launches == before  # CPU: plain version
    assert got.shape == (rows, f)
    np.testing.assert_allclose(got[:n].numpy(), want[:n], **TOL)
    ref = aggregate(dp, xt, backend="reference")
    np.testing.assert_allclose(ref[:n].numpy(), want[:n], **TOL)
    seg = aggregate_segment(gp, xt[:n])
    np.testing.assert_allclose(seg.numpy(), want[:n], **TOL)


@pytest.mark.parametrize("window_size", [None, 256])
def test_spmm_sliding_dense_matches_reference(window_size):
    s, r, n = _ordered(3, 128)
    sj = J.to_sliding_dense(J.build_graph(s, r, n), block_size=32,
                            window_size=window_size)
    sp = P.to_sliding_dense(P.build_graph(s, r, n), block_size=32,
                            window_size=window_size)
    x = _x(n, 24, seed=7)
    want = np.asarray(j_sliding(sj, jnp.asarray(x)))
    got = aggregate(sp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = aggregate(sp, torch.from_numpy(x), backend="reference")
    np.testing.assert_allclose(ref.numpy(), want, **TOL)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python-rcm"])
def test_sliding_spmm_on_esc2_graph_matches_reference(native, monkeypatch):
    """B3 as the esc2 contraction runs it: 128-row blocks, x compacted to
    the U escape endpoints (fewer rows than the padded source axis). The
    compact space is RCM-ordered, so both packages take the same RCM."""
    pin_rcm(monkeypatch, native)
    s, r, n = _ordered(4, 512)
    kw = dict(window_size=256, esc2_min_rows=1)
    e2j = J.to_diag_window(J.build_graph(s, r, n), **kw).esc2_graph
    e2p = P.to_diag_window(P.build_graph(s, r, n), **kw).esc2_graph
    assert e2p.num_nodes < e2p.num_src_rows
    x = _x(e2p.num_nodes, 128, seed=9)
    want = np.asarray(j_sliding(e2j, jnp.asarray(x)))
    got = spmm_cuda.sliding_spmm(e2p, torch.from_numpy(x))
    np.testing.assert_allclose(got[: e2p.num_nodes].numpy(), want, **TOL)


def test_window_spmm_plain_bf16_accumulates_in_f32():
    s, r, n = _ordered(3, 128)
    dp = P.to_diag_window(P.build_graph(s, r, n), window_size=256,
                          dtype=torch.bfloat16)
    x = torch.from_numpy(_x(n, 128, seed=3)).to(torch.bfloat16)
    got = spmm_cuda.spmm_diag_window(dp, x)
    assert got.dtype == torch.bfloat16
    want = spmm_cuda.spmm_diag_window(
        dataclasses.replace(dp, s_mat=dp.s_mat.float()), x.float())
    # One bf16 rounding of the f32 sum (plus the bf16 escape rows).
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("f,dtype", [(256, np.float32), (96, np.float32),
                                     (128, "bfloat16")])
def test_fused_residual_layernorm_matches_reference(f, dtype):
    rng = np.random.default_rng(f)
    m = (rng.normal(size=(300, f)) * 3 + 1).astype(np.float32)
    h = rng.normal(size=(300, f)).astype(np.float32)
    scale = rng.normal(size=f).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(j_fused_ln(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(m, jdt), jnp.asarray(h, jdt)).astype(jnp.float32))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    params = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    before = residual_layernorm.launches
    got = fused_residual_layernorm(params, torch.from_numpy(m).to(tdt),
                                   torch.from_numpy(h).to(tdt))
    assert residual_layernorm.launches == before
    assert got.dtype == tdt
    if dtype == "bfloat16":  # one bf16 rounding of the output
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=1e-2, atol=3e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_aggregate_rejects_layouts_of_later_slices():
    with pytest.raises(TypeError, match="slice"):
        aggregate(object(), torch.zeros(4, 8))


@pytest.mark.parametrize("bad,match", [
    ("rows", "128-row blocks"),
    ("f", "multiple of 4"),
    ("dtype", "S is"),
    ("ndim", "batched inputs"),
    ("fix", "leading axes"),
])
def test_window_spmm_launch_rejects_bad_operands(bad, match):
    s_mat = torch.zeros(256, 64)
    ws = torch.zeros(2, dtype=torch.int32)
    x = torch.zeros(300, 8)
    if bad == "rows":
        s_mat = torch.zeros(200, 64)
    elif bad == "f":
        x = torch.zeros(300, 6)
    elif bad == "dtype":
        x = x.to(torch.bfloat16)
    elif bad == "ndim":
        x = x[None, None]
    if bad == "fix":  # a batched x with an unbatched fix array
        with pytest.raises(ValueError, match=match):
            spmm_cuda._launch(s_mat, ws, x[None], torch.zeros(3, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int64), torch.zeros(4, 8))
        return
    with pytest.raises((ValueError, TypeError), match=match):
        spmm_cuda._launch(s_mat, ws, x, None, None, None)


# ------------------------------------------------------------ gradients


def _diag_pair(esc2: bool, dtype=np.float32):
    s, r, n = _ordered(3, 128)
    kw = dict(window_size=256, block_size=32, superblock=4)
    if esc2:
        kw["esc2_min_rows"] = 1
    dj = J.to_diag_window(J.build_graph(s, r, n), dtype=dtype, **kw)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    dp = P.to_diag_window(P.build_graph(s, r, n), dtype=tdt, **kw)
    assert (dp.esc2_graph is not None) == esc2
    return dj, dp, n


@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
@pytest.mark.parametrize("esc2", [False, True], ids=["ell", "esc2"])
def test_diag_composite_grad_matches_reference(batched, esc2, same_rcm):
    """Forward and x-gradient of the diag composite (B1/B3 unbatched,
    B4/B10 batched, as plain versions on the CPU) against ``jax.vjp`` of
    ``spmm_pallas.spmm_diag_window`` (its custom VJP, interpret mode)."""
    dj, dp, n = _diag_pair(esc2)
    shape = (2, n, 24) if batched else (n, 24)
    rng = np.random.default_rng(11 + batched + 2 * esc2)
    x = rng.normal(size=shape).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: j_diag(dj, v), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    got = spmm_cuda.spmm_diag_window(dp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)
    # autograd through the plain versions gives the same gradient
    xp = torch.from_numpy(x).requires_grad_()
    (gp,) = torch.autograd.grad(spmm_cuda.spmm_diag_window(dp, xp, plain=True),
                                xp, torch.from_numpy(cot))
    np.testing.assert_allclose(gp.numpy(), np.asarray(want_gx), **TOL)


def test_diag_composite_grad_bf16_matches_reference(same_rcm):
    dj, dp, n = _diag_pair(True, jnp.bfloat16)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, n, 32)).astype(np.float32)
    cot = rng.normal(size=(2, n, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_diag(dj, v), jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    (gx,) = torch.autograd.grad(spmm_cuda.spmm_diag_window(dp, xt), xt,
                                torch.from_numpy(cot).to(torch.bfloat16))
    assert gx.dtype == torch.bfloat16
    np.testing.assert_allclose(gx.float().numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("window_size", [None, 256])
def test_sliding_dense_grad_matches_reference(window_size):
    s, r, n = _ordered(3, 128)
    sj = J.to_sliding_dense(J.build_graph(s, r, n), block_size=32,
                            window_size=window_size)
    sp = P.to_sliding_dense(P.build_graph(s, r, n), block_size=32,
                            window_size=window_size)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, n, 16)).astype(np.float32)
    cot = rng.normal(size=(2, n, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_sliding(sj, v), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    (gx,) = torch.autograd.grad(aggregate(sp, xt), xt, torch.from_numpy(cot))
    np.testing.assert_allclose(gx.numpy(), np.asarray(want), **TOL)


def test_batched_plain_kernels_equal_stacked_calls(same_rcm):
    _, dp, n = _diag_pair(True)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, dp.num_padded_nodes, 16)).astype(np.float32))
    u = dp.escape.rows.shape[0]
    fix = torch.from_numpy(rng.normal(size=(3, u, 16)).astype(np.float32))
    got = spmm_cuda.diag_window_spmm_b(dp, x, fix)
    want = torch.stack([spmm_cuda.diag_window_spmm(dp, x[b], fix[b]) for b in range(3)])
    torch.testing.assert_close(got, want)
    g2 = dp.esc2_graph
    x2 = x[:, : g2.num_nodes]
    torch.testing.assert_close(
        spmm_cuda.sliding_spmm_b(g2, x2),
        torch.stack([spmm_cuda.sliding_spmm(g2, x2[b]) for b in range(3)]))
    with pytest.raises(ValueError, match="3-d"):
        spmm_cuda.diag_window_spmm_b(dp, x[0])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layernorm_backward_matches_reference(dtype):
    """B2b (its plain version on the CPU) behind the autograd Function:
    dm, dh, dscale and dbias against ``jax.vjp`` of the reference
    ``fused_residual_layernorm`` (custom VJP, interpret mode)."""
    f = 256
    rng = np.random.default_rng(21)
    m = (rng.normal(size=(2, 300, f)) * 3 + 1).astype(np.float32)
    h = rng.normal(size=(2, 300, f)).astype(np.float32)
    g = rng.normal(size=(2, 300, f)).astype(np.float32)
    scale = rng.normal(size=f).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jfn(m_, h_, sc, bi):
        return j_fused_ln({"scale": sc, "bias": bi}, m_, h_)

    _, vjp = jax.vjp(jfn, jnp.asarray(m, jdt), jnp.asarray(h, jdt),
                     jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt))]
    mt, ht = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (m, h))
    sc, bi = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    before = residual_layernorm_bwd.launches
    out = fused_residual_layernorm({"scale": sc, "bias": bi}, mt, ht)
    got = torch.autograd.grad(out, (mt, ht, sc, bi), torch.from_numpy(g).to(tdt))
    assert residual_layernorm_bwd.launches == before  # CPU: plain version
    assert got[0].dtype == tdt and got[2].dtype == torch.float32
    for name, a, b in zip(("dm", "dh", "dscale", "dbias"), got, want):
        a = a.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2 * np.abs(b).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=name)
