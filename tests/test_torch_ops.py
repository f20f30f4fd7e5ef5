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
    # Every container of the reference is taken now: only an unknown type
    # is refused, by name.
    with pytest.raises(TypeError, match="no aggregation for graph type object"):
        aggregate(object(), torch.zeros(4, 8))


@pytest.mark.parametrize("bad,match", [
    ("rows", "128-row blocks"),
    ("f", "multiple of 4"),
    ("dtype", "S is"),
    ("ndim", "batched inputs"),
    ("fix", "leading axes"),
])
def test_window_spmm_launch_rejects_bad_operands(bad, match):
    """The dense row gather's launch (every form on a dense S) refuses what
    the kernel does not take before anything launches."""
    s_mat = torch.zeros(256, 64)
    ws = torch.zeros(2, dtype=torch.int32)
    x = torch.zeros(300, 8)
    esc = (None, None, None)
    if bad == "rows":
        s_mat = torch.zeros(200, 64)
    elif bad == "f":
        x = torch.zeros(300, 6)
    elif bad == "dtype":
        s_mat = s_mat.half()
    elif bad == "ndim":
        x = x[None, None]
    elif bad == "fix":  # a batched x with an unbatched fix array (B1 and B4's gather)
        x = x[None]
        esc = (torch.zeros(3, dtype=torch.int32), torch.zeros(4, dtype=torch.int64),
               torch.zeros(4, 8))
    with pytest.raises((ValueError, TypeError), match=match):
        spmm_cuda._launch_streamed(s_mat, ws, 128, x, *esc)


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


# ------------------------------------- any width, leading axes, mixed operands


def _layout_pair(layout: str):
    s, r, n = _ordered(3, 128)
    gj, gp = J.build_graph(s, r, n), P.build_graph(s, r, n)
    kw = dict(window_size=256, block_size=32, superblock=4, esc2_min_rows=1)
    if layout == "diag-bf16":
        return (J.to_diag_window(gj, dtype=jnp.bfloat16, **kw),
                P.to_diag_window(gp, dtype=torch.bfloat16, **kw), n)
    if layout == "diag-packed":
        return (J.to_diag_window(gj, packed=True, **kw),
                P.to_diag_window(gp, packed=True, **kw), n)
    if layout == "banded-bf16":
        return (J.to_sliding_dense(gj, block_size=32, dtype=jnp.bfloat16),
                P.to_sliding_dense(gp, block_size=32, dtype=torch.bfloat16), n)
    return J.to_sliding_packed(gj, block_size=32), P.to_sliding_packed(gp, block_size=32), n


@pytest.mark.parametrize("lead,f", [((4,), 1), ((2, 3), 3)], ids=["KN1", "BKN3"])
@pytest.mark.parametrize("layout", ["diag-bf16", "diag-packed", "banded-bf16",
                                    "banded-packed"])
def test_aggregate_takes_any_width_leading_axes_and_f32_on_bf16(layout, lead, f,
                                                                same_rcm):
    """What the ensemble code hands ``aggregate``: a float32 ``(K, N, 1)`` or
    ``(B, K, N, 3)`` field on a bf16 or bit-packed windowed layout, against
    the reference's ``aggregate`` (S cast to x's type, a float32 product)."""
    from gwen_tpu.ops import aggregate as j_aggregate

    lj, lp, n = _layout_pair(layout)
    x = np.random.default_rng(len(lead) + f).normal(size=(*lead, n, f)).astype(np.float32)
    want = np.asarray(j_aggregate(lj, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = aggregate(lp, xt)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(aggregate(lp, xt.detach(), backend="plain").numpy(),
                               want, **TOL)
    # The operator is symmetric: the x-gradient is the aggregation of the
    # cotangent, in x's shape.
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(x))
    np.testing.assert_allclose(gx.numpy(), want, **TOL)


def test_fold_pads_the_width_only_where_the_kernels_run():
    x = torch.zeros(2, 3, 10, 5)
    folded, lead, f = spmm_cuda._fold(x)
    assert folded.shape == (6, 10, 5) and lead == (2, 3) and f == 5
    assert spmm_cuda._unfold(folded, lead, f).shape == x.shape
    # Off the CPU the width is padded to one 16-byte vector.
    for dtype, width in ((torch.float32, 8), (torch.bfloat16, 8)):
        m = torch.zeros(2, 3, 10, 5, dtype=dtype, device="meta")
        folded, lead, f = spmm_cuda._fold(m)
        assert folded.shape == (6, 10, width)
        assert spmm_cuda._unfold(folded, lead, f).shape == m.shape
    m = torch.zeros(10, 1, device="meta")
    folded, lead, f = spmm_cuda._fold(m)
    assert folded.shape == (10, 4) and lead == ()
    assert spmm_cuda._unfold(folded, lead, f).shape == (10, 1)
    m = torch.zeros(4, 10, 256, dtype=torch.bfloat16, device="meta")
    assert spmm_cuda._fold(m)[0] is m


def test_kernel_dtype_codes():
    f32, bf16 = torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16)
    assert spmm_cuda._kernel_code(torch.float32, f32) == 0
    assert spmm_cuda._kernel_code(torch.bfloat16, bf16) == 1
    assert spmm_cuda._kernel_code(torch.bfloat16, f32) == 2  # S widened per tile
    with pytest.raises(TypeError, match="S is"):
        spmm_cuda._kernel_code(torch.float32, bf16)
    with pytest.raises(TypeError, match="S is"):
        spmm_cuda._kernel_code(torch.float16, torch.zeros(1, dtype=torch.float16))


def test_streamed_kernel_takes_f32_s_under_bf16_x():
    """B11's launch alone takes a bfloat16 x on a float32 S (code 3: S
    rounded as it is staged); the other kernels go on refusing it."""
    bf16 = torch.zeros(1, dtype=torch.bfloat16)
    assert spmm_cuda._kernel_code(torch.float32, bf16, streamed=True) == 3
    assert spmm_cuda._kernel_code(torch.bfloat16, bf16, streamed=True) == 1
    with pytest.raises(TypeError, match="S is"):
        spmm_cuda._kernel_code(torch.float16, bf16, streamed=True)


def _rcm_layouts(block):
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    s2, r2, _ = J.apply_order(J.rcm_order(s, r, n), s, r)
    g = P.build_graph(s2, r2, n)
    return (P.to_windowed_dense(g, block_size=block),
            P.to_block_ell(g, block_size=block), g, n)


@pytest.mark.parametrize("shape", [(24,), (3, 24)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_windowed_dense_and_block_ell_plain_versions(layout, shape):
    """The plain versions of B11 and B12 (what the wrappers run on CPU
    tensors, with no launch counted) are the segment aggregation; in bf16
    they round once, from a float32 sum."""
    wd, ell, g, n = _rcm_layouts(32)
    graph, wrapper, plain = ((wd, spmm_cuda.windowed_dense_spmm,
                              spmm_cuda.windowed_dense_spmm_plain) if layout == "dense"
                             else (ell, spmm_cuda.block_ell_spmm,
                                   spmm_cuda.block_ell_spmm_plain))
    lead, f = shape[:-1], shape[-1]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(*lead, n, f)).astype(np.float32))
    want = aggregate_segment(g, x)
    before = wrapper.launches
    got = wrapper(graph, x)
    assert wrapper.launches == before
    assert got.shape == (*lead, graph.num_padded_nodes, f)
    np.testing.assert_allclose(got[..., :n, :].numpy(), want.numpy(), **TOL)
    torch.testing.assert_close(got, plain(graph, x))
    assert got[..., n:, :].abs().sum() == 0  # pad rows have no sources
    xb = x.bfloat16()
    want_b = plain(graph, xb.float()) if layout == "ell" else plain(
        dataclasses.replace(graph, s_mat=graph.s_mat.bfloat16().float()), xb.float())
    got_b = wrapper(graph, xb)
    assert got_b.dtype == torch.bfloat16
    torch.testing.assert_close(got_b.float(), want_b.bfloat16().float(),
                               rtol=1e-2, atol=1e-2)


def test_non_square_layout_refuses_a_kernel_gradient():
    """Halo-extended sources make the operator non-square: the symmetric
    backward does not hold, so the kernel path (any device but the CPU)
    refuses a gradient; the CPU path differentiates the plain version."""
    wd, ell, _, n = _rcm_layouts(32)
    ext = dataclasses.replace(ell, num_src_rows=ell.num_padded_nodes + 64)
    x = torch.zeros(ext.num_src_rows, 4, requires_grad=True)
    out = aggregate(ext, x)
    assert out.shape == (ext.num_padded_nodes, 4) and out.requires_grad
    meta = torch.zeros(ext.num_src_rows, 4, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="not square"):
        spmm_cuda.spmm_block_ell(ext, meta)
