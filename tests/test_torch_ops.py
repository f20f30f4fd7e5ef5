"""The port's aggregation and fused-LayerNorm ops against the reference
package on the CPU.

On CPU tensors the kernel wrappers run their plain versions; the reference
runs its Pallas kernels in interpret mode, as its own tests do. Same numpy
inputs; f32 tolerance ``rtol = atol = 1e-4`` (as ``tests/test_spmm.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops.fused_ln import fused_residual_layernorm as j_fused_ln
from gwen_tpu.ops.spmm_pallas import spmm_diag_window as j_diag
from gwen_tpu.ops.spmm_pallas import spmm_sliding_dense as j_sliding
from gwen_tpu_torch.ops import aggregate, aggregate_segment, spmm_cuda
from gwen_tpu_torch.ops.fused_ln import (
    fused_residual_layernorm,
    residual_layernorm,
)

TOL = dict(rtol=1e-4, atol=1e-4)


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
def test_spmm_diag_window_matches_reference(kw, f, prepadded):
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


def test_sliding_spmm_on_esc2_graph_matches_reference():
    """B3 as the esc2 contraction runs it: 128-row blocks, x compacted to
    the U escape endpoints (fewer rows than the padded source axis)."""
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
        x = x[None]
    with pytest.raises((ValueError, TypeError), match=match):
        spmm_cuda._launch(s_mat, ws, x, None, None, None)
