"""The bit-packed layouts of the port against the reference package (CPU).

``to_diag_window(..., packed=True)`` (S01 bits and rank-1 scales, the
packed form of kernels B1/B4), ``to_sliding_packed`` (kernel B13) and the
attention and encode-process-decode paths on a packed graph. The same numpy
inputs go through both packages; the reference runs its Pallas kernels in
interpret mode, the port its kernels' plain versions (CPU tensors). L3
icosphere, small widths: float32 at ``rtol = atol = 1e-4``, bf16 at
``1e-2·max|ref|`` (bf16 rounds at other places in the two packages: the
port folds B13's scales into the product, the reference scales x and the
output in bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.graph.graph import _packed_row_bit
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu.ops.attention_pallas import windowed_attention as j_windowed
from gwen_tpu.ops.spmm_pallas import spmm_diag_window as j_diag
from gwen_tpu.ops.spmm_pallas import spmm_sliding_packed as j_sliding_packed
from gwen_tpu.train.tasks import mesh_graph_loss_fn as j_loss_fn
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax
from gwen_tpu_torch.ops import aggregate, aggregate_segment, spmm_cuda
from gwen_tpu_torch.ops.attention import windowed_attention
from gwen_tpu_torch.train import mesh_graph_loss_fn
from test_torch_ops import DIAG_CASES, _ordered, same_rcm  # noqa: F401
from test_torch_train import _flat
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def _ref_mask(dj) -> np.ndarray:
    """The reference's tile-ordered S01 bits unpacked by its own rule
    (``gwen_tpu/ops/aggregate.py``): block-local row ``l`` is bit
    ``l // gpb`` of packed row ``l % gpb``."""
    gpb = dj.block_size // 8
    pk = np.asarray(dj.s_pack).reshape(-1, gpb, dj.window_size)
    rows = np.arange(dj.block_size)
    bits = (pk[:, rows % gpb, :] >> (rows // gpb).astype(np.uint8)[None, :, None]) & 1
    return bits.reshape(-1, dj.window_size).astype(bool)


def _diag_pair(kw, dtype=np.float32):
    s, r, n = _ordered(3, 128)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return (J.to_diag_window(J.build_graph(s, r, n), packed=True, dtype=dtype, **kw),
            P.to_diag_window(P.build_graph(s, r, n), packed=True, dtype=tdt, **kw),
            P.build_graph(s, r, n), n)


def _rcm_graphs(levels=3):
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.rcm_order(s, r, n), s, r)
    return J.build_graph(s, r, n), P.build_graph(s, r, n), n


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("case", ["gcn", "no_self_loops", "not_rank1"])
def test_rank1_scales_match_reference(case):
    verts, s, r = J.icosphere_edges(2)
    n = verts.shape[0]
    if case == "gcn":
        kw = {}
    elif case == "no_self_loops":
        kw = dict(self_loops=False)
    else:  # self loops, but each edge weight drawn at random
        loops = np.arange(n)
        s, r = np.concatenate([s, loops]), np.concatenate([r, loops])
        w = np.random.default_rng(0).uniform(0.1, 1.0, s.size).astype(np.float32)
        kw = dict(normalize=False, weights=w)
    gj, gp = J.build_graph(s, r, n, **kw), P.build_graph(s, r, n, **kw)
    if case == "gcn":
        a = P.rank1_scales(gp)
        np.testing.assert_array_equal(a, J.rank1_scales(gj))
        assert a.dtype == np.float32 and (a > 0).all()
        return
    match = "self loops" if case == "no_self_loops" else "not rank-1"
    for fn, g in ((J.rank1_scales, gj), (P.rank1_scales, gp)):
        with pytest.raises(ValueError, match=match):
            fn(g)
    with pytest.raises(ValueError, match=match):
        P.to_diag_window(gp, window_size=128, block_size=32, packed=True)


@pytest.mark.parametrize("kw", [DIAG_CASES[0][0], DIAG_CASES[1][0], DIAG_CASES[3][0]],
                         ids=["ell", "esc2", "block128"])
def test_packed_diag_layout_matches_reference(kw, same_rcm):
    dj, dp, gp, n = _diag_pair(kw)
    assert dp.s_mat is None and dp.s_pack.dtype == torch.int32
    assert dp.s_pack.shape == (dj.num_padded_nodes, dj.window_size // 32)
    assert dp.num_padded_nodes == dj.num_padded_nodes
    starts = np.repeat(np.asarray(dj.xbase), dj.superblock) + np.asarray(dj.offsets)
    np.testing.assert_array_equal(dp.window_start.numpy(), starts)
    np.testing.assert_array_equal(P.window_mask(dp).numpy(), _ref_mask(dj))
    np.testing.assert_array_equal(dp.r1_row.numpy(), np.asarray(dj.r1_row))
    np.testing.assert_array_equal(dp.r1_col.numpy(), np.asarray(dj.r1_col))
    # Escape tables carry w = a_s, not the edge weight.
    e = dp.escape.num_edges
    a = P.rank1_scales(gp)
    np.testing.assert_array_equal(dp.escape.weights.numpy(), a[dp.escape.senders.numpy()])
    np.testing.assert_array_equal(dp.escape.weights.numpy(),
                                  np.asarray(dj.escape.weights)[:e])
    if dp.esc2_graph is not None:
        g2, j2 = dp.esc2_graph, dj.esc2_graph
        assert g2.s_mat.shape[0] == j2.num_padded_nodes
        np.testing.assert_allclose(np.sort(g2.s_mat.numpy()[g2.s_mat.numpy() != 0]),
                                   np.sort(dp.escape.weights.numpy()))
    # The same edges unpacked give the same mask.
    du = P.to_diag_window(gp, **kw)
    assert torch.equal(P.window_mask(du), P.window_mask(dp))


def test_pack_bits_round_trip():
    rng = np.random.default_rng(4)
    s01 = rng.random((40, 96)) < 0.1
    bits = P.pack_bits(s01)
    assert bits.shape == (40, 3) and bits.dtype == torch.int32
    np.testing.assert_array_equal(P.unpack_bits(bits).numpy(), s01)
    # bit j of word k is column 32k + j
    one = np.zeros((1, 64), bool)
    one[0, 33] = True
    assert P.pack_bits(one).tolist() == [[0, 2]]
    with pytest.raises(ValueError, match="multiple of 32"):
        P.pack_bits(np.zeros((2, 40), bool))


def test_sliding_packed_layout_matches_reference():
    for block in (32, 256):
        gj, gp, n = _rcm_graphs()
        sj = J.to_sliding_packed(gj, block_size=block)
        sp = P.to_sliding_packed(gp, block_size=block)
        assert sp.num_padded_nodes == sj.num_padded_nodes
        assert sp.window_size == sj.window_size and sp.num_blocks == sj.num_blocks
        ws = np.asarray(sj.window_start).astype(np.int64)
        np.testing.assert_array_equal(sp.window_start.numpy(), ws)
        np.testing.assert_array_equal(sp.row_scale.numpy(), np.asarray(sj.row_scale))
        np.testing.assert_array_equal(sp.col_scale.numpy(), np.asarray(sj.col_scale))
        # The reference's ring columns read window-relative.
        prow, pbit = _packed_row_bit(sj.num_padded_nodes, block)
        ring = (np.asarray(sj.packed)[prow] >> pbit[:, None]) & 1
        rows = np.arange(sj.num_padded_nodes)
        cols = (ws[rows // block][:, None] + np.arange(sj.window_size)) % sj.ring_rows
        np.testing.assert_array_equal(P.window_mask(sp).numpy(),
                                      ring[rows[:, None], cols].astype(bool))
    with pytest.raises(ValueError, match="multiple of 32"):
        P.to_sliding_packed(gp, block_size=40)


def test_transpose_tables_on_a_packed_graph_equal_the_unpacked():
    s, r, n = _ordered(3, 128)
    kw = dict(window_size=128, block_size=32, superblock=4, transpose_tables=True)
    g = P.build_graph(s, r, n)
    dp, du = P.to_diag_window(g, packed=True, **kw), P.to_diag_window(g, **kw)
    for name in ("t_lo", "t_cnt", "attn_nbr", "attn_nbr_t"):
        assert torch.equal(getattr(dp, name), getattr(du, name)), name
    assert dp.t_max == du.t_max > 0
    moved = dp.to("meta")
    assert moved.s_pack.device.type == moved.r1_col.device.type == "meta"


# ------------------------------------------------------------ packed B1 / B4


@pytest.mark.parametrize("kw,f,prepadded", DIAG_CASES)
def test_spmm_diag_window_packed_matches_reference(kw, f, prepadded, same_rcm):
    dj, dp, gp, n = _diag_pair(kw)
    rows = dp.num_padded_nodes if prepadded else n
    x = np.random.default_rng(f + rows).normal(size=(rows, f)).astype(np.float32)
    if prepadded:
        x[n:] = 0.5  # pad rows hold finite garbage that no real row reads
    want = np.asarray(j_diag(dj, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    before = spmm_cuda.diag_window_spmm_packed.launches
    got = spmm_cuda.spmm_diag_window(dp, xt)
    assert spmm_cuda.diag_window_spmm_packed.launches == before  # CPU: plain
    assert got.shape == (rows, f)
    np.testing.assert_allclose(got[:n].numpy(), want[:n], **TOL)
    ref = aggregate(dp, xt, backend="reference")
    np.testing.assert_allclose(ref[:n].numpy(), want[:n], **TOL)
    np.testing.assert_allclose(aggregate_segment(gp, xt[:n]).numpy(), want[:n], **TOL)


@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
@pytest.mark.parametrize("esc2", [False, True], ids=["ell", "esc2"])
def test_packed_diag_composite_grad_matches_reference(batched, esc2, same_rcm):
    """Forward and x-gradient of the packed composite (packed B1 and B3
    unbatched, packed B4 and B10 batched, as plain versions) against
    ``jax.vjp`` of ``spmm_pallas.spmm_diag_window`` on the reference's
    packed graph."""
    dj, dp, _, n = _diag_pair(DIAG_CASES[1 if esc2 else 0][0])
    assert (dp.esc2_graph is not None) == esc2
    shape = (2, n, 24) if batched else (n, 24)
    rng = np.random.default_rng(31 + batched + 2 * esc2)
    x, cot = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want, vjp = jax.vjp(lambda v: j_diag(dj, v), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    got = spmm_cuda.spmm_diag_window(dp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)
    xp = torch.from_numpy(x).requires_grad_()
    (gp,) = torch.autograd.grad(spmm_cuda.spmm_diag_window(dp, xp, plain=True),
                                xp, torch.from_numpy(cot))
    np.testing.assert_allclose(gp.numpy(), np.asarray(want_gx), **TOL)


def test_packed_diag_bf16_matches_reference(same_rcm):
    dj, dp, _, n = _diag_pair(DIAG_CASES[1][0], jnp.bfloat16)
    rng = np.random.default_rng(7)
    x, cot = (rng.normal(size=(2, n, 32)).astype(np.float32) for _ in range(2))
    want, vjp = jax.vjp(lambda v: j_diag(dj, v), jnp.asarray(x, jnp.bfloat16))
    (want_gx,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    got = spmm_cuda.spmm_diag_window(dp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot).to(torch.bfloat16))
    assert got.dtype == gx.dtype == torch.bfloat16
    _bf16_close(got.detach().float(), want.astype(jnp.float32))
    _bf16_close(gx.float(), want_gx.astype(jnp.float32))


def test_packed_and_unpacked_composites_agree(same_rcm):
    s, r, n = _ordered(3, 128)
    g = P.build_graph(s, r, n)
    kw = DIAG_CASES[1][0]
    dp, du = P.to_diag_window(g, packed=True, **kw), P.to_diag_window(g, **kw)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, n, 16)).astype(np.float32))
    torch.testing.assert_close(spmm_cuda.spmm_diag_window(dp, x),
                               spmm_cuda.spmm_diag_window(du, x), **TOL)


def test_packed_plain_kernels_batched_equal_stacked_calls(same_rcm):
    _, dp, _, n = _diag_pair(DIAG_CASES[1][0])
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, dp.num_padded_nodes, 16)).astype(np.float32))
    fix = torch.from_numpy(rng.normal(size=(3, dp.escape.rows.shape[0], 16)).astype(np.float32))
    before = spmm_cuda.diag_window_spmm_packed_b.launches
    got = spmm_cuda.diag_window_spmm_packed_b(dp, x, fix)
    assert spmm_cuda.diag_window_spmm_packed_b.launches == before
    want = torch.stack([spmm_cuda.diag_window_spmm_packed(dp, x[b], fix[b])
                        for b in range(3)])
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError, match="3-d"):
        spmm_cuda.diag_window_spmm_packed_b(dp, x[0])
    with pytest.raises(ValueError, match="2-d"):
        spmm_cuda.diag_window_spmm_packed(dp, x)


@pytest.mark.parametrize("bad,exc,match", [
    ("bits", TypeError, "int32"),
    ("scale_dtype", TypeError, "float32"),
    ("scale_rows", ValueError, "source"),
    ("batched_3d", ValueError, "2-d x"),
    ("rows", ValueError, "128-row blocks"),
])
def test_packed_launch_rejects_bad_operands(bad, exc, match, fake_lib):
    """Packed B1 (the bit-row gather with one item) refuses what it does not
    take before anything launches, a batched x among them: packed B4 takes
    that."""
    _, dp, _, n = _diag_pair(DIAG_CASES[3][0])
    assert dp.block_size == 128
    x = torch.zeros(n, 8)
    if bad == "bits":
        dp = dataclasses.replace(dp, s_pack=dp.s_pack.long())
    elif bad == "scale_dtype":
        dp = dataclasses.replace(dp, r1_col=dp.r1_col.double())
    elif bad == "scale_rows":
        dp = dataclasses.replace(dp, r1_col=dp.r1_col[:100])
    elif bad == "batched_3d":
        x = x[None]
    elif bad == "rows":
        dp = dataclasses.replace(dp, s_pack=dp.s_pack[:-8])
    with pytest.raises(exc, match=match):
        spmm_cuda.diag_window_spmm_packed(dp, x)
    assert fake_lib.calls == []


# ---------------------------------------------------------------- B13


@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["unbatched", "batched"])
def test_spmm_sliding_packed_matches_reference(block, lead):
    """B13 (its plain version) behind ``aggregate`` against the reference's
    ``spmm_sliding_packed`` and the segment path, forward and x-gradient."""
    gj, gp, n = _rcm_graphs()
    sj = J.to_sliding_packed(gj, block_size=block)
    sp = P.to_sliding_packed(gp, block_size=block)
    rng = np.random.default_rng(block + len(lead))
    x, cot = (rng.normal(size=(*lead, n, 16)).astype(np.float32) for _ in range(2))
    want, vjp = jax.vjp(lambda v: j_sliding_packed(sj, v), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    before = spmm_cuda.sliding_packed_spmm.launches
    got = aggregate(sp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    assert spmm_cuda.sliding_packed_spmm.launches == before  # CPU: plain
    assert got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)
    seg = aggregate_segment(gp, torch.from_numpy(x))
    np.testing.assert_allclose(seg.numpy(), np.asarray(want), **TOL)
    ref = aggregate(sp, torch.from_numpy(x), backend="reference")
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


def test_spmm_sliding_packed_bf16_matches_reference():
    gj, gp, n = _rcm_graphs()
    sj, sp = J.to_sliding_packed(gj), P.to_sliding_packed(gp)
    x = np.random.default_rng(12).normal(size=(2, n, 32)).astype(np.float32)
    want = j_sliding_packed(sj, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
    got = aggregate(sp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float(), want)
    # The plain version folds the scales as the kernel does; the reference
    # of the port scales outside, as the reference package.
    _bf16_close(aggregate(sp, torch.from_numpy(x).to(torch.bfloat16),
                          backend="reference").float(), want)


def test_sliding_packed_pre_padded_rows_and_layout_moves():
    _, gp, n = _rcm_graphs(2)
    sp = P.to_sliding_packed(gp, block_size=32)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(n, 8)).astype(np.float32))
    xp = torch.cat([x, torch.full((sp.num_padded_nodes - n, 8), 0.5)])
    got = aggregate(sp, xp)
    assert got.shape == (sp.num_padded_nodes, 8)
    torch.testing.assert_close(got[:n], aggregate(sp, x))
    assert (got[n:] == 0).all()  # row scale 0 on padding
    moved = sp.to("meta")
    assert moved.s_pack.device.type == moved.row_scale.device.type == "meta"


# ------------------------------------------------------------ attention


def _attn_pair():
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.kd_patch_order(verts, s, r, n, leaf_size=64), s, r)
    kw = dict(window_size=128, block_size=32, superblock=4,
              transpose_tables=True, packed=True)
    return J.to_diag_window(J.build_graph(s, r, n), **kw), \
        P.to_diag_window(P.build_graph(s, r, n), **kw), n


def test_windowed_attention_on_a_packed_graph_matches_reference():
    """The reference's ``mp`` kernels unpack the S01 bits per tile; the
    port's lists come from the same bits. Forward and q/k/v gradients."""
    dj, dp, n = _attn_pair()
    assert dp.s_mat is None and dj.s_mat is None
    rng = np.random.default_rng(17)
    q, k, v, g = (rng.normal(size=(n, 32)).astype(np.float32) for _ in range(4))
    want, vjp = jax.vjp(lambda a, b, c: j_windowed(dj, a, b, c),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_g = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = windowed_attention(dp, *ts)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    for t, w, name in zip(ts, want_g, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")
    plain = windowed_attention(dp, *map(torch.from_numpy, (q, k, v)), backend="plain")
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------- the whole slice


@pytest.mark.parametrize("processor", ["gcn", "attention"])
def test_epd_on_a_packed_graph_matches_reference(processor, same_rcm):
    """The encode-process-decode model on a packed diag graph: the forward
    and one train step's loss and gradients against the reference, with
    parameters converted by ``params_from_jax``. GCN at latent 128 takes
    the pre-padded state through packed B4; attention the neighbour lists
    built from the bits."""
    if processor == "gcn":
        dj, dp, _, n = _diag_pair(DIAG_CASES[1][0])
        latent = 128
    else:
        dj, dp, n = _attn_pair()
        latent = 64
    jm = JaxEPD(channels_in=2, channels_out=2, latent_size=latent,
                process_steps=2, processor=processor)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    pm = EncodeProcessDecode(2, 2, device="cpu", latent_size=latent,
                             process_steps=2, processor=processor)
    pm.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(19)
    x = rng.normal(size=(2, n, 2)).astype(np.float32)
    y = (0.9 * x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    want = np.asarray(jm.apply(params, dj, jnp.asarray(x[0])))
    np.testing.assert_allclose(pm(dp, torch.from_numpy(x[0])).detach().numpy(),
                               want, **TOL)
    (j_loss, _), j_grads = jax.value_and_grad(j_loss_fn(jm), has_aux=True)(
        params, (jnp.asarray(x), jnp.asarray(y)), dj)
    loss, _ = mesh_graph_loss_fn(pm)((torch.from_numpy(x), torch.from_numpy(y)), dp)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), **TOL)
    want_g = _flat(j_grads)
    grads = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert set(grads) == set(want_g)
    for k in grads:
        np.testing.assert_allclose(grads[k], want_g[k], **TOL, err_msg=k)


@pytest.mark.parametrize("kernel", ["diag_packed", "packed"])
def test_kernel_calls_per_step_on_the_packed_layouts(kernel, same_rcm, monkeypatch):
    """``chip_smoke.expected_launches`` for the packed layouts against the
    calls one batched GCN train step makes, counted at the plain versions
    the wrappers run on the CPU."""
    import chip_smoke
    from gwen_tpu_torch.ops import fused_ln

    calls = dict.fromkeys(("B4p", "B10", "B13", "B2", "B2b"), 0)

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    for key, mod, name in (("B4p", spmm_cuda, "diag_window_spmm_packed_plain"),
                           ("B10", spmm_cuda, "sliding_spmm_plain"),
                           ("B13", spmm_cuda, "sliding_packed_spmm_plain"),
                           ("B2", fused_ln, "residual_layernorm_plain"),
                           ("B2b", fused_ln, "residual_layernorm_bwd_plain")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    if kernel == "diag_packed":
        _, graph, _, n = _diag_pair(DIAG_CASES[1][0])
    else:
        _, gp, n = _rcm_graphs()
        graph = P.to_sliding_packed(gp, block_size=32)
    pm = EncodeProcessDecode(2, 2, device="cpu", latent_size=128, process_steps=2)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, n, 2)).astype(np.float32))
    loss, _ = mesh_graph_loss_fn(pm)((x, 0.5 * x), graph)
    loss.backward()
    want = chip_smoke.expected_launches(False, 2, "gcn", kernel)
    assert calls == {k: want[k] for k in calls}


def test_bf16_graph_dtype_does_not_touch_the_bits(same_rcm):
    """``dtype`` sets the esc2 graph's S only: the bits and scales of a
    packed graph are the same for float32 and bf16."""
    _, d32, _, _ = _diag_pair(DIAG_CASES[1][0])
    _, d16, _, _ = _diag_pair(DIAG_CASES[1][0], jnp.bfloat16)
    assert torch.equal(d32.s_pack, d16.s_pack)
    assert torch.equal(d32.r1_col, d16.r1_col)
    assert d16.esc2_graph.s_mat.dtype == torch.bfloat16
    same = dataclasses.replace(d16, esc2_graph=d32.esc2_graph)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(d32.num_nodes, 8)).astype(np.float32))
    torch.testing.assert_close(spmm_cuda.spmm_diag_window(same, x),
                               spmm_cuda.spmm_diag_window(d32, x))
