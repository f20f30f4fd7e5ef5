"""The port's attention processor against the reference (CPU).

Small graphs: the L2/L3 icosphere in KD-patch order, block 32, window 128,
superblock 2-4, as the reference's ``tests/test_attention.py``. The JAX
side runs its Pallas kernels in interpret mode; the port runs its kernels'
plain versions (CPU tensors). Inputs come from numpy seeds and parameters
are converted from the JAX param tree with ``params_from_jax``. float32
results are held to rtol = atol = 1e-4.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu.nn.attention import graph_attention_apply as j_attn_apply
from gwen_tpu.nn.attention import graph_attention_init as j_attn_init
from gwen_tpu.ops.attention_pallas import windowed_attention as j_windowed
from gwen_tpu.train import Trainer as JTrainer
from gwen_tpu.train import TrainState as JState
from gwen_tpu.train.optim import make_optimizer as j_make_optimizer
from gwen_tpu.train.tasks import mesh_graph_loss_fn as j_loss_fn
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax, params_to_tree
from gwen_tpu_torch.nn import attention as attn_module
from gwen_tpu_torch.nn.attention import graph_attention_apply, graph_attention_init
from gwen_tpu_torch.ops import attention_cuda
from gwen_tpu_torch.ops.attention import windowed_attention
from gwen_tpu_torch.registry import Registry
from gwen_tpu_torch.serve import ServingModel, export_model, model_from_metadata
from gwen_tpu_torch.train import Trainer, TrainState, make_optimizer, mesh_graph_loss_fn
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)
from test_torch_train import _flat

TOL = dict(rtol=1e-4, atol=1e-4)
CH, BATCH, STEPS = 2, 2, 2


def _graphs(levels=3, window=128, block=32, superblock=4, dtype=np.float32):
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    perm = J.kd_patch_order(verts, s, r, n, leaf_size=64)
    s, r, _ = J.apply_order(perm, s, r)
    kw = dict(window_size=window, block_size=block, superblock=superblock,
              transpose_tables=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return (J.to_diag_window(J.build_graph(s, r, n), dtype=dtype, **kw),
            P.to_diag_window(P.build_graph(s, r, n), dtype=tdt, **kw), n)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("levels,window,superblock", [(3, 128, 4), (2, 128, 2),
                                                      (3, 256, 2)])
def test_transpose_tables_match_reference(levels, window, superblock):
    dj, dp, _ = _graphs(levels, window, superblock=superblock)
    np.testing.assert_array_equal(dp.t_lo.numpy(), np.asarray(dj.t_lo))
    np.testing.assert_array_equal(dp.t_cnt.numpy(), np.asarray(dj.t_cnt))
    assert dp.t_max == dj.t_max > 0
    # The attach is idempotent and a plain graph has none.
    assert P.diag_transpose_tables(dp) is dp
    plain = P.to_diag_window(P.build_graph(*J.icosphere_edges(2)[1:], 162),
                             window_size=128, block_size=32)
    assert plain.t_max == 0 and plain.attn_nbr is None


def test_attention_tables_hold_exactly_the_mask():
    _, dp, _ = _graphs()
    s = dp.s_mat.numpy()
    starts = dp.window_start.numpy().astype(np.int64)
    rows, cols = np.nonzero(s)
    want = set(zip(rows.tolist(), (starts[rows // dp.block_size] + cols).tolist()))
    nbr, nbr_t = dp.attn_nbr.numpy(), dp.attn_nbr_t.numpy()
    assert nbr.shape[0] == dp.num_padded_nodes
    assert nbr_t.shape[0] == dp.num_src_rows
    assert nbr.dtype == nbr_t.dtype == np.int32
    fwd = [(i, int(j)) for i in range(nbr.shape[0]) for j in nbr[i] if j >= 0]
    bwd = [(int(i), c) for c in range(nbr_t.shape[0]) for i in nbr_t[c] if i >= 0]
    assert len(fwd) == len(set(fwd)) == len(want) and set(fwd) == want
    assert len(bwd) == len(set(bwd)) == len(want) and set(bwd) == want
    # -1 only as padding after a row's entries; entries ascend.
    for table in (nbr, nbr_t):
        valid = table >= 0
        assert (valid[:, :-1] | ~valid[:, 1:]).all()
        for row in table:
            row = row[row >= 0]
            assert (np.diff(row) > 0).all()
    moved = dp.to("meta")
    assert moved.attn_nbr.device.type == moved.t_lo.device.type == "meta"


# --------------------------------------------------------- windowed attention


@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "batched"])
@pytest.mark.parametrize("dh", [32, 48])
def test_windowed_attention_forward_matches_reference(lead, dh):
    dj, dp, n = _graphs()
    q, k, v = _rand(dh + len(lead), *[(*lead, n, dh)] * 3)
    want = np.asarray(j_windowed(dj, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = windowed_attention(dp, *map(torch.from_numpy, (q, k, v)))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = windowed_attention(dp, *map(torch.from_numpy, (q, k, v)),
                               backend="plain")
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


@pytest.mark.parametrize("lead", [(), (2, 2)], ids=["2d", "batched"])
def test_windowed_attention_grads_match_reference(lead):
    """dq, dk, dv through ``jax.vjp`` of the reference against the port's
    Function, whose backward runs the plain versions of B6 and B7."""
    dj, dp, n = _graphs()
    q, k, v, g = _rand(7, *[(*lead, n, 32)] * 4)
    _, vjp = jax.vjp(lambda a, b, c: j_windowed(dj, a, b, c),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, k, v)
    windowed_attention(dp, tq, tk, tv).backward(torch.from_numpy(g))
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_matches_autograd_through_plain_forward(dtype):
    _, dp, n = _graphs(dtype=jnp.bfloat16 if dtype == torch.bfloat16 else np.float32)
    q, k, v, g = _rand(9, *[(2, n, 64)] * 4)
    grads = []
    for backend in ("auto", "plain"):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
        out = windowed_attention(dp, *ts, backend=backend)
        out.backward(torch.from_numpy(g).to(dtype))
        grads.append([out.detach().float()] + [t.grad.float() for t in ts])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want, name in zip(*grads, ["out", "dq", "dk", "dv"]):
        bound = tol * want.abs().max().item()
        assert (got - want).abs().max().item() <= bound, name


def test_stats_and_plain_backward_pieces():
    """The plain B6 returns the reference's row stats; the plain B7 from
    those stats gives what autograd gives."""
    _, dp, n = _graphs()
    q, k, v, g = map(torch.from_numpy, _rand(11, *[(n, 32)] * 4))
    scale = 32 ** -0.5
    dq, stats = attention_cuda.attention_dq_plain(dp, q, k, v, g, scale)
    assert stats.shape == (n, 3) and stats.dtype == torch.float32
    assert (stats[:, 1] > 0).all()  # every mesh row attends to itself
    dk, dv = attention_cuda.attention_dkdv_plain(dp, q, k, v, g, stats, scale)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    attention_cuda.attention_fwd_plain(dp, *ts, scale).backward(g)
    for got, t in zip((dq, dk, dv), ts):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **TOL)


def test_pad_rows_and_an_isolated_row_give_zero():
    """Destination rows with no source (pad rows of a pre-padded q, and a
    node with no edge) give 0 and no NaN, and pad rows' q and g add nothing
    to dK/dV."""
    verts, s, r = J.icosphere_edges(2)
    n = verts.shape[0]
    keep = (s != 5) & (r != 5)  # node 5 keeps no edge, not even a self-loop
    s, r = s[keep], r[keep]
    gj = J.build_graph(s, r, n, self_loops=False)
    kw = dict(window_size=128, block_size=32, superblock=2, transpose_tables=True)
    dj = J.to_diag_window(gj, **kw)
    dp = P.to_diag_window(P.build_graph(s, r, n, self_loops=False), **kw)
    rows = dp.num_padded_nodes
    assert rows > n and not (dp.attn_nbr[5] >= 0).any()
    q, k, v, g = _rand(13, (rows, 32), (n, 32), (n, 32), (rows, 32))
    tq, tk, tv = _t(q, k, v)
    out = windowed_attention(dp, tq, tk, tv)
    out.backward(torch.from_numpy(g))
    assert torch.isfinite(out).all()
    assert (out[5] == 0).all() and (out[n:] == 0).all()
    assert (tq.grad[5] == 0).all() and (tq.grad[n:] == 0).all()
    want = j_windowed(dj, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    g0 = g.copy()
    g0[n:] = 0
    q0 = q.copy()
    q0[n:] = 0
    tq0, tk0, tv0 = _t(q0, k, v)
    windowed_attention(dp, tq0, tk0, tv0).backward(torch.from_numpy(g0))
    torch.testing.assert_close(tk.grad, tk0.grad, rtol=0, atol=0)
    torch.testing.assert_close(tv.grad, tv0.grad, rtol=0, atol=0)


def test_windowed_attention_refusals():
    dj, dp, n = _graphs(levels=2)
    x = torch.zeros(n, 32)
    with pytest.raises(ValueError, match="unknown backend"):
        windowed_attention(dp, x, x, x, backend="fused")
    bare = P.to_diag_window(P.build_graph(*J.icosphere_edges(2)[1:], n),
                            window_size=128, block_size=32)
    with pytest.raises(ValueError, match="transpose tables"):
        windowed_attention(bare, x, x, x)
    with pytest.raises(TypeError, match="DiagWindowGraph"):
        windowed_attention(P.build_graph(*J.icosphere_edges(2)[1:], n), x, x, x)
    with pytest.raises(ValueError, match="explicit scale"):
        windowed_attention(dp, *[torch.zeros(n, 128)] * 3, pack=True)
    with pytest.raises(ValueError, match="f=64"):
        windowed_attention(dp, *[torch.zeros(n, 64)] * 3, pack=True, scale=1.0)


def test_pack_splits_into_sub_heads_like_the_reference():
    dj, dp, n = _graphs()
    q, k, v = _rand(15, *[(2, n, 128)] * 3)
    for a in (q, k, v):  # sub-heads of width 48, zero-padded to 64 lanes
        a[..., 48:64] = 0
        a[..., 112:] = 0
    want = j_windowed(dj, *map(jnp.asarray, (q, k, v)), pack=True, scale=48 ** -0.5)
    got = windowed_attention(dp, *map(torch.from_numpy, (q, k, v)), pack=True,
                             scale=48 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _zeros(spec):
    """A zero operand: ``spec`` is its shape, or ``("strided", shape)`` (every
    second value of a row twice as wide: an inner stride of 2) or
    ``("offset", shape)`` (rows starting 4 bytes past a 16-byte boundary) or
    ``("wide", shape)`` (rows in place, twice as far apart)."""
    if spec[0] == "strided":
        return torch.zeros(*spec[1][:-1], 2 * spec[1][-1])[..., ::2]
    if spec[0] == "offset":
        return torch.zeros(math.prod(spec[1]) + 1)[1:].view(spec[1])
    if spec[0] == "wide":  # the first columns of rows twice as long
        return torch.zeros(*spec[1][:-1], 2 * spec[1][-1])[..., :spec[1][-1]]
    return torch.zeros(spec)


@pytest.mark.parametrize("shapes,exc", [
    ((("strided", (8, 32)), (8, 32), (8, 32)), ValueError),  # inner stride 2
    (((8, 32), (8, 32), (9, 32)), ValueError),  # v unlike k
    (((8, 600),) * 3, ValueError),  # head over 512
    (((2, 8, 32), (3, 8, 32), (3, 8, 32)), ValueError),  # items differ
    (((8, 32), ("offset", (8, 32)), (8, 32)), ValueError),  # misaligned rows
    (((8, 32), (8, 32), ("wide", (8, 32))), ValueError),  # v not in k's layout
])
def test_kernel_operand_checks_refuse(shapes, exc):
    """The kernels' own check, on operands as the wrappers hand them over:
    a row whose values are not consecutive, or whose start is not 16-byte
    aligned, and a v whose strides are not k's, are refused (the wrappers
    copy such an operand first)."""
    _, dp, _ = _graphs(levels=2)
    q, k, v = (_zeros(s) for s in shapes)
    with pytest.raises(exc):
        attention_cuda.check_operands(dp, q, k, v)
    with pytest.raises(TypeError):
        attention_cuda.check_operands(dp, *(torch.zeros(8, 32, dtype=torch.float16),) * 3)


# --------------------------------------------------------- attention module


@pytest.mark.parametrize("heads,dh", [(2, 32), (4, 16)])
def test_graph_attention_apply_matches_reference(heads, dh):
    """Forward and gradients in x and every parameter; at 4 heads of 16 the
    reference lane-packs head pairs, the port runs each head at its own
    width."""
    dj, dp, n = _graphs()
    latent = heads * dh
    params = jax.tree_util.tree_map(np.asarray,
                                    j_attn_init(jax.random.key(heads), latent, heads))
    x, g = _rand(heads, (BATCH, n, latent), (BATCH, n, latent))

    def j_fn(p, xx):
        return j_attn_apply(p, dj, xx, heads=heads)

    want, vjp = jax.vjp(j_fn, params, jnp.asarray(x))
    j_dp, j_dx = vjp(jnp.asarray(g))
    mod = graph_attention_init(latent, heads, torch.Generator().manual_seed(0), "cpu")
    mod.load_state_dict(params_from_jax(params))
    tx = torch.from_numpy(x).requires_grad_()
    outs = [graph_attention_apply(mod, dp, tx, heads=heads, pack=pack)
            for pack in (None, True, False)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(want), **TOL)
    outs[0].backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), **TOL)
    want_p = _flat(j_dp)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_p[name], **TOL, err_msg=name)


@pytest.mark.parametrize("dh,copies", [(128, 0), (48, 3 + 4 + 4)])
def test_graph_attention_apply_launches_on_the_products_rows(dh, copies, fake_lib,
                                                             monkeypatch):
    """At 2 heads, B5, B6 and B7 read q, k, v and the output cotangent in
    the ``(B, N, H·dh)`` rows of their products and write the output and
    dq, dk, dv in that layout: each launch gets the product's own
    ``data_ptr()``, head 0's offset, and the strides head (dh), batch item
    (N·H·dh) and row (H·dh); the output projection reads the buffer B5
    wrote, and each product's backward gets the buffer B6 or B7 wrote, as
    views. No operand is copied at dh 128; at dh 48 every operand is
    zero-padded to 64 lanes, one counted copy each (3 forward, 4 a
    backward launch)."""
    heads, latent, batch = 2, 2 * dh, 2
    _, dp, n = _graphs(levels=2)
    mod = graph_attention_init(latent, heads, torch.Generator().manual_seed(0), "cpu")
    products, inputs, grads = {}, {}, {}
    plain_linear = attn_module.core.linear_apply

    def linear_apply(p, x):
        name = next(k for k in ("wq", "wk", "wv", "wo") if mod[k] is p)
        inputs[name] = x
        if name == "wo":
            x.register_hook(lambda g: grads.setdefault("o", g))
        y = products[name] = plain_linear(p, x)
        y.register_hook(lambda g: grads.setdefault(name, g))
        return y

    monkeypatch.setattr(attn_module.core, "linear_apply", linear_apply)
    x = torch.zeros(batch, n, latent, requires_grad=True)
    before = attention_cuda.operand_copies
    graph_attention_apply(mod, dp, x, heads=heads).sum().backward()
    assert attention_cuda.operand_copies == before + copies
    assert [c[0] for c in fake_lib.calls] == ["gwen_attn_fwd", "gwen_attn_dq",
                                              "gwen_attn_dkdv"]
    (_, a5), (_, a6), (_, a7) = fake_lib.calls
    if copies:
        assert {a5[0], a5[1], a5[2]}.isdisjoint(
            products[k].data_ptr() for k in ("wq", "wk", "wv"))
        return
    layout = [dh, n * latent, latent]
    ptr = {k: t.data_ptr() for k, t in products.items()}
    assert list(a5[:3]) == [ptr["wq"], ptr["wk"], ptr["wv"]]
    assert a5[4] == inputs["wo"].data_ptr()
    assert list(a5[5]) == layout * 2
    assert list(a5[6:10]) == [heads * batch, batch, n, n]
    assert list(a6[:4]) == [ptr["wq"], ptr["wk"], ptr["wv"], grads["o"].data_ptr()]
    assert a6[5] == grads["wq"].data_ptr()
    assert list(a6[7]) == layout * 2
    assert list(a7[:4]) == list(a6[:4])
    assert [a7[6], a7[7]] == [grads["wk"].data_ptr(), grads["wv"].data_ptr()]
    assert list(a7[8]) == layout * 2
    for k in ("wq", "wk", "wv"):
        assert grads[k].is_contiguous() and grads[k].shape == (batch * n, latent)


def test_v_and_g_are_copied_into_k_and_q_layouts(fake_lib):
    """The kernels address v through k's strides and g through q's: a v or
    g in place but laid out otherwise is copied into its partner's layout,
    one counted copy, and launched from the copy; outputs take q's and k's
    layouts."""
    _, dp, n = _graphs(levels=2)
    q, k = torch.zeros(2, n, 32), torch.zeros(2, n, 32)
    v, g = _zeros(("wide", (2, n, 32))), _zeros(("wide", (2, n, 32)))
    before = attention_cuda.operand_copies
    out = attention_cuda.attention_fwd(dp, q, k, v, 1.0)
    assert attention_cuda.operand_copies == before + 1
    dq, stats = attention_cuda.attention_dq(dp, q, k, v, g, 1.0)
    dk, dv = attention_cuda.attention_dkdv(dp, q, k, v, g, stats, 1.0)
    assert attention_cuda.operand_copies == before + 1 + 2 + 2
    (_, a5), (_, a6), (_, a7) = fake_lib.calls
    assert a5[2] != v.data_ptr() and a6[3] != g.data_ptr()
    assert a5[:2] == (q.data_ptr(), k.data_ptr())
    assert out.stride() == dq.stride() == q.stride() and dk.stride() == dv.stride() == k.stride()


def _strided_and_contiguous(attend, graph, n_rows, heads=2, dh=32, batch=2,
                            seed=4):
    """Outputs and gradients of ``attend`` on q, k and v as the model passes
    them (views ``(H, B, N, dh)`` of ``(B, N, H·dh)`` products) and on
    contiguous copies of the same values, the gradients read back in the
    products' layout."""
    ys = [torch.from_numpy(a) for a in _rand(seed, *[(batch, n_rows, heads * dh)] * 3)]
    cot = torch.from_numpy(_rand(seed + 1, (heads, batch, n_rows, dh))[0])

    def heads_first(y):
        return y.view(batch, n_rows, heads, dh).movedim(-2, 0)

    strided = [y.clone().requires_grad_() for y in ys]
    out_s = attend(graph, *(heads_first(y) for y in strided))
    out_s.backward(cot)
    flat = [heads_first(y).contiguous().requires_grad_() for y in ys]
    assert all(f.is_contiguous() for f in flat)
    out_c = attend(graph, *flat)
    out_c.backward(cot)
    grads_c = [f.grad.movedim(0, -2).reshape(batch, n_rows, heads * dh) for f in flat]
    return (out_s, [y.grad for y in strided]), (out_c, grads_c)


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_strided_operands_give_the_gradients_of_contiguous_copies(backend):
    """``windowed_attention`` on the products' strided views: the output
    and the gradients in q, k and v equal those through contiguous copies,
    bit for bit, on the Function (``"auto"``: the kernels' plain versions
    on the CPU) and on the plain forward under autograd."""
    _, dp, n = _graphs(levels=2)
    (out_s, g_s), (out_c, g_c) = _strided_and_contiguous(
        lambda gr, q, k, v: windowed_attention(gr, q, k, v, backend=backend), dp, n)
    torch.testing.assert_close(out_s, out_c, rtol=0, atol=0)
    for a, b in zip(g_s, g_c):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_graph_attention_rejects_a_graph_without_the_diag_layout():
    _, dp, n = _graphs(levels=2)
    mod = graph_attention_init(32, 2, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(TypeError, match="DiagWindowGraph"):
        graph_attention_apply(mod, P.build_graph(*J.icosphere_edges(2)[1:], n),
                              torch.zeros(n, 32))
    with pytest.raises(ValueError, match="not divisible"):
        graph_attention_init(32, 3, torch.Generator(), "cpu")


# ---------------------------------------------------------------- the model


def _models(jdtype=jnp.float32, tdtype=torch.float32, remat=False, latent=64,
            heads=2):
    jm = JaxEPD(channels_in=CH, channels_out=CH, latent_size=latent,
                process_steps=STEPS, compute_dtype=jdtype,
                processor="attention", attn_heads=heads)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    pm = EncodeProcessDecode(CH, CH, device="cpu", latent_size=latent,
                             process_steps=STEPS, compute_dtype=tdtype,
                             processor="attention", attn_heads=heads,
                             remat=remat)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm


def _batch(n, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, n, CH)).astype(np.float32)
    return x, (0.9 * x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epd_attention_train_step_matches_reference(dtype):
    """One batched attention EPD train step: loss, every gradient, and the
    params after one Adam step, against the reference's ``Trainer`` step
    (the tolerances of ``test_epd_train_step_matches_reference``)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    dj, dp, n = _graphs(dtype=jdt)
    jm, params, pm = _models(jdt, tdt)
    assert "process_1.attn.wo.w" in pm.state_dict()
    x, y = _batch(n)
    j_fn = j_loss_fn(jm)
    (j_loss, _), j_grads = jax.value_and_grad(j_fn, has_aux=True)(
        params, (jnp.asarray(x), jnp.asarray(y)), dj)
    opt = j_make_optimizer(1e-3)
    jt = JTrainer(loss_fn=j_fn, optimizer=opt, context=dj)
    j_state, _ = jt._train_step(JState.create(params, opt),
                                (jnp.asarray(x), jnp.asarray(y)), jt.context)

    loss_fn = mesh_graph_loss_fn(pm)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    loss, preds = loss_fn(batch, dp)
    assert preds.shape == (BATCH, n, CH)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    state = TrainState(pm, make_optimizer(pm.parameters(), 1e-3))
    Trainer(loss_fn, "cpu", context=dp).train_step(state, batch)

    want_g, want_p = _flat(j_grads), _flat(j_state.params)
    assert set(grads) == set(want_g)
    # A key bias shifts every score of a row alike, and softmax ignores
    # that: the gradient of wk.b is zero but for rounding, in both
    # frameworks. It is held to that; Adam's first step there follows the
    # sign of the rounding noise, so its params are not compared.
    scale = max(np.abs(g).max() for g in want_g.values())
    for k in [k for k in grads if k.endswith("attn.wk.b")]:
        assert np.abs(grads.pop(k)).max() <= 1e-3 * scale, k
        assert np.abs(want_g[k]).max() <= 1e-3 * scale, k
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(j_loss), **TOL)
        for k in grads:
            np.testing.assert_allclose(grads[k], want_g[k], **TOL, err_msg=k)
    else:  # bf16 rounds at other places in the two frameworks
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-2)
        for k in grads:
            np.testing.assert_allclose(grads[k], want_g[k], rtol=1e-2,
                                       atol=1e-2 * np.abs(want_g[k]).max(),
                                       err_msg=k)
    for k, p in pm.named_parameters():
        if k not in grads:
            continue
        got = p.detach().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want_p[k], **TOL, err_msg=k)
        else:
            g = np.abs(want_g[k])
            sure = g > 1e-2 * g.max()
            np.testing.assert_allclose(got[sure], want_p[k][sure], rtol=0,
                                       atol=1e-5, err_msg=k)


REMAT = [True, "save_agg", "save_agg:1", "nested:1", "nested:2"]


@pytest.mark.parametrize("remat", REMAT, ids=[str(r) for r in REMAT])
def test_attention_remat_policies_give_the_same_gradients(remat):
    _, dp, n = _graphs()
    x, y = _batch(n, seed=4)
    grads = []
    for policy in (False, remat):
        _, _, pm = _models(remat=policy)
        loss, _ = mesh_graph_loss_fn(pm)((torch.from_numpy(x), torch.from_numpy(y)), dp)
        loss.backward()
        grads.append({k: p.grad for k, p in pm.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True, "save_agg", "save_agg:1",
                                   "nested:1", "nested:2"])
def test_attention_kernel_calls_per_step_follow_the_remat_policy(remat, monkeypatch):
    """``chip_smoke.expected_launches`` for the attention processor against
    the calls one batched train step makes, counted on the CPU at the plain
    versions the wrappers run there."""
    import chip_smoke
    from gwen_tpu_torch.ops import fused_ln

    calls = {"B5": 0, "B6": 0, "B7": 0, "B2": 0, "B2b": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    for key, mod, name in (("B5", attention_cuda, "attention_fwd_plain"),
                           ("B6", attention_cuda, "attention_dq_plain"),
                           ("B7", attention_cuda, "attention_dkdv_plain"),
                           ("B2", fused_ln, "residual_layernorm_plain"),
                           ("B2b", fused_ln, "residual_layernorm_bwd_plain")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    _, dp, n = _graphs()
    _, _, pm = _models(remat=remat, latent=128)  # the fused LN needs F % 128 == 0
    x, y = _batch(n, seed=6)
    loss, _ = mesh_graph_loss_fn(pm)((torch.from_numpy(x), torch.from_numpy(y)), dp)
    loss.backward()
    want = chip_smoke.expected_launches(remat, STEPS, processor="attention")
    assert calls == {k: want[k] for k in calls}
    assert want["B1"] == want["B4"] == want["B3"] == want["B10"] == 0


# ------------------------------------------------------- train-mesh, serving


def test_train_mesh_attention_trains_and_serves_like_the_reference(tmp_path, capsys):
    """``train-mesh model.processor=attention`` on the CPU takes the
    diag-window layout with transpose tables; its exported run serves
    ``predict`` to the trajectory the reference model gives with the same
    params."""
    root = tmp_path / "runs"
    rc = cli(["train-mesh", "model.processor=attention", "graph.refine=3",
              "model.latent_size=64", "model.process_steps=2",
              "model.compute_dtype=float32", "train.batch_size=4",
              f"run.registry_root={root}", "--members", "3", "--steps", "5",
              "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["layout"] == "DiagWindowGraph" and out["steps"] == 2
    assert np.isfinite(out["best_train_loss"])
    params, cfg = Registry(root).load_best_model("GWEN_MESH")
    assert cfg["processor"] == "attention" and cfg["attn_heads"] == 2
    model = model_from_metadata(cfg, "cpu")
    assert model.processor == "attention" and model.attn_heads == 2
    model.load_state_dict(params)
    n = out["nodes"]
    art = export_model(model, np.zeros((n, 1), np.float32), tmp_path / "art",
                       metadata=cfg)
    x0 = np.random.default_rng(3).normal(size=(n, 1)).astype(np.float32)
    np.save(tmp_path / "x0.npy", x0)
    assert cli(["predict", "--artifact", str(art), "--input",
                str(tmp_path / "x0.npy"), "--steps", "2", "--out",
                str(tmp_path / "y.npy"), "--device", "cpu"]) == 0
    got = np.load(tmp_path / "y.npy")
    assert ServingModel.load(art, "cpu").graph.t_max > 0

    verts, s, r = J.icosphere_edges(3)
    perm = J.kd_patch_order(verts, s, r, n)
    s2, r2, _ = J.apply_order(perm, s, r)
    dj = J.to_diag_window(J.build_graph(s2, r2, n), window_size=384,
                          transpose_tables=True)
    jm = JaxEPD(channels_in=1, channels_out=1, latent_size=64, process_steps=2,
                processor="attention", attn_heads=2)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params_to_tree(params))
    x = jnp.asarray(x0[perm])
    want = []
    for _ in range(2):
        x = jm.apply(jparams, dj, x)
        want.append(np.asarray(x))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    np.testing.assert_allclose(got, np.stack(want)[:, inv], rtol=1e-3, atol=1e-3)


def test_train_mesh_attention_refuses_other_kernels(tmp_path):
    with pytest.raises(ValueError, match="requires mesh.kernel"):
        cli(["train-mesh", "model.processor=attention", "mesh.kernel=sliding",
             f"run.registry_root={tmp_path}", "--device", "cpu"])
