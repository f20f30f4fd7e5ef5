"""The port's block-tile, int8 rank-1, dense and multi-level containers
against the reference package on the CPU.

Same numpy inputs through both packages. On CPU tensors the port's kernel
wrappers run their plain versions; the reference runs its Pallas kernels in
interpret mode, as its own tests do. float32 at ``rtol = atol = 1e-4`` (as
``tests/test_spmm.py``), bf16 at ``1e-2 · max|reference|``. Every ordering
is computed once and handed to both packages, so no test depends on which
RCM implementation a package picks.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops import aggregate as j_aggregate
from gwen_tpu.ops import aggregate_segment as j_segment
from gwen_tpu.ops.spmm_pallas import spmm_block_tiles as j_tiles
from gwen_tpu.ops.spmm_pallas import spmm_sliding_rank1 as j_rank1
from gwen_tpu_torch.nn import EncodeProcessDecode, gcn_apply, params_from_jax
from gwen_tpu_torch.ops import aggregate, aggregate_segment, spmm_cuda
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)


def _rcm_mesh(levels):
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    s2, r2, _ = J.apply_order(J.rcm_order(s, r, n), s, r)
    return s2, r2, n


def _random_graph(n=300, seed=3):
    s, r = J.erdos_renyi_edges(n, 0.03, seed=seed)
    # Symmetrized: the layouts' backward is the operator itself.
    pairs = np.unique(np.stack([np.concatenate([s, r]),
                                np.concatenate([r, s])], 1), axis=0)
    return pairs[:, 0], pairs[:, 1], n


MESHES = {"L2": lambda: _rcm_mesh(2), "L3": lambda: _rcm_mesh(3),
          "random": _random_graph}


@pytest.fixture(scope="module")
def graphs():
    """Per mesh: the edges, both COO graphs and both block-tile graphs
    (block 32, so that L2 and L3 have several blocks and tiles)."""
    out = {}
    for name, make in MESHES.items():
        s, r, n = make()
        jg, pg = J.build_graph(s, r, n), P.build_graph(s, r, n)
        out[name] = dict(s=s, r=r, n=n, jg=jg, pg=pg,
                         jt=J.to_block_tiles(jg, block_size=32),
                         pt=P.to_block_tiles(pg, block_size=32))
    return out


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _assert_tiles_equal(pt, jt):
    # Same content tile slot for tile slot; the port keeps neither of the
    # reference's lane paddings (tile_degree to 8, the slot axis to 128).
    tm, dj, dp = jt.tiles_max, jt.tile_degree, pt.tile_degree
    assert (pt.tiles_max, pt.block_size, pt.num_src_rows) == (
        tm, jt.block_size, jt.num_src_rows)
    assert 1 <= dp <= dj < dp + 8
    assert (pt.num_nodes, pt.num_edges, pt.num_padded_nodes) == (
        jt.num_nodes, jt.num_edges, jt.num_padded_nodes)
    n_pad = jt.num_padded_nodes
    assert tuple(pt.tnbr.shape) == tuple(pt.tw.shape) == (n_pad, tm * dp)
    assert pt.tnbr.dtype == torch.uint8 and pt.tile_idx.dtype == torch.int32
    np.testing.assert_array_equal(pt.tile_idx.numpy(), np.asarray(jt.tile_idx))
    np.testing.assert_array_equal(pt.n_active.numpy(), np.asarray(jt.n_active))
    jn = np.asarray(jt.tnbr)[:, :tm * dj].reshape(n_pad, tm, dj)
    jw = np.asarray(jt.tw)[:, :tm * dj].reshape(n_pad, tm, dj)
    np.testing.assert_array_equal(
        pt.tnbr.numpy().reshape(n_pad, tm, dp), jn[:, :, :dp])
    np.testing.assert_array_equal(
        pt.tw.numpy().reshape(n_pad, tm, dp), jw[:, :, :dp])
    # What the reference pads, within a tile slot and beyond the slots, is
    # empty, and the port's width is tight: some row fills a tile slot.
    assert not jw[:, :, dp:].any() and not np.asarray(jt.tw)[:, tm * dj:].any()
    if pt.num_edges:
        assert pt.tw.numpy().reshape(n_pad, tm, dp)[:, :, dp - 1].any()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_block_tile_tables_match_reference(graphs, mesh):
    g = graphs[mesh]
    _assert_tiles_equal(g["pt"], g["jt"])


def test_block_tile_tables_num_src_and_empty_block():
    # Sources past the destinations (a halo-extended partition) and a
    # destination block with no edge at all (rows 32..63).
    rng = np.random.default_rng(5)
    n, n_src = 100, 230
    r = np.concatenate([rng.integers(0, 32, 150), rng.integers(64, n, 150)])
    s = rng.integers(0, n_src, 300)
    w = rng.normal(size=300).astype(np.float32)
    kw = dict(normalize=False, weights=w)
    jg = J.build_graph(np.minimum(s, n - 1), r, n, **kw)
    pg = P.build_graph(np.minimum(s, n - 1), r, n, **kw)
    # Give the graphs their wide senders after the range check of build_graph.
    import dataclasses
    jg = jg.replace(senders=np.pad(s, (0, jg.senders.shape[0] - 300)).astype(np.int32))
    pg = dataclasses.replace(
        pg, senders=torch.from_numpy(np.pad(s, (0, pg.senders.shape[0] - 300))))
    jt = J.to_block_tiles(jg, block_size=32, num_src=n_src)
    pt = P.to_block_tiles(pg, block_size=32, num_src=n_src)
    _assert_tiles_equal(pt, jt)
    assert int(pt.n_active[1]) == 0 and pt.num_src_rows == 256
    x = _x((pt.num_src_rows, 6), 1)  # the padded source rows
    got = aggregate(pt, torch.from_numpy(x))
    want = np.asarray(j_tiles(jt, jnp.asarray(x)))
    assert got.shape == (pt.num_padded_nodes, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[32:64].any()
    # A non-square operator has no kernel gradient; on the CPU autograd
    # carries it through the plain version.
    xt = torch.from_numpy(x).requires_grad_()
    aggregate(pt, xt).sum().backward()
    assert xt.grad.shape == xt.shape


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("f", [1, 3, 32])
def test_block_tiles_aggregate_matches_reference(graphs, mesh, f):
    g = graphs[mesh]
    x = _x((g["n"], f), 10 + f)
    want = np.asarray(j_tiles(g["jt"], jnp.asarray(x)))
    for backend in ("auto", "plain", "reference"):
        got = aggregate(g["pt"], torch.from_numpy(x), backend=backend)
        np.testing.assert_allclose(got.numpy(), want, err_msg=backend, **TOL)
    np.testing.assert_allclose(
        aggregate_segment(g["pg"], torch.from_numpy(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("mesh", ["L3", "random"])
def test_block_tiles_batched_and_gradient(graphs, mesh):
    g = graphs[mesh]
    xb = _x((2, 3, g["n"], 5), 21)
    want = np.asarray(j_tiles(g["jt"], jnp.asarray(xb)))
    got = aggregate(g["pt"], torch.from_numpy(xb))
    assert got.shape == xb.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # x-gradient: the port's backward (the operator on the cotangent)
    # against jax.vjp of the reference and autograd through segment.
    x = _x((g["n"], 8), 22)
    cot = _x((g["n"], 8), 23)
    _, vjp = jax.vjp(lambda t: j_tiles(g["jt"], t), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(cot))
    for plain in (False, True):
        xt = torch.from_numpy(x).requires_grad_()
        out = spmm_cuda.spmm_block_tiles(g["pt"], xt, plain=plain)
        (got_g,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    xt = torch.from_numpy(x).requires_grad_()
    (seg_g,) = torch.autograd.grad(aggregate_segment(g["pg"], xt), xt,
                                   torch.from_numpy(cot))
    np.testing.assert_allclose(seg_g.numpy(), np.asarray(want_g), **TOL)


def test_block_tiles_bf16_prepadded_and_wrong_rows(graphs):
    g = graphs["L3"]
    pt, jt, n = g["pt"], g["jt"], g["n"]
    x = _x((n, 16), 31)
    want = np.asarray(j_tiles(jt, jnp.asarray(x)))
    got = aggregate(pt, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()
    # Pre-padded rows keep their count, as in the reference.
    xp = np.zeros((pt.num_padded_nodes, 16), np.float32)
    xp[:n] = x
    got = aggregate(pt, torch.from_numpy(xp))
    assert got.shape[0] == pt.num_padded_nodes
    np.testing.assert_allclose(got.numpy(), np.asarray(j_tiles(jt, jnp.asarray(xp))),
                               **TOL)
    with pytest.raises(ValueError, match="node rows"):
        aggregate(pt, torch.zeros(n + 1, 4))
    with pytest.raises(ValueError):
        j_tiles(jt, jnp.zeros((n + 1, 4)))


def test_block_tiles_launch_count_bookkeeping(graphs):
    """On the CPU no kernel launches: the count stays where it was, through
    the wrapper, the composite and its backward."""
    pt = graphs["L2"]["pt"]
    before = spmm_cuda.block_tiles_spmm.launches
    x = torch.from_numpy(_x((graphs["L2"]["n"], 4), 41)).requires_grad_()
    spmm_cuda.block_tiles_spmm(pt, x.detach())
    aggregate(pt, x).sum().backward()
    assert spmm_cuda.block_tiles_spmm.launches == before
    with pytest.raises(ValueError, match="no window SpMM kernel"):
        spmm_cuda.block_tiles_spmm(pt, x.detach().to("meta"))


def test_block_tiles_refuses_wide_blocks(graphs):
    with pytest.raises(ValueError, match="one byte"):
        P.to_block_tiles(graphs["L2"]["pg"], block_size=512)


# ------------------------------------------------------------- int8 rank-1


@pytest.fixture(scope="module")
def rank1(graphs):
    g = graphs["L3"]
    return (J.to_sliding_rank1(g["jg"], block_size=32),
            P.to_sliding_rank1(g["pg"], block_size=32))


def test_sliding_rank1_layout_matches_reference(rank1):
    jr, pr = rank1
    assert pr.core.s_mat.dtype == torch.int8
    assert (pr.core.window_size, pr.num_src_rows, pr.num_padded_nodes) == (
        jr.core.window_size, jr.num_src_rows, jr.num_padded_nodes)
    np.testing.assert_array_equal(pr.core.window_start.numpy(),
                                  np.asarray(jr.core.window_start))
    np.testing.assert_array_equal(pr.row_scale.numpy(), np.asarray(jr.row_scale))
    np.testing.assert_array_equal(pr.col_scale.numpy(), np.asarray(jr.col_scale))
    # The reference's ring columns, read back window-relative.
    ring = jr.core.ring_rows
    nb, bs, w = pr.core.num_blocks, 32, pr.core.window_size
    s_ring = np.asarray(jr.core.s_mat).reshape(nb, bs, ring)
    cols = (np.asarray(jr.core.window_start)[:, None] + np.arange(w)) % ring
    rel = np.take_along_axis(s_ring, cols[:, None, :].repeat(bs, 1), axis=2)
    np.testing.assert_array_equal(pr.core.s_mat.numpy().reshape(nb, bs, w), rel)


def test_sliding_rank1_aggregate_forward_grad_batched(graphs, rank1):
    g = graphs["L3"]
    jr, pr = rank1
    x = _x((g["n"], 24), 51)
    want = np.asarray(j_rank1(jr, jnp.asarray(x)))
    for backend in ("auto", "plain", "reference"):
        got = aggregate(pr, torch.from_numpy(x), backend=backend)
        np.testing.assert_allclose(got.numpy(), want, err_msg=backend, **TOL)
    np.testing.assert_allclose(want, np.asarray(j_segment(g["jg"], jnp.asarray(x))),
                               **TOL)
    xb = _x((2, g["n"], 8), 52)
    np.testing.assert_allclose(
        aggregate(pr, torch.from_numpy(xb)).numpy(),
        np.asarray(j_rank1(jr, jnp.asarray(xb))), **TOL)
    x = xb[0]
    want_g = jax.grad(lambda t: jnp.sum(jnp.sin(j_rank1(jr, t))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(aggregate(pr, xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), **TOL)
    got = aggregate(pr, torch.from_numpy(x).bfloat16()).float().numpy()
    want = np.asarray(j_rank1(jr, jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()  # 1 rounding


@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "batched"])
def test_sliding_rank1_plain_version_matches_reference(graphs, rank1, lead):
    """The int8 rank-1 kernel's plain version (both scales inside, one
    rounding) against the reference's ``spmm_sliding_rank1`` (scales
    outside), and the x-gradient through the symmetric autograd Function
    against ``jax.vjp``, in float32."""
    g = graphs["L3"]
    jr, pr = rank1
    n = g["n"]
    ws, w = pr.core.window_start, pr.core.window_size
    assert int(ws.max()) + w <= pr.num_src_rows  # column scales cover the windows
    rng = np.random.default_rng(53 + len(lead))
    x, cot = (rng.normal(size=(*lead, n, 16)).astype(np.float32) for _ in range(2))
    want, vjp = jax.vjp(lambda v: j_rank1(jr, v), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(cot))
    got = spmm_cuda.sliding_rank1_spmm_plain(pr, torch.from_numpy(x))
    assert got.shape == (*lead, pr.num_padded_nodes, 16)
    np.testing.assert_allclose(got[..., :n, :].numpy(), np.asarray(want), **TOL)
    xt = torch.from_numpy(x).requires_grad_()
    before = spmm_cuda.sliding_rank1_spmm.launches
    out = spmm_cuda.spmm_sliding_rank1(pr, xt)
    (gx,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    assert spmm_cuda.sliding_rank1_spmm.launches == before  # CPU: no kernel
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)


@pytest.mark.parametrize("lead", [(), (4,)], ids=["B3", "B10"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliding_rank1_launches_one_gather_with_both_scales(rank1, lead, dtype,
                                                            fake_lib):
    """``spmm_sliding_rank1`` makes one ``gwen_rank1_spmm`` call with the
    core's int8 S, both scale pointers, the graph's block, the batch and the
    dtype code (4 float32, 5 bf16): no elementwise pass around it."""
    _, pr = rank1
    core = pr.core
    x = torch.zeros(*lead, pr.num_nodes, 16, dtype=dtype)
    before = spmm_cuda.sliding_rank1_spmm.launches
    out = spmm_cuda.spmm_sliding_rank1(pr, x)
    assert spmm_cuda.sliding_rank1_spmm.launches == before + 1
    assert out.shape == x.shape and out.dtype == dtype
    (name, args), = fake_lib.calls
    assert name == "gwen_rank1_spmm"
    assert args[:3] == (core.s_mat.data_ptr(), pr.col_scale.data_ptr(),
                        pr.row_scale.data_ptr())
    assert args[3] == x.data_ptr() and args[4] == core.window_start.data_ptr()
    assert args[6:] == (pr.num_padded_nodes, core.window_size, 32, 16,
                        pr.num_nodes, lead[0] if lead else 1,
                        4 if dtype == torch.float32 else 5, 0)


def test_sliding_rank1_needs_rank1_weights():
    bad = P.build_graph(np.array([0, 1, 0, 1]), np.array([1, 0, 0, 1]), 2,
                        normalize=False, weights=np.array([1.0, 2.0, 1.0, 1.0]))
    with pytest.raises(ValueError, match="rank-1"):
        P.to_sliding_rank1(bad)


# ------------------------------------------------------- dense, multilevel


def test_dense_graph_matches_reference_and_segment():
    s, r = J.complete_edges(9)
    jg, pg = J.build_graph(s, r, 9), P.build_graph(s, r, 9)
    jd, pd = J.to_dense(jg), P.to_dense(pg)
    np.testing.assert_array_equal(pd.adj.numpy(), np.asarray(jd.adj))
    xb = _x((3, 9, 5), 61)
    got = aggregate(pd, torch.from_numpy(xb))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_aggregate(jd, jnp.asarray(xb))), **TOL)
    np.testing.assert_allclose(
        got.numpy(), aggregate_segment(pg, torch.from_numpy(xb)).numpy(), **TOL)


@pytest.fixture(scope="module")
def multimesh():
    """The L3 multimesh, relabelled in the RCM order of its finest level."""
    verts, s, r, lv = J.icosphere_multilevel_edges(3)
    n = verts.shape[0]
    fine = lv == lv.max()
    perm = J.rcm_order(s[fine], r[fine], n)
    s2, r2, _ = J.apply_order(perm, s, r)
    return s2, r2, lv, n


def test_multilevel_edges_match_reference():
    for got, want in zip(P.icosphere_multilevel_edges(2),
                         J.icosphere_multilevel_edges(2)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fine_layout,kind", [
    ("coo", "Graph"), ("ell", "BlockEllGraph"),
    ("windowed", "WindowedDenseGraph"), ("sliding", "SlidingDenseGraph")])
def test_multilevel_graph_matches_reference_and_union(multimesh, fine_layout, kind):
    s, r, lv, n = multimesh
    jm = J.build_multilevel_graph(s, r, lv, n, fine_layout=fine_layout)
    pm = P.build_multilevel_graph(s, r, lv, n, fine_layout=fine_layout)
    assert len(pm.subgraphs) == len(jm.subgraphs) == 4
    assert (pm.num_nodes, pm.num_edges) == (jm.num_nodes, jm.num_edges)
    assert [type(g).__name__ for g in pm.subgraphs] == ["Graph"] * 3 + [kind]
    assert [g.num_edges for g in pm.subgraphs] == [g.num_edges for g in jm.subgraphs]
    x = _x((2, n, 8), 71)
    want = np.asarray(j_aggregate(jm, jnp.asarray(x)))
    union = P.build_graph(s, r, n)  # normalized over the union
    seg = aggregate_segment(union, torch.from_numpy(x)).numpy()
    for backend in ("auto", "plain", "reference"):
        got = aggregate(pm, torch.from_numpy(x), backend=backend).numpy()
        np.testing.assert_allclose(got, want, err_msg=backend, **TOL)
        np.testing.assert_allclose(got, seg, err_msg=backend, **TOL)
    xt = torch.from_numpy(x).requires_grad_()
    aggregate(pm, xt).sum().backward()
    xs = torch.from_numpy(x).requires_grad_()
    aggregate_segment(union, xs).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xs.grad.numpy(), **TOL)


def test_aggregate_refuses_unknown_containers():
    with pytest.raises(TypeError, match="no aggregation for graph type dict"):
        aggregate({}, torch.zeros(3, 2))


# ------------------------------------------------------------ golden fixture


def test_gcn_golden_fixture_every_container():
    """The checked-in pure-numpy derivation of the GCN layer on a 5-node
    path graph, through every container the port aggregates over."""
    fx = np.load(Path(__file__).parent / "data" / "gcn_golden.npz")
    n = int(fx["num_nodes"])
    g = P.build_graph(fx["senders"], fx["receivers"], n)
    x = torch.from_numpy(fx["x"].astype(np.float32))
    s, r, _ = g.host_edges()
    plain = (s != r)  # build_multilevel_graph adds the self loops itself
    containers = {
        "segment": g,
        "dense": P.to_dense(g),
        "ell": P.to_block_ell(g),
        "tiles": P.to_block_tiles(g),
        "windowed": P.to_windowed_dense(g),
        "sliding": P.to_sliding_dense(g),
        "sliding-escapes": P.to_sliding_dense(g, window_size=128),
        "rank1": P.to_sliding_rank1(g),
        "packed": P.to_sliding_packed(g),
        "diag": P.to_diag_window(g, window_size=128),
        "diag-packed": P.to_diag_window(g, window_size=128, packed=True),
        "multilevel": P.build_multilevel_graph(
            s[plain], r[plain], (np.arange(plain.sum()) % 2), n,
            fine_layout="ell"),
    }
    np.testing.assert_allclose(containers["dense"].adj.numpy(), fx["norm_adj"],
                               rtol=1e-6, atol=1e-6)
    params = {"w": torch.from_numpy(fx["w"].astype(np.float32)),
              "b": torch.from_numpy(fx["b"].astype(np.float32))}
    for name, container in containers.items():
        for backend in ("auto", "plain", "reference"):
            got = aggregate(container, x, backend=backend)[:n].numpy()
            np.testing.assert_allclose(
                got, fx["expected_agg"], rtol=1e-5, atol=1e-5,
                err_msg=f"aggregation on {name!r} ({backend}) drifted from golden")
        got = gcn_apply(params, container, x)[:n].numpy()
        np.testing.assert_allclose(
            got, fx["expected_layer"], rtol=1e-5, atol=1e-5,
            err_msg=f"gcn layer on {name!r} drifted from golden")


# ------------------------------------------------- the model on block tiles


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_epd_on_block_tiles_forward_and_adam_step(graphs):
    """``EncodeProcessDecode`` on a ``BlockTileGraph``: the forward, and one
    Adam step's loss, gradients and updated parameters, against the JAX
    model with the same (converted) parameters."""
    import optax

    from gwen_tpu.nn import EncodeProcessDecode as JEPD

    g = graphs["L3"]
    n = g["n"]
    jm = JEPD(channels_in=3, channels_out=3, latent_size=16, process_steps=2)
    params = jm.init(jax.random.key(0))
    pm = EncodeProcessDecode(3, 3, device="cpu", latent_size=16, process_steps=2)
    pm.load_state_dict(params_from_jax(_np_tree(params)))
    x, y = _x((2, n, 3), 81), _x((2, n, 3), 82)

    want = np.asarray(jm.apply(params, g["jt"], jnp.asarray(x)))
    got = pm(g["pt"], torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)

    def j_loss(p):
        return jnp.mean((jm.apply(p, g["jt"], jnp.asarray(x)) - jnp.asarray(y)) ** 2)

    j_val, j_grads = jax.value_and_grad(j_loss)(params)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(j_grads, opt.init(params), params)
    j_new = params_from_jax(_np_tree(optax.apply_updates(params, updates)))
    j_grads = params_from_jax(_np_tree(j_grads))

    topt = torch.optim.Adam(pm.parameters(), lr=1e-3)
    loss = torch.mean((pm(g["pt"], torch.from_numpy(x)) - torch.from_numpy(y)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(j_val), rtol=1e-5)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    topt.step()
    for name, p in pm.named_parameters():
        # Adam's first step moves every entry by lr·sign(g) (up to eps), so a
        # gradient near zero may flip: hold the update where |g| is clear.
        clear = np.abs(j_grads[name].numpy()) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[clear],
                                   j_new[name].numpy()[clear],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
