"""The port's partition tables, windowed-dense and blocked-ELL aggregation
and halo operators against the reference package, in one process (CPU).

Tables: ``partition_graph`` against ``gwen_tpu.parallel.partition_graph``
on the same ordered edges: exactly for ``ell`` and ``dense``; for
``sliding`` after reading the reference's ring columns back as
window-relative ones; for ``diag`` every field the port keeps (the port
places escape rows by per-block ranges, so the one-hot placement tables and
``cnt_pad`` have no counterpart, and ``u_pp`` is padded less). The esc2
space is ordered by RCM: the ``same_rcm`` fixture pins both packages.

Aggregation: ``aggregate`` on the two layouts against
``gwen_tpu.ops.aggregate`` (its Pallas kernels in interpret mode), forward
and x-gradient, float32 at ``rtol = atol = 1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops import aggregate as j_aggregate
from gwen_tpu.parallel import partition_graph as j_partition
from gwen_tpu_torch.ops import aggregate, aggregate_segment
from gwen_tpu_torch.parallel import (
    HaloDiagGraph,
    HaloGraph,
    attend_halo,
    halo_exchange,
    local_graph,
    partition_graph,
)
from test_torch_ops import same_rcm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
DIAG = dict(block_size=32, reorder=False, layout="diag", diag_window=128,
            diag_superblock=4)


def _edges(kd: bool, levels: int = 3):
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    perm = (J.kd_patch_order(verts, s, r, n, leaf_size=128) if kd
            else J.rcm_order(s, r, n))
    s2, r2, _ = J.apply_order(perm, s, r)
    return np.asarray(s2, np.int64), np.asarray(r2, np.int64), n


def _window_relative(s_ring, starts, window: int, block: int) -> np.ndarray:
    """The reference's ring-layout S ``(n_local, ring)`` as window-relative
    columns: column c of block b is ring column ``(start_b + c) % ring``."""
    s_ring = np.asarray(s_ring)
    ring = s_ring.shape[1]
    cols = (np.repeat(np.asarray(starts, np.int64), block)[:, None]
            + np.arange(window)) % ring
    return np.take_along_axis(s_ring, cols, axis=1)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("layout", ["ell", "dense", "sliding"])
def test_partition_tables_match_reference(layout, parts):
    s, r, n = _edges(kd=False)
    kw = dict(num_parts=parts, block_size=32, reorder=False, layout=layout)
    want = j_partition(s, r, n, **kw)
    got = partition_graph(s, r, n, **kw)
    for k in ("num_parts", "n_local", "halo", "block_size", "window_size",
              "num_nodes", "num_edges", "layout", "padded_nodes"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("nbr", "nbr_weight", "window_start", "perm", "inv_perm",
              "edges_per_part"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    if layout == "dense":
        assert got.s_dense.dtype == np.float32
        np.testing.assert_array_equal(got.s_dense, want.s_dense)
    if layout == "sliding":
        assert got.sliding_window == want.sliding_window
        np.testing.assert_array_equal(got.sliding_window_start,
                                      want.sliding_window_start)
        for p in range(parts):
            np.testing.assert_array_equal(
                got.s_sliding[p].numpy(),
                _window_relative(want.s_sliding[p], want.sliding_window_start[p],
                                 want.sliding_window, 32), err_msg=f"part {p}")
    x = np.random.default_rng(0).normal(size=(2, n, 3)).astype(np.float32)
    np.testing.assert_array_equal(got.pad_nodes(x), want.pad_nodes(x))
    np.testing.assert_array_equal(got.unpad_nodes(got.pad_nodes(x)), x)


def test_partition_diag_tables_match_reference(same_rcm):
    s, r, n = _edges(kd=True)
    want = j_partition(s, r, n, num_parts=2, **DIAG)
    got = partition_graph(s, r, n, num_parts=2, **DIAG)
    for k in ("n_local", "halo", "window_size", "diag_window", "diag_superblock",
              "diag_t_max", "padded_nodes", "num_edges"):
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_array_equal(got.s_diag.numpy(), np.asarray(want.s_diag))
    # One start per block where the reference keeps xbase and offsets.
    ws = np.repeat(want.diag_xbase, 4, axis=1) + want.diag_offsets
    np.testing.assert_array_equal(got.diag_window_start, ws)
    for k in ("diag_t_lo", "diag_t_cnt", "edges_per_part"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    # The skeleton rows each rank extracts, where each gathered row sits,
    # and the c2 row each local fix row reads.
    assert want.diag_esc_start is not None, "the window must force escapes"
    owner, pos = np.divmod(want.diag_idx2, want.diag_u_pp)
    np.testing.assert_array_equal(got.diag_idx2 // got.diag_u_pp, owner)
    np.testing.assert_array_equal(got.diag_idx2 % got.diag_u_pp, pos)
    for p in range(2):
        k = int(got.diag_u_count[p])
        assert k == int((owner == p).sum())
        np.testing.assert_array_equal(got.diag_loc_idx[p, :k], want.diag_loc_idx[p, :k])
        np.testing.assert_array_equal(got.diag_back_loc[p, :k], want.diag_back_loc[p, :k])
        # Per-block ranges into the sorted local receivers.
        rows = got.diag_loc_idx[p, :k]
        ptr = got.diag_esc_ptr[p]
        assert ptr[0] == 0 and ptr[-1] == k
        for b in range(got.n_local // 32):
            assert (rows[ptr[b]:ptr[b + 1]] // 32 == b).all()
    # The replicated c2 graph is the same operator.
    g2, j2 = got.esc2_graph, want.esc2_graph
    x = np.random.default_rng(1).normal(size=(g2.num_nodes, 4)).astype(np.float32)
    np.testing.assert_allclose(aggregate(g2, torch.from_numpy(x)).numpy(),
                               np.asarray(j_aggregate(j2, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(num_parts=32, block_size=32), "exceeds partition size"),
    (dict(num_parts=2, block_size=32, halo=8), "graph bandwidth"),
    (dict(num_parts=2, layout="tiles"), "unknown partition layout"),
    (dict(num_parts=8, **{**DIAG, "diag_window": 256}), "exceeds partition size"),
    (dict(num_parts=2, **{**DIAG, "diag_superblock": 32}), "too small|n_pad"),
])
def test_partition_graph_raises_as_the_reference(kw, match):
    s, r, n = _edges(kd="diag_window" in kw)
    for fn in (j_partition, partition_graph):
        with pytest.raises(ValueError, match=match):
            fn(s, r, n, **kw)


# ------------------------------------------------------------ aggregation


def _layouts(name: str, dtype=np.float32):
    s, r, n = _edges(kd=False)
    gj, gp = J.build_graph(s, r, n), P.build_graph(s, r, n)
    if name == "dense":
        return (J.to_windowed_dense(gj, block_size=32, dtype=dtype),
                P.to_windowed_dense(gp, block_size=32), gp, n)
    return (J.to_block_ell(gj, block_size=32), P.to_block_ell(gp, block_size=32),
            gp, n)


@pytest.mark.parametrize("f", [1, 3, 32])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("name", ["dense", "ell"])
def test_aggregate_windowed_dense_and_block_ell_match_reference(name, lead, f):
    """Forward and x-gradient on a square graph, against the reference's
    kernels (interpret mode) and their ``jax.vjp``."""
    gj, gp, coo, n = _layouts(name)
    rng = np.random.default_rng(f + len(lead))
    x = rng.normal(size=(*lead, n, f)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda t: j_aggregate(gj, t), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    got = aggregate(gp, xt)
    assert got.shape == x.shape
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    for backend in ("plain", "reference"):
        out = aggregate(gp, xt.detach(), backend=backend)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aggregate_segment(coo, xt.detach()).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("name", ["dense", "ell"])
def test_aggregate_on_halo_extended_sources_matches_reference(name, lead):
    """A partition's local operator: ``ext_rows`` source rows, ``n_local``
    output rows, against the reference's kernel on the same tables."""
    from gwen_tpu.parallel.halo import HaloGraph as JHalo

    s, r, n = _edges(kd=False)
    kw = dict(num_parts=2, block_size=32, reorder=False, layout=name)
    pj, pp = j_partition(s, r, n, **kw), partition_graph(s, r, n, **kw)
    hp = local_graph(pp, 1)
    hj = JHalo(nbr=jnp.asarray(pj.nbr[1]), nbr_weight=jnp.asarray(pj.nbr_weight[1]),
               window_start=jnp.asarray(pj.window_start[1]), axis_name="graph",
               halo=pj.halo, n_local=pj.n_local, block_size=32,
               window_size=pj.window_size, num_edges=0,
               s_mat=None if pj.s_dense is None else jnp.asarray(pj.s_dense[1]))
    lj = hj.local_block_ell()
    if name == "dense":
        lj = J.WindowedDenseGraph(s_mat=hj.s_mat, window_start=hj.window_start,
                                  num_nodes=hj.n_local, num_edges=0, block_size=32,
                                  num_src_rows=hj.ext_rows)
        lp = hp.local_windowed_dense()
    else:
        lp = hp.local_block_ell()
    assert lp.num_src_rows == hp.ext_rows != lp.num_padded_nodes
    x = np.random.default_rng(5).normal(size=(*lead, hp.ext_rows, 8)).astype(np.float32)
    want = np.asarray(j_aggregate(lj, jnp.asarray(x)))
    assert want.shape[-2] == hp.n_local
    for backend in ("auto", "plain", "reference"):
        got = aggregate(lp, torch.from_numpy(x), backend=backend)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=backend)


def test_block_ell_duplicate_slots_add_and_padding_is_not_read():
    """Two slots of one row on the same source add; weight-0 slots count
    for nothing whatever their index."""
    g = P.BlockEllGraph(
        nbr=torch.tensor([[0, 0, 3], [1, 2, 2]], dtype=torch.int32),
        nbr_weight=torch.tensor([[0.5, 0.25, 0.0], [1.0, 0.0, 2.0]]),
        window_start=torch.tensor([1], dtype=torch.int32),
        num_nodes=2, num_edges=4, block_size=2, window_size=4, num_src_rows=5)
    x = torch.arange(10.0).reshape(5, 2)
    want = torch.stack([0.75 * x[1], x[2] + 2.0 * x[3]])
    for backend in ("auto", "plain", "reference"):
        torch.testing.assert_close(aggregate(g, x, backend=backend), want)


# ------------------------------------------------------------ halo operators


def test_halo_exchange_single_partition_pads_with_zeros():
    x = torch.arange(12.0).reshape(2, 3, 2).requires_grad_()
    ext = halo_exchange(x, 2)
    assert ext.shape == (2, 7, 2)
    assert ext[:, :2].abs().sum() == 0 and ext[:, -2:].abs().sum() == 0
    torch.testing.assert_close(ext[:, 2:5], x)
    (g,) = torch.autograd.grad(ext.sum(), x)
    torch.testing.assert_close(g, torch.ones_like(x))
    assert halo_exchange(x, 0).shape == x.shape


@pytest.mark.parametrize("layout", ["ell", "dense", "sliding", "diag"])
def test_aggregate_halo_is_the_global_aggregation(layout):
    """One partition of each layout through ``aggregate``: the global
    segment aggregation, forward and gradient; leading axes and any F."""
    s, r, n = _edges(kd=layout == "diag")
    kw = DIAG if layout == "diag" else dict(block_size=32, reorder=False,
                                            layout=layout)
    pg = partition_graph(s, r, n, num_parts=1, **kw)
    hg = local_graph(pg, 0)
    assert isinstance(hg, HaloDiagGraph if layout == "diag" else HaloGraph)
    coo = P.build_graph(s, r, n)
    x = torch.from_numpy(pg.pad_nodes(np.random.default_rng(2).normal(
        size=(2, 2, n, 3)).astype(np.float32))).requires_grad_()
    cot = torch.from_numpy(pg.pad_nodes(np.random.default_rng(3).normal(
        size=(2, 2, n, 3)).astype(np.float32)))
    got = aggregate(hg, x)
    (got_g,) = torch.autograd.grad(got, x, cot)
    x2 = x.detach()[..., :n, :].clone().requires_grad_()
    want = aggregate_segment(coo, x2)
    (want_g,) = torch.autograd.grad(want, x2, cot[..., :n, :])
    np.testing.assert_allclose(got[..., :n, :].detach().numpy(), want.detach().numpy(), **TOL)
    np.testing.assert_allclose(got_g[..., :n, :].numpy(), want_g.numpy(), **TOL)
    with pytest.raises(ValueError, match="rows"):
        aggregate(hg, x[..., :n, :])


def test_attend_halo_refuses_what_it_cannot_do():
    s, r, n = _edges(kd=True)
    pg = partition_graph(s, r, n, num_parts=1, **DIAG)
    q = torch.zeros(pg.n_local, 64)
    with pytest.raises(ValueError, match="transpose tables"):
        attend_halo(local_graph(pg, 0), q, q, q)
    hg = local_graph(pg, 0, transpose_tables=True)
    np.testing.assert_array_equal(hg.local.t_lo.numpy(), pg.diag_t_lo[0])
    np.testing.assert_array_equal(hg.local.t_cnt.numpy(), pg.diag_t_cnt[0])
    with pytest.raises(ValueError, match="f=64"):  # the reference is silently wrong
        attend_halo(hg, q, q, q, scale=0.125, pack=True)
    q128 = torch.zeros(pg.n_local, 128)
    with pytest.raises(ValueError, match="explicit scale"):
        attend_halo(hg, q128, q128, q128, pack=True)
    with pytest.raises(ValueError, match="rows"):
        attend_halo(hg, q[:5], q, q)
    assert attend_halo(hg, q128, q128, q128, scale=0.125, pack=True).shape == q128.shape


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_attend_halo_on_strided_operands_gives_the_gradients_of_copies(backend):
    """One partition through ``attend_halo`` on q, k and v as the model
    passes them (views of ``(B, N, H·dh)`` products, heads first; k and v
    take the halo exchange): output and gradients equal those through
    contiguous copies, bit for bit."""
    from test_torch_attention import _strided_and_contiguous

    s, r, n = _edges(kd=True)
    pg = partition_graph(s, r, n, num_parts=1, **DIAG)
    hg = local_graph(pg, 0, transpose_tables=True)
    (out_s, g_s), (out_c, g_c) = _strided_and_contiguous(
        lambda gr, q, k, v: attend_halo(gr, q, k, v, backend=backend), hg, pg.n_local)
    torch.testing.assert_close(out_s, out_c, rtol=0, atol=0)
    for a, b in zip(g_s, g_c):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_to_diag_window_n_pad(same_rcm):
    """``n_pad`` pads the destination rows only: same windows, same escapes,
    same S rows as the reference; refused unless a superblock multiple."""
    s, r, n = _edges(kd=True)
    kw = dict(window_size=128, block_size=32, superblock=4, esc2_min_rows=1)
    want = J.to_diag_window(J.build_graph(s, r, n), n_pad=768, **kw)
    got = P.to_diag_window(P.build_graph(s, r, n), n_pad=768, **kw)
    assert got.num_padded_nodes == want.num_padded_nodes == 768
    assert got.num_src_rows == want.num_src_rows
    np.testing.assert_array_equal(got.s_mat.numpy(), np.asarray(want.s_mat))
    np.testing.assert_array_equal(
        got.window_start.numpy(),
        np.repeat(np.asarray(want.xbase), 4) + np.asarray(want.offsets))
    x = np.random.default_rng(4).normal(size=(n, 4)).astype(np.float32)
    np.testing.assert_allclose(aggregate(got, torch.from_numpy(x)).numpy(),
                               np.asarray(j_aggregate(want, jnp.asarray(x))), **TOL)
    for bad in (640, 800):
        with pytest.raises(ValueError, match="n_pad"):
            P.to_diag_window(P.build_graph(s, r, n), n_pad=bad, **kw)


# ------------------------------------------------------------ mesh, multihost


@pytest.mark.parametrize("total,procs", [(10, None), (10, 3), (7, 7), (3, 4)])
def test_process_slice_matches_reference(total, procs):
    from gwen_tpu.data.multihost import process_slice as j_slice
    from gwen_tpu_torch.data import all_gather_from_hosts, process_slice

    assert process_slice(total, procs) == j_slice(total, procs)
    x = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(all_gather_from_hosts(x), x)


def test_one_process_mesh_needs_no_group():
    from gwen_tpu_torch.train import initialize_distributed, is_main_process, make_mesh

    assert initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized() and is_main_process()
    mesh = make_mesh()
    assert (mesh.data, mesh.graph, mesh.world) == (1, 1, 1)
    assert mesh.graph_group is None and mesh.data_group is None
    p = torch.nn.Parameter(torch.ones(2))
    mesh.all_reduce_gradients([p])  # one rank: nothing to sum, nothing made
    assert p.grad is None
    for kw in (dict(data=2, graph=1), dict(data=-1, graph=2)):
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(**kw)


def test_make_partitioned_apply_runs_on_the_card_by_default():
    """The per-rank apply moves its tables to the card unless the caller
    asks for the CPU, as every entry point of the port does; asked for the
    CPU, the tables stay there."""
    import inspect

    from gwen_tpu_torch.nn import EncodeProcessDecode
    from gwen_tpu_torch.parallel import make_partitioned_apply
    from gwen_tpu_torch.train import make_mesh

    params = inspect.signature(make_partitioned_apply).parameters
    assert params["device"].default == "cuda"
    _, s, r = J.icosphere_edges(2)
    pg = partition_graph(s, r, 162, 1, reorder=False, layout="ell")
    model = EncodeProcessDecode(1, 1, device="cpu", latent_size=8, process_steps=1)
    apply_fn = make_partitioned_apply(model, pg, make_mesh(), "cpu")
    assert apply_fn.graph.nbr.device.type == "cpu"
