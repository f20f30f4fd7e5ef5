"""The wide-window layouts the row gathers run on (kernels B13 and B11, and
B3/B10 on a wide window) against the reference package (CPU).

On CUDA tensors ``sliding_packed_spmm``, ``windowed_dense_spmm`` and the
wide-window branch of ``sliding_spmm``/``sliding_spmm_b`` launch a kernel
that walks each row's nonzeros (``csrc/window_spmm.cu``, the row gathers);
on the CPU they run their plain versions, which these tests hold against
``gwen_tpu``'s ``spmm_sliding_packed``, ``spmm_windowed_dense`` and
``spmm_sliding_dense`` (Pallas in interpret mode) on the graphs the
gathers must get right: a hub joined to every node within its window (a
row of hundreds of nonzeros, many 32-lane rounds), a destination block
with no nonzero, fewer x rows than the layout's sources, and a
halo-extended, non-square operator whose starts are not monotone. Forward
and x-gradient, float32 at ``rtol = atol = 1e-4``, bf16 at
``1e-2·max|ref|``. A fake library stands in for the built one to hold the
wrappers' dispatch and argument packing, which the CPU otherwise never
reaches. L3 icosphere in RCM order (the packages' own RCM is pinned).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops.spmm_pallas import spmm_sliding_dense as j_sliding
from gwen_tpu.ops.spmm_pallas import spmm_sliding_packed as j_packed
from gwen_tpu.ops.spmm_pallas import spmm_windowed_dense as j_dense
from gwen_tpu.parallel import partition_graph as j_partition
from gwen_tpu_torch import dryrun
from gwen_tpu_torch.ops import aggregate, aggregate_segment, spmm_cuda
from gwen_tpu_torch.parallel import local_graph, partition_graph
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)
from test_torch_ops import same_rcm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = 64  # the reference's banded builders cover the hub at this block
HUB_SPAN = 150  # the hub is joined to every node within this many rows
ISOLATED = 126  # nodes appended without edges: rows 704..767 are one block


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def _edges(kind: str):
    """RCM-ordered L3 icosphere edges (``mesh``), and the node count:
    ``hub`` adds a node joined both ways to every node within ``HUB_SPAN``
    rows of it; ``empty`` appends isolated nodes (self loops only), a whole
    block of them at the end."""
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.rcm_order(s, r, n), s, r)
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    if kind == "hub":
        h = n // 4
        near = set(s[r == h].tolist())
        others = np.array([c for c in range(h - HUB_SPAN, h + HUB_SPAN + 1)
                           if c != h and c not in near])
        s = np.concatenate([s, others, np.full(others.size, h)])
        r = np.concatenate([r, np.full(others.size, h), others])
    elif kind == "empty":
        n += ISOLATED
    return s, r, n


def _empty_block(n_pad: int) -> slice:
    """The rows of the last block, whose nodes have only self loops:
    clearing them leaves a block with no nonzero and the operator
    symmetric."""
    return slice(n_pad - BLOCK, n_pad)


def _packed_pair(kind: str):
    s, r, n = _edges(kind)
    sj = J.to_sliding_packed(J.build_graph(s, r, n), block_size=BLOCK)
    sp = P.to_sliding_packed(P.build_graph(s, r, n), block_size=BLOCK)
    if kind == "empty":
        rows = _empty_block(sp.num_padded_nodes)
        bits = sp.s_pack.clone()
        bits[rows] = 0
        sp = dataclasses.replace(sp, s_pack=bits)
        # The reference packs 8 rows a byte, tile by tile: a block's rows
        # are its BLOCK // 8 packed rows, every bit.
        gpb = BLOCK // 8
        blk = rows.start // BLOCK
        packed = np.array(sj.packed)
        packed[blk * gpb:(blk + 1) * gpb] = 0
        sj = sj.replace(packed=jnp.asarray(packed))
    return sj, sp, n


def _dense_pair(kind: str, s_dtype: str):
    s, r, n = _edges(kind)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if s_dtype == "bf16"
                else (np.float32, torch.float32))
    dj = J.to_windowed_dense(J.build_graph(s, r, n), block_size=BLOCK, dtype=jdt)
    dp = P.to_windowed_dense(P.build_graph(s, r, n), block_size=BLOCK, dtype=tdt)
    if kind == "empty":
        rows = _empty_block(dp.num_padded_nodes)
        sm = dp.s_mat.clone()
        sm[rows] = 0
        dp = dataclasses.replace(dp, s_mat=sm)
        s_mat = np.array(dj.s_mat)
        s_mat[rows] = 0
        dj = dj.replace(s_mat=jnp.asarray(s_mat))
    return dj, dp, n


def _check_layout(kind: str, dp, n: int) -> None:
    """The graph is what the test claims: a row of hundreds of nonzeros, or
    a block with none."""
    mask = P.window_mask(dp)
    per_row = mask.sum(1)
    if kind == "hub":
        assert int(per_row.max()) > 8 * 32  # many 32-lane rounds a row
    else:
        assert int(per_row[_empty_block(dp.num_padded_nodes)].sum()) == 0
        assert int(per_row[:n].min()) == 0 < int(per_row.max())


def _x_cot(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32) for _ in range(2))


# ------------------------------------------------------------------- B13


@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("kind", ["hub", "empty"])
def test_sliding_packed_wide_windows_match_reference(kind, lead, same_rcm):
    """B13 (its plain version) behind ``aggregate``: forward and x-gradient
    against ``jax.vjp`` of the reference's ``spmm_sliding_packed``, and the
    forward against the segment aggregation."""
    sj, sp, n = _packed_pair(kind)
    _check_layout(kind, sp, n)
    x, cot = _x_cot((*lead, n, 24), 3 + len(lead))
    want, vjp = jax.vjp(lambda v: j_packed(sj, v), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    before = spmm_cuda.sliding_packed_spmm.launches
    got = aggregate(sp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    assert spmm_cuda.sliding_packed_spmm.launches == before  # CPU: plain
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)
    if kind == "hub":
        s, r, _ = _edges(kind)
        seg = aggregate_segment(P.build_graph(s, r, n), torch.from_numpy(x))
        np.testing.assert_allclose(seg.numpy(), np.asarray(want), **TOL)
    else:
        rows = _empty_block(sp.num_padded_nodes)
        assert not got[..., rows.start:n, :].any()


@pytest.mark.parametrize("kind", ["hub", "empty"])
def test_sliding_packed_wide_windows_bf16_match_reference(kind, same_rcm):
    sj, sp, n = _packed_pair(kind)
    x, cot = _x_cot((2, n, 32), 11)
    want, vjp = jax.vjp(lambda v: j_packed(sj, v), jnp.asarray(x, jnp.bfloat16))
    (want_gx,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    got = aggregate(sp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot).to(torch.bfloat16))
    assert got.dtype == gx.dtype == torch.bfloat16
    _bf16_close(got.detach().float(), want.astype(jnp.float32))
    _bf16_close(gx.float(), want_gx.astype(jnp.float32))


# ------------------------------------------------------------------- B11


@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("kind", ["hub", "empty"])
def test_windowed_dense_wide_windows_match_reference(kind, lead, same_rcm):
    """B11 (its plain version) behind ``aggregate``, float32: forward and
    x-gradient against ``jax.vjp`` of the reference's
    ``spmm_windowed_dense``."""
    dj, dp, n = _dense_pair(kind, "f32")
    _check_layout(kind, dp, n)
    x, cot = _x_cot((*lead, n, 24), 5 + len(lead))
    want, vjp = jax.vjp(lambda v: j_dense(dj, v), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    before = spmm_cuda.windowed_dense_spmm.launches
    got = aggregate(dp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    assert spmm_cuda.windowed_dense_spmm.launches == before  # CPU: plain
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)


@pytest.mark.parametrize("s_dtype,x_dtype", [("bf16", "bf16"), ("f32", "bf16"),
                                             ("bf16", "f32")])
@pytest.mark.parametrize("kind", ["hub", "empty"])
def test_windowed_dense_operand_modes_match_reference(kind, s_dtype, x_dtype,
                                                      same_rcm):
    """The mixed operand modes of B11: S is cast to x's type, as the
    reference casts its tile; forward and x-gradient."""
    dj, dp, n = _dense_pair(kind, s_dtype)
    x, cot = _x_cot((2, n, 16), 13)
    jx, tx = ((jnp.bfloat16, torch.bfloat16) if x_dtype == "bf16"
              else (jnp.float32, torch.float32))
    want, vjp = jax.vjp(lambda v: j_dense(dj, v), jnp.asarray(x, jx))
    (want_gx,) = vjp(jnp.asarray(cot, jx))
    xt = torch.from_numpy(x).to(tx).requires_grad_()
    got = aggregate(dp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot).to(tx))
    assert got.dtype == gx.dtype == tx
    if x_dtype == "bf16":
        _bf16_close(got.detach().float(), want.astype(jnp.float32))
        _bf16_close(gx.float(), want_gx.astype(jnp.float32))
    else:  # a bf16 S widens exactly
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)


def _reversed_blocks(s_mat, starts, block):
    """The destination blocks in reverse order: the same rows' sums, the
    starts no longer monotone."""
    nb = starts.shape[0]
    s_mat = np.asarray(s_mat).reshape(nb, block, -1)[::-1].reshape(nb * block, -1)
    return np.ascontiguousarray(s_mat), np.ascontiguousarray(np.asarray(starts)[::-1])


@pytest.mark.parametrize("lead", [(), (2,)], ids=["unbatched", "batched"])
def test_windowed_dense_halo_operator_with_unordered_starts(lead):
    """One partition's local operator (``ext_rows`` source rows, ``n_local``
    outputs) with its blocks reversed, so the absolute starts go down: the
    port's layout against the reference's on the same tables."""
    from gwen_tpu.parallel.halo import HaloGraph as JHalo

    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.rcm_order(s, r, n), s, r)
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    kw = dict(num_parts=2, block_size=BLOCK, reorder=False, layout="dense")
    pj, pp = j_partition(s, r, n, **kw), partition_graph(s, r, n, **kw)
    hp = local_graph(pp, 1).local_windowed_dense()
    hj = JHalo(nbr=jnp.asarray(pj.nbr[1]), nbr_weight=jnp.asarray(pj.nbr_weight[1]),
               window_start=jnp.asarray(pj.window_start[1]), axis_name="graph",
               halo=pj.halo, n_local=pj.n_local, block_size=BLOCK,
               window_size=pj.window_size, num_edges=0,
               s_mat=jnp.asarray(pj.s_dense[1]))
    sm, ws = _reversed_blocks(hp.s_mat.numpy(), hp.window_start.numpy(), BLOCK)
    assert (np.diff(ws) < 0).any() and hp.num_src_rows > hp.num_padded_nodes
    lp = dataclasses.replace(hp, s_mat=torch.from_numpy(sm),
                             window_start=torch.from_numpy(ws))
    lj = J.WindowedDenseGraph(s_mat=jnp.asarray(sm), window_start=jnp.asarray(ws),
                              num_nodes=hj.n_local, num_edges=0, block_size=BLOCK,
                              num_src_rows=hj.ext_rows)
    x = np.random.default_rng(6).normal(size=(*lead, hp.num_src_rows, 8)).astype(np.float32)
    want = np.asarray(j_dense(lj, jnp.asarray(x)))
    assert want.shape[-2] == hp.num_padded_nodes
    got = aggregate(lp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Reversing the blocks back gives the unreversed operator's product.
    unrev = aggregate(hp, torch.from_numpy(x))
    back = got.reshape(*lead, -1, BLOCK, 8).flip(-3).reshape(unrev.shape)
    torch.testing.assert_close(back, unrev)


# ------------------------------------------------------- missing source rows


@pytest.mark.parametrize("layout", ["packed", "dense", "sliding"])
def test_wrappers_read_rows_past_x_as_zero(layout, same_rcm):
    """The kernel wrappers take fewer x rows than the layout's sources
    (``x_rows < num_src_rows``): the missing rows read as zero, as the
    reference reads its zero-padded source array."""
    s, r, n = _edges("hub")
    gj, gp = J.build_graph(s, r, n), P.build_graph(s, r, n)
    if layout == "packed":
        lj, lp = (J.to_sliding_packed(gj, block_size=BLOCK),
                  P.to_sliding_packed(gp, block_size=BLOCK))
        jfn, wrapper = j_packed, spmm_cuda.sliding_packed_spmm
    elif layout == "dense":
        lj, lp = (J.to_windowed_dense(gj, block_size=BLOCK),
                  P.to_windowed_dense(gp, block_size=BLOCK))
        jfn, wrapper = j_dense, spmm_cuda.windowed_dense_spmm
    else:
        lj, lp = (J.to_sliding_dense(gj, block_size=BLOCK),
                  P.to_sliding_dense(gp, block_size=BLOCK))
        jfn, wrapper = j_sliding, spmm_cuda.sliding_spmm_b
    keep = n - 100
    assert keep < lp.num_src_rows
    x = np.random.default_rng(8).normal(size=(2, n, 16)).astype(np.float32)
    x[:, keep:] = 0
    want = np.asarray(jfn(lj, jnp.asarray(x)))
    got = wrapper(lp, torch.from_numpy(x[:, :keep]))
    assert got.shape == (2, lp.num_padded_nodes, 16)
    np.testing.assert_allclose(got[:, :n].numpy(), want, **TOL)


# ------------------------------------------------- dispatch to the kernels


def _rcm_graph():
    s, r, n = _edges("mesh")
    return P.build_graph(s, r, n), n


@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b13_launches_the_bit_gather_with_the_graph_block(dtype, lead, fake_lib):
    """B13 takes the graph's own block size (256 rows by default): no
    per-call copy of the starts, one launch of ``gwen_sliding_packed_spmm``
    with the batch inside the kernel."""
    g, n = _rcm_graph()
    sp = P.to_sliding_packed(g)
    assert sp.block_size == 256
    x = torch.zeros(*lead, n, 16, dtype=dtype)
    before = spmm_cuda.sliding_packed_spmm.launches
    out = spmm_cuda.sliding_packed_spmm(sp, x)
    assert spmm_cuda.sliding_packed_spmm.launches == before + 1
    assert out.shape == (*lead, sp.num_padded_nodes, 16) and out.dtype == dtype
    (name, args), = fake_lib.calls
    assert name == "gwen_sliding_packed_spmm"
    assert args[0] == sp.s_pack.data_ptr() and args[4] == sp.window_start.data_ptr()
    assert args[5:8] == (None, None, None)  # no escapes
    assert args[9:17] == (sp.num_padded_nodes, sp.window_size // 32, 256, 16, n,
                          lead[0] if lead else 1, 0, 0 if dtype == torch.float32 else 1)


@pytest.mark.parametrize("s_dtype,x_dtype,code", [
    (torch.float32, torch.float32, 0), (torch.bfloat16, torch.bfloat16, 1),
    (torch.bfloat16, torch.float32, 2), (torch.float32, torch.bfloat16, 3),
    (torch.int8, torch.float32, 4), (torch.int8, torch.bfloat16, 5)])
def test_b11_launches_the_dense_gather_in_each_operand_mode(s_dtype, x_dtype, code,
                                                           fake_lib):
    g, n = _rcm_graph()
    wd = P.to_windowed_dense(g)
    wd = dataclasses.replace(wd, s_mat=wd.s_mat.to(s_dtype))
    x = torch.zeros(4, n, 16, dtype=x_dtype)
    spmm_cuda.windowed_dense_spmm(wd, x)
    (name, args), = fake_lib.calls
    assert name == "gwen_window_spmm_streamed"
    assert args[3:6] == (None, None, None)  # no escapes
    assert args[7:] == (wd.num_padded_nodes, wd.window_size, 128, 16, n, 4, 0, code, 0)


@pytest.mark.parametrize("batched", [False, True], ids=["B3", "B10"])
@pytest.mark.parametrize("window", [None, 768], ids=["narrow", "wide"])
def test_banded_kernels_take_the_gather_on_a_wide_window(window, batched, fake_lib):
    """B3 and B10 take the dense gather on a narrow and on a wide window
    alike (B3 with batch 1, B10 with the batch inside the kernel), with the
    graph's own block and no escape pointers."""
    g, n = _rcm_graph()
    sd = P.to_sliding_dense(g, dtype=torch.bfloat16, window_size=window)
    assert (sd.window_size > 736) == (window is not None)
    x = torch.zeros(*((2,) if batched else ()), n, 16, dtype=torch.bfloat16)
    wrapper = spmm_cuda.sliding_spmm_b if batched else spmm_cuda.sliding_spmm
    before = wrapper.launches
    wrapper(sd, x)
    assert wrapper.launches == before + 1
    (name, args), = fake_lib.calls
    assert name == "gwen_window_spmm_streamed"
    assert args[3:6] == (None, None, None)
    assert args[7:] == (sd.num_padded_nodes, sd.window_size, 128, 16, n,
                        2 if batched else 1, 0, 1, 0)


def test_gather_wrappers_refuse_what_the_kernels_do_not_take(fake_lib):
    g, n = _rcm_graph()
    sp = P.to_sliding_packed(g, block_size=BLOCK)
    with pytest.raises(ValueError, match="source rows"):
        spmm_cuda.sliding_packed_spmm(sp, torch.zeros(sp.num_src_rows + 1, 8))
    with pytest.raises(ValueError, match="multiple of 8"):
        spmm_cuda.sliding_packed_spmm(sp, torch.zeros(n, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        spmm_cuda.sliding_packed_spmm(
            dataclasses.replace(sp, col_scale=sp.col_scale.double()), torch.zeros(n, 8))
    with pytest.raises(ValueError, match=f"{BLOCK}-row blocks"):
        spmm_cuda.sliding_packed_spmm(
            dataclasses.replace(sp, window_start=sp.window_start[:-1]), torch.zeros(n, 8))
    wd = P.to_windowed_dense(g)
    with pytest.raises(TypeError, match="S is"):
        spmm_cuda.windowed_dense_spmm(dataclasses.replace(wd, s_mat=wd.s_mat.half()),
                                      torch.zeros(n, 8))
    assert fake_lib.calls == []


def test_train_step_rank_runs_on_the_card_by_default():
    """The partitioned dry run's rank step takes the card unless asked for
    the CPU, as every entry point of the port does."""
    params = inspect.signature(dryrun.train_step_rank).parameters
    assert params["device"].default == "cuda"
    assert inspect.signature(dryrun.dryrun_multichip).parameters["device"].default == "cuda"
