"""The diag-window forms on the row gathers (kernels B1 and B4, weighted and
packed, and B10 on the esc2 contraction) against the reference package
(CPU).

On CUDA tensors ``diag_window_spmm`` and ``diag_window_spmm_b`` launch the
dense row gather and ``diag_window_spmm_packed`` and
``diag_window_spmm_packed_b`` the bit-row gather (with one item, their
batch-1 walk: the row's nonzeros listed, then gathered eight at a time),
each with an escape epilogue that adds the row's fix row before the row
scale and the single rounding; ``window_matvec`` (B1 on a runtime S) the
dense gather with no escapes; ``sliding_spmm_b`` the dense row gather at
every window width and ``sliding_spmm`` on a narrow window the window
kernel (``csrc/window_spmm.cu``). On the CPU they run their plain
versions, which these tests hold against ``gwen_tpu``'s
``spmm_diag_window`` (Pallas in interpret mode) on a graph built to reach
every branch of the gathers: a hub row with more than 32 in-window
nonzeros (several ballot rounds, several fillings of the batch-1 list), a
destination block with more than 32 escape rows (the hub's out-of-window
neighbours: two rounds of the slot search), a block with no nonzero and no
escape, and fewer x rows than the layout's sources. No leading axis (a 2-d
x: B1), leading axes ``(5,)`` and ``(2, 3)`` (folded into one batch:
groups of four and a remainder), F 8, 24 and 264 (lanes past F, and a
second column pass), weighted and packed, the escape rows by the ELL
gather and by the esc2 contraction, bf16, and a float32 x on a bf16
graph. Forward and x-gradient, float32 at ``rtol = atol = 1e-4``, bf16 at
``1e-2·max|ref|``. A fake library stands in for the built one to hold the
wrappers' dispatch and argument packing. L3 icosphere in KD-patch order,
block 64, window 128 (the packages' own RCM is pinned where the esc2 graph
is built).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops.spmm_pallas import spmm_diag_window as j_diag
from gwen_tpu_torch.ops import spmm_cuda
from test_torch_ops import same_rcm  # noqa: F401 (fixture)
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
LEVEL, BLOCK, WINDOW = 3, 64, 128
HUB_SPAN = 60  # the hub is joined to every node within this many rows
FAR = 48  # and to this many nodes of a block far outside its window
ISOLATED = 100  # nodes appended with self loops only: block 11 holds no edge
EMPTY = 11  # the block whose rows are cleared (rows 704..767, 704..741 real)


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def _edges():
    """KD-ordered L3 icosphere edges, a hub joined both ways to every node
    within ``HUB_SPAN`` rows of it and to ``FAR`` nodes of one block far
    away, and ``ISOLATED`` appended nodes; the node count."""
    verts, s, r = J.icosphere_edges(LEVEL)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.kd_patch_order(verts, s, r, n, leaf_size=64), s, r)
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    h = n // 4
    near = set(s[r == h].tolist())
    far0 = (3 * n // 4) // BLOCK * BLOCK
    others = np.array([c for c in (*range(h - HUB_SPAN, h + HUB_SPAN),
                                   *range(far0, far0 + FAR))
                       if c != h and c not in near])
    s = np.concatenate([s, others, np.full(others.size, h)])
    r = np.concatenate([r, np.full(others.size, h), others])
    return s, r, n + ISOLATED


def _pair(packed: bool, esc2: bool = False, dtype=np.float32):
    """The reference's and the port's diag layout of :func:`_edges`, block
    ``EMPTY`` cleared in both (its nodes' self loops: the operator stays
    symmetric)."""
    s, r, n = _edges()
    kw = dict(window_size=WINDOW, block_size=BLOCK, superblock=4, packed=packed)
    if esc2:
        kw["esc2_min_rows"] = 1
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    dj = J.to_diag_window(J.build_graph(s, r, n), dtype=dtype, **kw)
    dp = P.to_diag_window(P.build_graph(s, r, n), dtype=tdt, **kw)
    rows = slice(EMPTY * BLOCK, (EMPTY + 1) * BLOCK)
    if packed:
        bits = dp.s_pack.clone()
        bits[rows] = 0
        dp = dataclasses.replace(dp, s_pack=bits)
        # The reference packs 8 rows a byte, tile by tile: a block's rows
        # are its BLOCK // 8 packed rows, every bit.
        pk = np.array(dj.s_pack)
        pk[EMPTY * BLOCK // 8:(EMPTY + 1) * BLOCK // 8] = 0
        dj = dj.replace(s_pack=jnp.asarray(pk))
    else:
        sm = dp.s_mat.clone()
        sm[rows] = 0
        dp = dataclasses.replace(dp, s_mat=sm)
        sj = np.array(dj.s_mat)
        sj[rows] = 0
        dj = dj.replace(s_mat=jnp.asarray(sj))
    assert (dp.esc2_graph is not None) == esc2
    return dj, dp, n


def test_the_graph_reaches_every_branch_of_the_gathers():
    _, dp, n = _pair(packed=False)
    per_row = P.window_mask(dp).sum(1)
    per_block = np.diff(dp.esc_ptr.numpy())
    assert int(per_row.max()) > 32  # the hub: several ballot rounds
    assert per_block.max() > 32  # two rounds of the escape-slot search
    assert int(per_row[EMPTY * BLOCK:(EMPTY + 1) * BLOCK].sum()) == 0
    assert per_block[EMPTY] == 0 and EMPTY * BLOCK < n  # real rows, no edge
    assert n < dp.num_src_rows  # x has fewer rows than the sources
    assert np.all(np.diff(dp.escape.rows.numpy()) > 0)  # unique, sorted


def _check(dj, dp, shape, seed, dtype=None):
    """Forward and x-gradient of the port's ``spmm_diag_window`` against
    ``jax.vjp`` of the reference's, and against autograd through the plain
    versions. ``dtype`` None: float32 throughout; else both in bf16."""
    rng = np.random.default_rng(seed)
    x, cot = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want, vjp = jax.vjp(lambda v: j_diag(dj, v), jnp.asarray(x, jdt))
    (want_gx,) = vjp(jnp.asarray(cot, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wrappers = (spmm_cuda.diag_window_spmm, spmm_cuda.diag_window_spmm_b,
                spmm_cuda.diag_window_spmm_packed,
                spmm_cuda.diag_window_spmm_packed_b)
    before = [w.launches for w in wrappers]
    got = spmm_cuda.spmm_diag_window(dp, xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot).to(tdt))
    assert [w.launches for w in wrappers] == before  # CPU: plain
    assert got.shape == x.shape and got.dtype == gx.dtype == tdt
    if dtype == "bf16":
        _bf16_close(got.detach().float(), want.astype(jnp.float32))
        _bf16_close(gx.float(), want_gx.astype(jnp.float32))
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), **TOL)
    xp = torch.from_numpy(x).requires_grad_()
    (gp,) = torch.autograd.grad(spmm_cuda.spmm_diag_window(dp, xp, plain=True),
                                xp, torch.from_numpy(cot))
    np.testing.assert_allclose(gp.numpy(), np.asarray(want_gx), **TOL)


@pytest.mark.parametrize("lead,f", [((5,), 8), ((2, 3), 24), ((5,), 264),
                                    ((), 8), ((), 264)],
                         ids=["5-F8", "2x3-F24", "5-F264", "2d-F8", "2d-F264"])
@pytest.mark.parametrize("packed", [False, True], ids=["weighted", "packed"])
def test_batched_diag_forms_match_reference(packed, lead, f):
    """B4 and packed B4 (a 2-d x: B1 and packed B1), their plain versions,
    behind ``spmm_diag_window``, the escape rows from the ELL gather."""
    dj, dp, n = _pair(packed)
    assert dp.esc2_graph is None
    _check(dj, dp, (*lead, n, f), seed=f + len(lead))


@pytest.mark.parametrize("lead,f", [((2, 3), 24), ((5,), 264), ((), 24), ((), 264)],
                         ids=["2x3-F24", "5-F264", "2d-F24", "2d-F264"])
@pytest.mark.parametrize("packed", [False, True], ids=["weighted", "packed"])
def test_batched_diag_forms_on_the_esc2_contraction_match_reference(packed, lead,
                                                                     f, same_rcm):
    """The escape rows from the esc2 contraction: B10 (a 2-d x: B3), its
    plain version, on the RCM-ordered escape graph, then B4 or packed B4
    (B1 or packed B1)."""
    dj, dp, n = _pair(packed, esc2=True)
    _check(dj, dp, (*lead, n, f), seed=3 * f)


@pytest.mark.parametrize("packed", [False, True], ids=["weighted", "packed"])
def test_batched_diag_forms_bf16_match_reference(packed, same_rcm):
    dj, dp, n = _pair(packed, esc2=True, dtype=jnp.bfloat16)
    _check(dj, dp, (5, n, 24), seed=17, dtype="bf16")


@pytest.mark.parametrize("esc2", [False, True], ids=["ell", "esc2"])
def test_float32_x_on_a_bf16_graph_matches_reference(esc2, same_rcm):
    """A float32 field on the bf16 layout (the ensemble's noise smoothing):
    S widens exactly, the product and the escape rows are float32."""
    dj, dp, n = _pair(False, esc2=esc2, dtype=jnp.bfloat16)
    assert dp.s_mat.dtype == torch.bfloat16
    _check(dj, dp, (2, 3, n, 8), seed=19 + esc2)


# ------------------------------------------------- dispatch to the kernels


@pytest.mark.parametrize("with_fix", [True, False], ids=["fix", "no-fix"])
@pytest.mark.parametrize("s_dtype,x_dtype,code", [
    (torch.float32, torch.float32, 0), (torch.bfloat16, torch.bfloat16, 1),
    (torch.bfloat16, torch.float32, 2)])
def test_b4_launches_the_dense_gather_with_its_escapes(s_dtype, x_dtype, code,
                                                       with_fix, fake_lib):
    """B4 takes the dense row gather with the graph's own block, the
    escape pointers, ``n_fix`` and the batch inside the kernel; no fix
    passes null pointers and ``n_fix`` 0."""
    _, dp, n = _pair(False)
    dp = dataclasses.replace(dp, s_mat=dp.s_mat.to(s_dtype))
    u = dp.escape.rows.shape[0]
    x = torch.zeros(3, n, 16, dtype=x_dtype)
    fix = torch.zeros(3, u, 16, dtype=x_dtype) if with_fix else None
    before = spmm_cuda.diag_window_spmm_b.launches
    out = spmm_cuda.diag_window_spmm_b(dp, x, fix)
    assert spmm_cuda.diag_window_spmm_b.launches == before + 1
    assert out.shape == (3, dp.num_padded_nodes, 16) and out.dtype == x_dtype
    (name, args), = fake_lib.calls
    assert name == "gwen_window_spmm_streamed"
    assert args[:3] == (dp.s_mat.data_ptr(), x.data_ptr(), dp.window_start.data_ptr())
    assert args[3:6] == ((dp.esc_ptr.data_ptr(), dp.escape.rows.data_ptr(),
                          fix.data_ptr()) if with_fix else (None, None, None))
    assert args[6] == out.data_ptr()
    assert args[7:] == (dp.num_padded_nodes, WINDOW, BLOCK, 16, n, 3,
                        u if with_fix else 0, code, 0)


@pytest.mark.parametrize("with_fix", [True, False], ids=["fix", "no-fix"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_b4_launches_the_bit_gather_with_its_escapes(dtype, with_fix,
                                                            fake_lib):
    _, dp, n = _pair(True)
    u = dp.escape.rows.shape[0]
    x = torch.zeros(5, n, 16, dtype=dtype)
    fix = torch.zeros(5, u, 16, dtype=dtype) if with_fix else None
    before = spmm_cuda.diag_window_spmm_packed_b.launches
    out = spmm_cuda.diag_window_spmm_packed_b(dp, x, fix)
    assert spmm_cuda.diag_window_spmm_packed_b.launches == before + 1
    (name, args), = fake_lib.calls
    assert name == "gwen_sliding_packed_spmm"
    assert args[:5] == (dp.s_pack.data_ptr(), dp.r1_col.data_ptr(),
                        dp.r1_row.data_ptr(), x.data_ptr(),
                        dp.window_start.data_ptr())
    assert args[5:8] == ((dp.esc_ptr.data_ptr(), dp.escape.rows.data_ptr(),
                          fix.data_ptr()) if with_fix else (None, None, None))
    assert args[8] == out.data_ptr()
    assert args[9:] == (dp.num_padded_nodes, WINDOW // 32, BLOCK, 16, n, 5,
                        u if with_fix else 0, 0 if dtype == torch.float32 else 1, 0)


def _esc2_graph():
    """The esc2 graph of the L7-like shape: 128-row blocks, a 384-column
    window."""
    verts, s, r = J.icosphere_edges(LEVEL)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.rcm_order(s, r, n), s, r)
    g = P.build_graph(np.asarray(s, np.int64), np.asarray(r, np.int64), n)
    return P.to_sliding_dense(g, dtype=torch.bfloat16, window_size=384), n


def test_b10_takes_the_dense_gather_on_the_diag_window(fake_lib):
    g2, n = _esc2_graph()
    assert g2.window_size == 384
    x = torch.zeros(4, n, 16, dtype=torch.bfloat16)
    spmm_cuda.sliding_spmm_b(g2, x)
    (name, args), = fake_lib.calls
    assert name == "gwen_window_spmm_streamed"
    assert args[3:6] == (None, None, None)
    assert args[7:] == (g2.num_padded_nodes, 384, 128, 16, n, 4, 0, 1, 0)


UNBATCHED_FORMS = {
    # form: (packed graph, x dtype, S dtype, fix rows)
    "B1-fix-f32": (False, torch.float32, torch.float32, True),
    "B1-fix-bf16": (False, torch.bfloat16, torch.bfloat16, True),
    "B1-fix-f32-on-bf16": (False, torch.float32, torch.bfloat16, True),
    "B1-no-fix": (False, torch.bfloat16, torch.bfloat16, False),
    "B1p-fix-f32": (True, torch.float32, None, True),
    "B1p-fix-bf16": (True, torch.bfloat16, None, True),
    "B1p-no-fix": (True, torch.float32, None, False),
}


@pytest.mark.parametrize("form", UNBATCHED_FORMS)
def test_unbatched_diag_forms_launch_the_row_gathers(form, fake_lib):
    """B1 and packed B1 (a 2-d x) take the row gathers with batch 1, the
    graph's own block, the escape pointers and ``n_fix`` (null pointers and
    0 with no fix array), in B4's dtype codes."""
    packed, x_dtype, s_dtype, with_fix = UNBATCHED_FORMS[form]
    _, dp, n = _pair(packed)
    if not packed:
        dp = dataclasses.replace(dp, s_mat=dp.s_mat.to(s_dtype))
    u = dp.escape.rows.shape[0]
    x = torch.zeros(n, 16, dtype=x_dtype)
    fix = torch.zeros(u, 16, dtype=x_dtype) if with_fix else None
    wrapper = (spmm_cuda.diag_window_spmm_packed if packed
               else spmm_cuda.diag_window_spmm)
    before = wrapper.launches
    out = wrapper(dp, x, fix)
    assert wrapper.launches == before + 1
    assert out.shape == (dp.num_padded_nodes, 16) and out.dtype == x_dtype
    (name, args), = fake_lib.calls
    escapes = ((dp.esc_ptr.data_ptr(), dp.escape.rows.data_ptr(), fix.data_ptr())
               if with_fix else (None, None, None))
    tail = (n, 1, u if with_fix else 0)
    if packed:
        assert name == "gwen_sliding_packed_spmm"
        assert args[:5] == (dp.s_pack.data_ptr(), dp.r1_col.data_ptr(),
                            dp.r1_row.data_ptr(), x.data_ptr(),
                            dp.window_start.data_ptr())
        assert args[5:9] == (*escapes, out.data_ptr())
        assert args[9:] == (dp.num_padded_nodes, WINDOW // 32, BLOCK, 16, *tail,
                            0 if x_dtype == torch.float32 else 1, 0)
    else:
        code = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
                (torch.bfloat16, torch.float32): 2}[(s_dtype, x_dtype)]
        assert name == "gwen_window_spmm_streamed"
        assert args[:3] == (dp.s_mat.data_ptr(), x.data_ptr(), dp.window_start.data_ptr())
        assert args[3:7] == (*escapes, out.data_ptr())
        assert args[7:] == (dp.num_padded_nodes, WINDOW, BLOCK, 16, *tail, code, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_matvec_launches_the_dense_gather(dtype, fake_lib):
    """B1 on a runtime S (``diag_matvec``'s forward) takes the dense row
    gather with batch 1 and no escapes, counted as B1."""
    _, dp, n = _pair(False)
    s = torch.zeros(dp.num_padded_nodes, WINDOW, dtype=dtype)
    x = torch.zeros(n, 16, dtype=dtype)
    before = spmm_cuda.diag_window_spmm.launches
    out = spmm_cuda.window_matvec(s, dp, x)
    assert spmm_cuda.diag_window_spmm.launches == before + 1
    (name, args), = fake_lib.calls
    assert name == "gwen_window_spmm_streamed"
    assert args[:7] == (s.data_ptr(), x.data_ptr(), dp.window_start.data_ptr(),
                        None, None, None, out.data_ptr())
    assert args[7:] == (dp.num_padded_nodes, WINDOW, BLOCK, 16, n, 1, 0,
                        0 if dtype == torch.float32 else 1, 0)


def test_b3_takes_the_dense_gather_on_the_esc2_contraction(fake_lib):
    """B3 (a 2-d x) on the esc2 graph's 384-column window takes the dense
    row gather's batch-1 walk: one ``gwen_window_spmm_streamed`` launch with
    batch 1, the graph's own block, no escape pointers and the dtype code."""
    g2, n2 = _esc2_graph()
    assert g2.num_padded_nodes % g2.block_size == 0 and g2.window_size % 32 == 0
    x = torch.zeros(n2, 16, dtype=torch.bfloat16)
    before = spmm_cuda.sliding_spmm.launches
    out = spmm_cuda.sliding_spmm(g2, x)
    assert spmm_cuda.sliding_spmm.launches == before + 1
    assert out.shape == (g2.num_padded_nodes, 16) and out.dtype == torch.bfloat16
    (name, args), = fake_lib.calls
    assert name == "gwen_window_spmm_streamed"
    assert args == (g2.s_mat.data_ptr(), x.data_ptr(), g2.window_start.data_ptr(),
                    None, None, None, out.data_ptr(), g2.num_padded_nodes, 384,
                    g2.block_size, 16, n2, 1, 0, 1, 0)


@pytest.mark.parametrize("bad", ["dtype", "leading", "width", "rows"])
def test_b4_wrappers_refuse_a_fix_that_does_not_match(bad, fake_lib):
    for packed in (False, True):
        _, dp, n = _pair(packed)
        u = dp.escape.rows.shape[0]
        x = torch.zeros(2, n, 8)
        fix = {"dtype": torch.zeros(2, u, 8, dtype=torch.bfloat16),
               "leading": torch.zeros(u, 8),
               "width": torch.zeros(2, u, 16),
               "rows": torch.zeros(2, u + 1, 8)}[bad]
        wrapper = (spmm_cuda.diag_window_spmm_packed_b if packed
                   else spmm_cuda.diag_window_spmm_b)
        with pytest.raises(ValueError, match="fix must be|esc_rows must be"):
            wrapper(dp, x, fix)
    assert fake_lib.calls == []


@pytest.mark.parametrize("bad", ["dtype", "leading", "width", "rows"])
def test_b1_wrappers_refuse_a_fix_that_does_not_match(bad, fake_lib):
    """The unbatched forms (a 2-d x) take a ``(U, F)`` fix in x's type."""
    for packed in (False, True):
        _, dp, n = _pair(packed)
        u = dp.escape.rows.shape[0]
        x = torch.zeros(n, 8)
        fix = {"dtype": torch.zeros(u, 8, dtype=torch.bfloat16),
               "leading": torch.zeros(1, u, 8),
               "width": torch.zeros(u, 16),
               "rows": torch.zeros(u + 1, 8)}[bad]
        wrapper = (spmm_cuda.diag_window_spmm_packed if packed
                   else spmm_cuda.diag_window_spmm)
        with pytest.raises(ValueError, match="fix must be|esc_rows must be"):
            wrapper(dp, x, fix)
    assert fake_lib.calls == []
