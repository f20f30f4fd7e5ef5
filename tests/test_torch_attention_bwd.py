"""The attention backward (kernels B6 and B7) on the graphs its chunked walk
must get right, against the reference package (CPU).

On CUDA tensors ``attention_dq`` and ``attention_dkdv`` launch one kernel
each (``csrc/window_attention.cu``: a group of lanes a row, the first 7
list entries gathered at once, a wider list walked in chunks of 7); on
the CPU they run their plain versions, which these tests hold against
``jax.vjp`` of ``gwen_tpu``'s ``windowed_attention`` (Pallas in interpret
mode) on an L3 graph with a hub row of 74 sources and a transpose list as
wide, on a graph with an isolated row, and with q and g pre-padded to the
padded rows: float32 at ``rtol = atol = 1e-4``. A fake library stands in
for the built one to hold the wrappers' dispatch and argument packing,
which the CPU otherwise never reaches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops.attention_pallas import windowed_attention as j_windowed
from gwen_tpu_torch.ops import attention_cuda
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(window_size=128, block_size=32, superblock=4, transpose_tables=True)
HUB_SPAN = 40  # the hub is joined both ways to every node within this many rows
CHUNK = 7  # list entries the kernels gather at once (dh 128, 16 bytes a lane)


def _edges(kind: str):
    """L3 icosphere edges in KD-patch order (``mesh``), the node count and
    whether the graph takes self loops: ``wide`` adds a hub joined both ways
    to every node within ``HUB_SPAN`` rows of it; ``isolated`` drops every
    edge of node 5 and all self loops (a row with no source)."""
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    s, r, _ = J.apply_order(J.kd_patch_order(verts, s, r, n, leaf_size=64), s, r)
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    if kind == "mesh":
        return s, r, n, True
    if kind == "wide":
        h = n // 4
        near = set(s[r == h].tolist())
        others = np.array([c for c in range(h - HUB_SPAN, h + HUB_SPAN + 1)
                           if c != h and c not in near])
        s = np.concatenate([s, others, np.full(others.size, h)])
        r = np.concatenate([r, np.full(others.size, h), others])
        return s, r, n, True
    keep = (s != 5) & (r != 5)
    return s[keep], r[keep], n, False


@functools.lru_cache(maxsize=None)
def _port(kind: str):
    s, r, n, loops = _edges(kind)
    return P.to_diag_window(P.build_graph(s, r, n, self_loops=loops), **KW)


def _pair(kind: str):
    s, r, n, loops = _edges(kind)
    dj = J.to_diag_window(J.build_graph(s, r, n, self_loops=loops), **KW)
    return dj, _port(kind), n


@pytest.mark.parametrize("kind,lead,padded", [
    ("wide", (), False), ("wide", (2,), False), ("wide", (2,), True),
    ("isolated", (), False), ("isolated", (3,), False), ("isolated", (), True),
])
def test_plain_backward_matches_reference(kind, lead, padded):
    """dq from the plain B6 and dk, dv from the plain B7 (on B6's stats)
    against ``jax.vjp`` of the reference's fused attention; with
    ``padded``, q and g hold every padded row (rows with no source, whose
    dq is 0 and which add nothing to dk, dv)."""
    dj, dp, n = _pair(kind)
    if kind == "wide":
        assert dp.attn_nbr.shape[1] > CHUNK and dp.attn_nbr_t.shape[1] > CHUNK
    else:
        assert not (dp.attn_nbr[5] >= 0).any() and not (dp.attn_nbr_t[5] >= 0).any()
    rows = dp.num_padded_nodes if padded else n
    dh = 32
    rng = np.random.default_rng(len(lead) + 2 * padded)
    q, g = (rng.normal(size=(*lead, rows, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(*lead, n, dh)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda a, b, c: j_windowed(dj, a, b, c),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    scale = dh ** -0.5
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    dq, stats = attention_cuda.attention_dq(dp, tq, tk, tv, tg, scale)
    dk, dv = attention_cuda.attention_dkdv(dp, tq, tk, tv, tg, stats, scale)
    assert stats.shape == (*lead, rows, 3) and stats.dtype == torch.float32
    for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, **TOL, err_msg=name)
    idle = ~(dp.attn_nbr[:rows] >= 0).any(1)
    assert idle.any() == (kind == "isolated" or padded)
    assert (dq[..., idle, :] == 0).all()
    assert (stats[..., idle, 1:] == 0).all()


# ------------------------------------------------- dispatch to the kernels


def _rows(rows: int, dh: int) -> list:
    """The layout a contiguous ``(..., rows, dh)`` operand is launched
    with: (outer item, inner item, row) strides in elements."""
    return [rows * dh, rows * dh, dh]


@pytest.mark.parametrize("kind", ["mesh", "wide"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(), (8,)], ids=["2d", "nb8"])
def test_backward_launches_one_kernel_each(lead, dtype, dh, kind, fake_lib):
    """B6 is one ``gwen_attn_dq`` call on the graph's lists and B7 one
    ``gwen_attn_dkdv`` call on the transpose lists, at any list width (the
    kernels walk a list wider than their register chunk themselves): the
    operands' own pointers, q's and k's strides, the items, the inner item count,
    rows, table width, values a lane (dh / 32), scale and dtype code as the
    kernels take them, each counted once, no operand copied."""
    dp = _port(kind)
    n = dp.num_nodes
    assert (dp.attn_nbr.shape[1] > CHUNK) == (kind == "wide")
    q, k, v, g = (torch.zeros(*lead, n, dh, dtype=dtype) for _ in range(4))
    scale = dh ** -0.5
    b6, b7 = attention_cuda.attention_dq.launches, attention_cuda.attention_dkdv.launches
    copies = attention_cuda.operand_copies
    dq, stats = attention_cuda.attention_dq(dp, q, k, v, g, scale)
    dk, dv = attention_cuda.attention_dkdv(dp, q, k, v, g, stats, scale)
    assert attention_cuda.attention_dq.launches == b6 + 1
    assert attention_cuda.attention_dkdv.launches == b7 + 1
    assert attention_cuda.operand_copies == copies
    assert [c[0] for c in fake_lib.calls] == ["gwen_attn_dq", "gwen_attn_dkdv"]
    (_, a6), (_, a7) = fake_lib.calls
    tail = [lead[0] if lead else 1, 1, n, n]
    code = 1 if dtype == torch.bfloat16 else 0
    qkvg = [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr()]
    assert list(a6[:7]) == [*qkvg, dp.attn_nbr.data_ptr(), dq.data_ptr(),
                            stats.data_ptr()]
    assert list(a6[7]) == _rows(n, dh) * 2
    assert list(a6[8:]) == [*tail, dp.attn_nbr.shape[1], dh // 32,
                            pytest.approx(scale), code, 0]
    assert list(a7[:8]) == [*qkvg, stats.data_ptr(), dp.attn_nbr_t.data_ptr(),
                            dk.data_ptr(), dv.data_ptr()]
    assert list(a7[8]) == _rows(n, dh) * 2
    assert list(a7[9:]) == [*tail, dp.attn_nbr_t.shape[1], dh // 32,
                            pytest.approx(scale), code, 0]
    assert dq.shape == q.shape and dq.dtype == dtype
    assert stats.shape == (*lead, n, 3) and stats.dtype == torch.float32
    assert dk.shape == dv.shape == k.shape and dk.dtype == dtype
