"""The attention forward (kernels B5 and B5b) on the graphs its chunked walk
must get right, against the reference package (CPU).

On CUDA tensors ``attention_fwd`` launches one kernel
(``csrc/window_attention.cu``: a group of lanes a row, the k and v rows of
its first 7 list entries gathered at once, a wider list walked in chunks
of 7, twice: max and den, then the output); on the CPU it runs its plain
version, which these tests hold against ``gwen_tpu``'s
``windowed_attention`` (Pallas in interpret mode) on an L3 graph with a hub
row of 74 sources (lists longer than 7 and than 32 entries), on a graph
with an isolated row, and with k and v 100 rows short of q (listed sources
at or past them are zero rows that still count in the softmax): float32 at
``rtol = atol = 1e-4``; bf16 inputs through both packages at ``1e-2 ·
max|reference|`` (each side rounds p and the output to bf16 once, at
different places). A fake library stands in for the built one to hold the
wrapper's dispatch, which the CPU otherwise never reaches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwen_tpu.ops.attention_pallas import windowed_attention as j_windowed
from gwen_tpu_torch.ops import attention_cuda
from test_torch_attention_bwd import CHUNK, _pair, _port, _rows
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 1e-2
SHORT = 100  # rows k and v fall short of q in the "short" cases


def _inputs(kind, lead, dh, dtype, seed):
    """q (rows of the graph) and k, v (SHORT rows fewer for ``short``) as
    numpy float32 values that ``dtype`` holds exactly."""
    _, dp, n = _pair("wide" if kind == "short" else kind)
    n_kv = n - SHORT if kind == "short" else n
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(*lead, n, dh)).astype(np.float32)
    k, v = (rng.normal(size=(*lead, n_kv, dh)).astype(np.float32) for _ in range(2))
    if dtype == torch.bfloat16:  # values bf16 holds, so both sides start alike
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    return q, k, v


def _forward_pair(kind, lead, dh, dtype, seed=0):
    dj, dp, n = _pair("wide" if kind == "short" else kind)
    q, k, v = _inputs(kind, lead, dh, dtype, seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(j_windowed(dj, *(jnp.asarray(a, jdt) for a in (q, k, v))),
                      np.float32)
    got = attention_cuda.attention_fwd(
        dp, *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), dh ** -0.5)
    assert got.shape == q.shape and got.dtype == dtype
    return dp, n, got.float().numpy(), want


def _hold(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 128, 256])
@pytest.mark.parametrize("lead", [(), (3,), (8,)], ids=["nb1", "nb3", "nb8"])
def test_plain_forward_on_a_hub_graph_matches_reference(lead, dh, dtype):
    """The plain B5 (2-D q) and B5b (nb 3 and 8) on the hub graph, whose
    widest list (74) is longer than the kernel's register chunk and than a
    warp, against the reference's fused forward."""
    dp, _, got, want = _forward_pair("wide", lead, dh, dtype)
    width = dp.attn_nbr.shape[1]
    assert width > CHUNK and width > 32
    _hold(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,dh", [((), 128), ((3,), 32), ((8,), 256)],
                         ids=["nb1-dh128", "nb3-dh32", "nb8-dh256"])
@pytest.mark.parametrize("kind", ["isolated", "short"])
def test_plain_forward_isolated_row_and_short_kv_match_reference(kind, lead, dh,
                                                                 dtype):
    """A row with no source gives 0 (no NaN); with k and v short of the
    rows, listed sources past them are zero rows that still count in the
    softmax (so a row of only such sources averages zeros)."""
    dp, n, got, want = _forward_pair(kind, lead, dh, dtype, seed=1)
    assert np.isfinite(got).all()
    _hold(got, want, dtype)
    if kind == "isolated":
        assert not (dp.attn_nbr[5] >= 0).any()
        assert (got[..., 5, :] == 0).all()
    else:
        listed = dp.attn_nbr[:n]
        assert ((listed >= n - SHORT).any(1) & (listed >= 0).any(1)).any()


@pytest.mark.parametrize("kind", ["mesh", "wide"])
@pytest.mark.parametrize("dh", [32, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(), (3,), (8,)], ids=["2d", "nb3", "nb8"])
def test_forward_launches_one_kernel(lead, dtype, dh, kind, fake_lib):
    """B5 and B5b are one ``gwen_attn_fwd`` call on the graph's lists at
    any list width (the kernel walks a list wider than its register chunk
    itself, with no width refused): the operands' own pointers, q's and
    k's strides (item, item, row: a contiguous operand has one item axis
    and row stride dh), the items, the inner item count 1, rows, table width,
    values a lane (dh / 32), scale and dtype code as the kernel takes them,
    counted once and with no operand copied; k and v may be short of q."""
    dp = _port(kind)
    n = dp.num_nodes
    n_kv = n - SHORT
    q = torch.zeros(*lead, n, dh, dtype=dtype)
    k, v = (torch.zeros(*lead, n_kv, dh, dtype=dtype) for _ in range(2))
    scale = dh ** -0.5
    before = attention_cuda.attention_fwd.launches
    copies = attention_cuda.operand_copies
    out = attention_cuda.attention_fwd(dp, q, k, v, scale)
    assert attention_cuda.attention_fwd.launches == before + 1
    assert attention_cuda.operand_copies == copies
    assert [c[0] for c in fake_lib.calls] == ["gwen_attn_fwd"]
    (_, args), = fake_lib.calls
    assert list(args[:5]) == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dp.attn_nbr.data_ptr(), out.data_ptr()]
    assert list(args[5]) == [*_rows(n, dh), *_rows(n_kv, dh)]
    assert list(args[6:]) == [lead[0] if lead else 1, 1, n, n_kv,
                              dp.attn_nbr.shape[1], dh // 32, pytest.approx(scale),
                              1 if dtype == torch.bfloat16 else 0, 0]
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
