"""The block-tile SpMM (kernel B14) on the graphs its walk must get right,
against the reference package (CPU).

On CUDA tensors ``block_tiles_spmm`` launches one kernel
(``csrc/window_spmm.cu``: a warp a row lists the live slots of its block's
active tiles, 32 slots a round, then gathers them for up to four batch
items a walk, a larger batch in groups of four); on the CPU it runs its
plain version, which these tests hold against ``gwen_tpu``'s
``spmm_block_tiles`` (Pallas in interpret mode) on the L3 icosphere in RCM
and in KD-patch order with a hub row joined both ways to every node within
``HUB_SPAN`` rows (a row of more than 32 live slots, over several tiles),
at batch 1 (a 2-D x), 3, 4, 5 and 9 (a remainder after groups of four):
float32 at ``rtol = atol = 1e-4``, bf16 at ``1e-2 · max|reference|``. A
fake library stands in for the built one to hold the wrapper's dispatch.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.ops.spmm_pallas import spmm_block_tiles as j_tiles
from gwen_tpu_torch.ops import spmm_cuda
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 1e-2
HUB_SPAN = 40
BLOCK = 32
F = 8


@functools.lru_cache(maxsize=None)
def _tiles(order: str):
    """The reference's and the port's block tiles of the L3 icosphere in
    ``order`` with a hub row, and the node count. The ordering is computed
    once and handed to both packages."""
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    perm = (J.rcm_order(s, r, n) if order == "rcm"
            else J.kd_patch_order(verts, s, r, n, leaf_size=64))
    s, r, _ = J.apply_order(perm, s, r)
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    h = n // 2
    near = set(s[r == h].tolist())
    others = np.array([c for c in range(h - HUB_SPAN, h + HUB_SPAN + 1)
                       if c != h and c not in near])
    s = np.concatenate([s, others, np.full(others.size, h)])
    r = np.concatenate([r, np.full(others.size, h), others])
    jt = J.to_block_tiles(J.build_graph(s, r, n), block_size=BLOCK)
    pt = P.to_block_tiles(P.build_graph(s, r, n), block_size=BLOCK)
    return jt, pt, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3, 4, 5, 9])
@pytest.mark.parametrize("order", ["rcm", "kd"])
def test_plain_b14_on_a_hub_graph_matches_reference(order, batch, dtype):
    """The plain B14 at each batch (1: a 2-D x) against the reference's
    block-tile SpMM; the hub row has more live slots than a round of 32."""
    jt, pt, n = _tiles(order)
    live = (pt.tw != 0).sum(1)
    assert int(live.max()) > 32
    rng = np.random.default_rng(batch)
    shape = (n, F) if batch == 1 else (batch, n, F)
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == torch.bfloat16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(j_tiles(jt, jnp.asarray(x, jdt)), np.float32)
    got = spmm_cuda.block_tiles_spmm(pt, torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and got.shape == (*shape[:-2], pt.num_padded_nodes, F)
    got = got.float().numpy()[..., :want.shape[-2], :]
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3, 4, 5, 9])
def test_b14_launches_one_kernel_whatever_the_batch(batch, dtype, fake_lib):
    """B14 is one ``gwen_tile_spmm`` call at any batch (the kernel walks
    the items in groups of four itself): the tables, the rows, the x rows
    given, F, the batch and the dtype code as the kernel takes them."""
    _, pt, n = _tiles("kd")
    rows = n - 10
    shape = (rows, F) if batch == 1 else (batch, rows, F)
    x = torch.zeros(*shape, dtype=dtype)
    before = spmm_cuda.block_tiles_spmm.launches
    out = spmm_cuda.block_tiles_spmm(pt, x)
    assert spmm_cuda.block_tiles_spmm.launches == before + 1
    assert [c[0] for c in fake_lib.calls] == ["gwen_tile_spmm"]
    (_, args), = fake_lib.calls
    assert list(args[:6]) == [pt.tile_idx.data_ptr(), pt.n_active.data_ptr(),
                              pt.tnbr.data_ptr(), pt.tw.data_ptr(), x.data_ptr(),
                              out.data_ptr()]
    assert list(args[6:]) == [pt.num_padded_nodes, pt.tiles_max, pt.tile_degree,
                              BLOCK, F, rows, batch,
                              1 if dtype == torch.bfloat16 else 0, 0]
    assert out.shape == (*shape[:-2], pt.num_padded_nodes, F) and out.dtype == dtype
