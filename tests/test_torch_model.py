"""The port's EncodeProcessDecode against the reference model (CPU).

Both run with the same weights: the reference's param tree, converted by
``params_from_jax``. The reference runs its Pallas kernels in interpret
mode; the port runs its kernels' plain versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax, params_to_tree


def _graphs(levels=3, leaf=128, dtype=np.float32):
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    perm = J.kd_patch_order(verts, s, r, n, leaf_size=leaf)
    s, r, _ = J.apply_order(perm, s, r)
    kw = dict(window_size=256, block_size=32, superblock=4, esc2_min_rows=1)
    dj = J.to_diag_window(J.build_graph(s, r, n), dtype=dtype, **kw)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    dp = P.to_diag_window(P.build_graph(s, r, n), dtype=tdt, **kw)
    return dj, dp, P.build_graph(s, r, n), J.build_graph(s, r, n), n


def _models(latent, steps, channels, jdtype, tdtype, seed=0):
    jm = JaxEPD(channels_in=channels, channels_out=channels,
                latent_size=latent, process_steps=steps, compute_dtype=jdtype)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(seed)))
    pm = EncodeProcessDecode(channels, channels, device="cpu",
                             latent_size=latent, process_steps=steps,
                             compute_dtype=tdtype)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm


@pytest.mark.parametrize("latent", [128, 96])
def test_epd_forward_f32_matches_reference(latent):
    dj, dp, _, _, n = _graphs()
    jm, params, pm = _models(latent, 2, 2, jnp.float32, torch.float32)
    x = np.random.default_rng(latent).normal(size=(n, 2)).astype(np.float32)
    want = np.asarray(jm.apply(params, dj, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(dp, torch.from_numpy(x))
        pm.backend = "reference"
        ref = pm(dp, torch.from_numpy(x))
    assert got.shape == (n, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-4, atol=1e-4)


def test_epd_forward_segment_graph_matches_reference():
    _, _, gp, gj, n = _graphs()
    _, params, pm = _models(32, 2, 3, jnp.float32, torch.float32, seed=1)
    jm = JaxEPD(channels_in=3, channels_out=3, latent_size=32,
                process_steps=2, backend="segment")
    x = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(jm.apply(params, gj, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(gp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_epd_forward_bf16_matches_reference():
    dj, dp, _, _, n = _graphs(dtype=jnp.bfloat16)
    jm, params, pm = _models(128, 2, 2, jnp.bfloat16, torch.bfloat16, seed=3)
    x = np.random.default_rng(4).normal(size=(n, 2)).astype(np.float32)
    want = np.asarray(jm.apply(params, dj, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(dp, torch.from_numpy(x)).numpy()
    # bf16 rounds at other places in the two frameworks.
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())


def test_params_round_trip_and_names():
    _, params, pm = _models(128, 2, 2, jnp.float32, torch.float32)
    sd = pm.state_dict()
    assert "process_1.gcn.w" in sd and "process_0.norm.scale" in sd
    assert sd["encoder.layer_0.w"].shape == (2, 128)  # (d_in, d_out)
    tree = params_to_tree(sd)
    leaves_j = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves_j) == len(sd)
    for path, leaf in leaves_j:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


@pytest.mark.parametrize("kw,exc,match", [
    # attention runs on the diag-window layout only
    (dict(processor="attention"), TypeError, "DiagWindowGraph"),
    (dict(processor="interaction"), ValueError, "slice 4"),
])
def test_epd_rejects_later_slices(kw, exc, match):
    verts, s, r = J.icosphere_edges(1)
    graph = P.build_graph(s, r, verts.shape[0])
    with pytest.raises(exc, match=match):
        model = EncodeProcessDecode(2, 2, device="cpu", latent_size=32, **kw)
        model(graph, torch.zeros(verts.shape[0], 2))
