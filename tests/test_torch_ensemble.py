"""The port's losses and ensemble functions against the reference (CPU).

Every function of ``losses.py`` and ``ensemble.py`` on small fields and on
the L3 icosphere (642 nodes), latent 64, 2 process steps. Inputs come from
numpy seeds; where the reference draws noise from a ``jax.random`` key, the
test draws the same ``jax.random.normal(key, shape)`` and hands it to the
port. Parameters are converted from the JAX param tree. float32 results
are held to rtol = atol = 1e-4. The train steps and ``train-mesh`` are in
``test_torch_ensemble_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu import ensemble as j_ensemble
from gwen_tpu import losses as j_losses
from gwen_tpu.data.dataset import MeshEnsembleDataset as JDataset
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu_torch import ensemble, losses
from gwen_tpu_torch.data import MeshEnsembleDataset
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax
from test_torch_ops import same_rcm  # noqa: F401 (fixture)
from test_torch_train import _mesh

TOL = dict(rtol=1e-4, atol=1e-4)
LATENT, STEPS, CH = 64, 2, 2


def _rng(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=msg)


# ------------------------------------------------------------------ losses


def _loss_cases():
    p, y = _rng(0, (5, 3, 40, 2), (3, 40, 2))  # ensemble on axis 0
    q, z = _rng(1, (3, 5, 40, 2), (3, 1, 40, 2))  # ensemble on axis 1
    mu, sig, tgt = _rng(2, (3, 40), (3, 40), (3, 40))
    mask = (np.arange(40) % 3 != 0)
    cell = (_rng(3, (1, 40, 2))[0] > 0).astype(np.float32)
    return {
        "crps_ensemble-fair": ("crps_ensemble", (p, y), dict(fair=True)),
        "crps_ensemble-standard": ("crps_ensemble", (p, y), dict(fair=False)),
        "crps_ensemble-axis1": ("crps_ensemble", (q, y), dict(ensemble_axis=1)),
        "crps_ensemble-one-member": ("crps_ensemble", (p[:1], y), {}),
        "crps_gaussian": ("crps_gaussian", (mu, np.abs(sig), tgt), {}),
        "crps_gaussian_surrogate": ("crps_gaussian_surrogate", (q, z), {}),
        "masked_node_l1": ("masked_node_l1", (y, y * 0.5, mask), {}),
        "ensemble_variance_regularized_l1":
            ("ensemble_variance_regularized_l1", (q, z), dict(alpha=0.3)),
        "masked_loss-l1": ("masked_loss", (y, y * 0.5, cell), {}),
        "masked_loss-mse": ("masked_loss", (y, y * 0.5, cell), dict(base="mse")),
        "l1_loss": ("l1_loss", (y, y * 0.5), {}),
        "rmse": ("rmse", (y, y * 0.5), {}),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_matches_reference(case):
    name, args, kw = _loss_cases()[case]
    want = getattr(j_losses, name)(*map(jnp.asarray, args), **kw)
    got = getattr(losses, name)(*map(_t, args), **kw)
    assert got.dim() == 0
    _close(got, want, case)
    assert losses.LOSSES.keys() == j_losses.LOSSES.keys()


def test_variance_mask_and_bad_base_match_reference():
    (data,) = _rng(4, (6, 30, 2))
    data[:, ::4] *= 0.01
    want = j_losses.variance_mask(data, 0.05)
    got = losses.variance_mask(data, 0.05)
    assert got.dtype == torch.float32 and 0 < got.sum() < got.numel()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unknown base loss"):
        losses.masked_loss(_t(data), _t(data), _t(data), base="huber")


def test_crps_ensemble_gradient_matches_reference():
    p, y = _rng(5, (4, 2, 30, 2), (2, 30, 2))
    want = jax.grad(lambda a: j_losses.crps_ensemble(a, jnp.asarray(y)))(
        jnp.asarray(p))
    tp = _t(p).requires_grad_()
    losses.crps_ensemble(tp, _t(y)).backward()
    _close(tp.grad, want)


# ---------------------------------------------------------------- ensemble


def _coo():
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    return J.build_graph(s, r, n), P.build_graph(s, r, n), n


@pytest.mark.parametrize("layout", ["coo", "diag-bf16"])
@pytest.mark.parametrize("shape", [(3, 1), (2, 3, 2)], ids=["KN1", "BKN2"])
def test_correlated_noise_matches_reference(layout, shape, same_rcm):
    """The same white noise through both smoothings: on the COO graph and,
    as the attention skill model has it, a float32 field on a bf16
    diag-window graph."""
    if layout == "coo":
        gj, gp, n = _coo()
    else:
        gj, gp, n = _mesh(True, jnp.bfloat16)
    full = (*shape[:-1], n, shape[-1])
    key = jax.random.key(3)
    want = j_ensemble.correlated_noise(key, gj, full, smoothing_steps=2)
    white = _t(jax.random.normal(key, full, jnp.float32))
    got = ensemble.correlated_noise(None, gp, full, 2, noise=white)
    assert got.shape == full and got.dtype == torch.float32
    _close(got, want)
    std = got.std(dim=(-2, -1), unbiased=False)
    _close(std, np.ones(std.shape))


@pytest.mark.parametrize("batch_dims,with_graph", [(0, True), (1, True), (0, False),
                                                   (1, False)])
def test_sample_perturbed_members_matches_reference(batch_dims, with_graph):
    gj, gp, n = _coo()
    (base,) = _rng(6, (3, n, CH) if batch_dims else (n, CH))
    key = jax.random.key(5)
    want = j_ensemble.sample_perturbed_members(
        key, jnp.asarray(base), 4, 0.2, gj if with_graph else None,
        batch_dims=batch_dims)
    shape = (3, 4, n, CH) if batch_dims else (4, n, CH)
    assert want.shape == shape
    white = _t(jax.random.normal(key, shape, jnp.float32))
    got = ensemble.sample_perturbed_members(
        None, _t(base), 4, 0.2, gp if with_graph else None,
        batch_dims=batch_dims, noise=white)
    _close(got, want)


def test_draws_come_from_the_generator_and_noise_is_checked():
    _, gp, n = _coo()
    a = ensemble.sample_perturbed_members(torch.Generator().manual_seed(1),
                                          torch.zeros(n, CH), 3, graph=gp)
    b = ensemble.sample_perturbed_members(torch.Generator().manual_seed(1),
                                          torch.zeros(n, CH), 3, graph=gp)
    c = ensemble.sample_perturbed_members(torch.Generator().manual_seed(2),
                                          torch.zeros(n, CH), 3, graph=gp)
    assert a.shape == (3, n, CH) and torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="noise has shape"):
        ensemble.correlated_noise(None, gp, (3, n, CH), noise=torch.zeros(n, CH))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        ensemble.correlated_noise(None, gp, (3, n, CH))


def test_rollout_matches_reference():
    (x,) = _rng(7, (3, 20, 2))
    want = j_ensemble.rollout(lambda s: 0.9 * s + 0.1, jnp.asarray(x), 5)
    got = ensemble.rollout(lambda s: 0.9 * s + 0.1, _t(x), 5)
    assert got.shape == (5, 3, 20, 2)
    _close(got, want)


@pytest.mark.parametrize("axis,members", [(0, 5), (1, 5), (0, 1)])
def test_skill_and_inflation_match_reference(axis, members):
    gen, ref = _rng(8, (members, 4, 50, 2), (4, 50, 2))
    gen = np.moveaxis(0.3 * gen + ref, 0, axis)
    want = j_ensemble.ensemble_skill(jnp.asarray(gen), jnp.asarray(ref), axis)
    got = ensemble.ensemble_skill(_t(gen), _t(ref), axis)
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], float)
        _close(got[k], want[k], k)
    _close(ensemble.inflate_ensemble(_t(gen), 1.7, axis),
           j_ensemble.inflate_ensemble(jnp.asarray(gen), 1.7, axis))
    for kw in ({}, dict(target_ratio=0.5), dict(max_factor=1.2)):
        _close(ensemble.calibrate_inflation(_t(gen), _t(ref), axis, **kw),
               j_ensemble.calibrate_inflation(jnp.asarray(gen), jnp.asarray(ref),
                                              axis, **kw))


def _models(processor="gcn", heads=2):
    jm = JaxEPD(channels_in=CH, channels_out=CH, latent_size=LATENT,
                process_steps=STEPS, processor=processor, attn_heads=heads)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    pm = EncodeProcessDecode(CH, CH, device="cpu", latent_size=LATENT,
                             process_steps=STEPS, processor=processor,
                             attn_heads=heads)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm


def test_generate_ensemble_and_calibrate_sigma_match_reference():
    gj, gp, n = _coo()
    jm, params, pm = _models()
    (fields,) = _rng(9, (4, 2, n, CH))  # (time, member, nodes, channels)
    key = jax.random.key(7)
    want = j_ensemble.generate_ensemble(jm, params, gj, jnp.asarray(fields[0, 0]),
                                        key, num_members=3, num_steps=2,
                                        sigma=0.1)
    white = _t(jax.random.normal(key, (3, n, CH), jnp.float32))
    got = ensemble.generate_ensemble(pm, gp, _t(fields[0, 0]), None, 3, 2,
                                     sigma=0.1, noise=white)
    assert got.shape == (3, 2, n, CH) and not got.requires_grad
    _close(got, want)

    sigmas = (0.02, 0.2)
    key = jax.random.key(11)
    want = j_ensemble.calibrate_sigma(jm, params, gj, fields, key, sigmas=sigmas,
                                      num_members=3, horizon=2)
    white = torch.stack([torch.stack([
        _t(jax.random.normal(jax.random.fold_in(key, int(s * 1e6) + mi),
                             (3, n, CH), jnp.float32))
        for mi in range(2)]) for s in sigmas])
    got = ensemble.calibrate_sigma(pm, gp, fields, None, sigmas=sigmas,
                                   num_members=3, horizon=2, noise=white)
    assert got["best_sigma"] == want["best_sigma"]
    for g_row, w_row in zip(got["table"], want["table"]):
        for k in w_row:
            _close(g_row[k], w_row[k], k)


def test_trajectory_batches_match_reference():
    (fields,) = _rng(10, (7, 3, 12, 2))
    want = list(JDataset(fields=fields).trajectory_batches(4, 3, shuffle=True,
                                                           seed=2))
    got = list(MeshEnsembleDataset(fields=fields).trajectory_batches(
        4, 3, shuffle=True, seed=2))
    assert len(got) == len(want) == 3
    for (gx, gt), (wx, wt) in zip(got, want):
        assert gt.shape == (4, 3, 12, 2)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gt, wt)
