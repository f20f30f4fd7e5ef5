"""The port's ensemble training and skill verification against the
reference (CPU).

The CRPS and rollout train steps (GCN on the L3 icosphere, attention on
L2), the interaction processor, ``train-mesh`` with each task, and its
skill verification from the reference's parameters and white noise, at
latent ≤ 64 with 2 process steps. float32 results are held to rtol = atol
= 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu import ensemble as j_ensemble
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu.train import Trainer as JTrainer
from gwen_tpu.train import TrainState as JState
from gwen_tpu.train.optim import make_optimizer as j_make_optimizer
from gwen_tpu.train.tasks import ensemble_crps_loss_fn as j_crps_fn
from gwen_tpu.train.tasks import rollout_loss_fn as j_rollout_fn
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.cli.train_mesh import verify_skill
from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.data import mesh_ensemble_dataset
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax
from gwen_tpu_torch.registry import Run
from gwen_tpu_torch.serve import ServingModel, export_model, model_from_metadata
from gwen_tpu_torch.train import (Trainer, TrainState, ensemble_crps_loss_fn,
                                  make_optimizer, rollout_loss_fn)
from test_torch_attention import _graphs as _attention_graphs
from test_torch_ensemble import CH, LATENT, STEPS, _close, _coo, _models, _rng, _t
from test_torch_ops import same_rcm  # noqa: F401 (fixture)
from test_torch_train import _flat, _mesh


# ------------------------------------------------------------- train steps


def _train_step_pair(j_fn, j_batch, j_graph, params, loss_fn, batch, graph, pm):
    """Loss, gradients and the parameters after one Adam step on both sides."""
    (j_loss, j_preds), j_grads = jax.value_and_grad(j_fn, has_aux=True)(
        params, j_batch, j_graph)
    opt = j_make_optimizer(1e-3)
    jt = JTrainer(loss_fn=j_fn, optimizer=opt, context=j_graph)
    j_state, _ = jt._train_step(JState.create(params, opt), j_batch, jt.context)

    loss, preds = loss_fn(batch, graph)
    _close(preds.detach(), j_preds, "preds")
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    state = TrainState(pm, make_optimizer(pm.parameters(), 1e-3))
    Trainer(loss_fn, "cpu", context=graph).train_step(state, batch)
    want_g, want_p = _flat(j_grads), _flat(j_state.params)
    assert set(grads) == set(want_g)
    _close(loss.item(), float(j_loss), "loss")
    for k in grads:
        _close(grads[k], want_g[k], k)
    # Adam's first step moves each parameter by lr·g/(|g| + eps): noise
    # where the gradient itself is at the rounding level (a CRPS bias
    # gradient can cancel to ~1e-8), so the update is held where |g| > 1e-4.
    held = 0
    for k, p in pm.named_parameters():
        sure = np.abs(want_g[k]) > 1e-4
        held += sure.sum()
        _close(p.detach().numpy()[sure], want_p[k][sure], k)
    assert held > 0.5 * sum(g.size for g in want_g.values())


def _task_graphs(processor):
    if processor == "attention":  # L2: the interpret-mode backward is slow
        return _attention_graphs(levels=2, superblock=2)
    return _mesh(True)  # diag window with the esc2 contraction


@pytest.mark.parametrize("processor", ["gcn", "attention"])
def test_ensemble_crps_train_step_matches_reference(processor, same_rcm):
    gj, gp, n = _task_graphs(processor)
    jm, params, pm = _models(processor)
    x, y = _rng(12, (2, n, CH), (2, n, CH))
    key = jax.random.key(21)
    white = _t(jax.random.normal(key, (2, 3, n, CH), jnp.float32))
    _train_step_pair(
        j_crps_fn(jm, num_members=3, sigma=0.1, spread_weight=0.05),
        (jnp.asarray(x), jnp.asarray(y), key), gj, params,
        ensemble_crps_loss_fn(pm, num_members=3, sigma=0.1, spread_weight=0.05),
        (_t(x), _t(y), white), gp, pm)


def test_ensemble_crps_loss_draws_from_the_seed():
    _, gp, n = _coo()
    _, _, pm = _models()
    x, y = map(_t, _rng(13, (2, n, CH), (2, n, CH)))
    fn = ensemble_crps_loss_fn(pm, num_members=3)
    with torch.no_grad():
        a, preds = fn((x, y, 5), gp)
        b, _ = fn((x, y, 5), gp)
        c, _ = fn((x, y, 6), gp)
    assert preds.shape == y.shape and torch.isfinite(a)
    assert a == b and a != c


@pytest.mark.parametrize("processor", ["gcn", "attention"])
def test_rollout_train_step_matches_reference(processor, same_rcm):
    gj, gp, n = _task_graphs(processor)
    jm, params, pm = _models(processor)
    x0, traj = _rng(14, (2, n, CH), (2, 3, n, CH))
    _train_step_pair(
        j_rollout_fn(jm, 3), (jnp.asarray(x0), jnp.asarray(traj)), gj, params,
        rollout_loss_fn(pm, 3), (_t(x0), _t(traj)), gp, pm)


def test_interaction_model_train_step_matches_reference():
    """The interaction processor: forward, every gradient and one Adam step
    on the COO graph, with the reference's parameters."""
    from gwen_tpu.train.tasks import mesh_graph_loss_fn as j_loss_fn
    from gwen_tpu_torch.train import mesh_graph_loss_fn

    gj, gp, n = _coo()
    jm, params, pm = _models("interaction")
    assert set(params["process_0"]) == {"edge_mlp", "node_mlp", "norm"}
    x, y = _rng(15, (2, n, CH), (2, n, CH))
    _train_step_pair(j_loss_fn(jm), (jnp.asarray(x), jnp.asarray(y)), gj, params,
                     mesh_graph_loss_fn(pm), (_t(x), _t(y)), gp, pm)
    # Unbatched, and under every remat policy the same output.
    want = jm.apply(params, gj, jnp.asarray(x[0]))
    for remat in (False, True, "save_agg", "nested:1"):
        pr = EncodeProcessDecode(CH, CH, device="cpu", latent_size=LATENT,
                                 process_steps=STEPS, processor="interaction",
                                 remat=remat)
        pr.load_state_dict(params_from_jax(params))
        _close(pr(gp, _t(x[0])).detach(), want, str(remat))
    with pytest.raises(TypeError, match="COO Graph"):
        pm(_mesh(True)[1], _t(x))


# ------------------------------------------------------ train-mesh end to end


SKILL_KEYS = ("skill_crps", "skill_rmse_ensemble_mean", "skill_spread",
              "skill_spread_error_ratio")


@pytest.mark.parametrize("args", [
    ["train.loss=crps-ensemble"],
    ["train.rollout_horizon=2"],
    ["model.processor=interaction"],
    ["train.calibrate_sigma=true", "train.calibrate_inflation=true"],
    ["model.processor=attention", "train.loss=crps-ensemble",
     "train.crps_members=2"],
], ids=["crps", "rollout", "interaction", "calibrated", "attention-crps"])
def test_train_mesh_cli_verifies_skill(args, tmp_path, capsys):
    rc = cli(["train-mesh", "graph.refine=3", "model.latent_size=32",
              "model.process_steps=2", "train.batch_size=4",
              f"run.registry_root={tmp_path}", *args, "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] >= 8 and np.isfinite(out["best_train_loss"])
    for k in SKILL_KEYS:
        assert np.isfinite(out[k]), k
    assert out["skill_rmse_ensemble_mean"] > 0 and out["skill_spread"] > 0
    run = Run(tmp_path / "GWEN_MESH" / out["run_id"])
    for k in SKILL_KEYS:
        assert run.metrics(k)[-1]["value"] == pytest.approx(out[k])
    if "train.calibrate_sigma=true" in args:
        assert run.metrics("calibrated_sigma")[-1]["value"] in (0.01, 0.02, 0.05,
                                                                0.1, 0.2)
        assert 0.1 <= run.metrics("calibrated_inflation")[-1]["value"] <= 10.0
    if "model.processor=interaction" in args:  # and it serves, on the COO graph
        params, cfg = run.load_model()
        model = model_from_metadata(cfg, "cpu")
        model.load_state_dict(params)
        art = export_model(model, np.zeros((out["nodes"], 1), np.float32),
                           tmp_path / "art", metadata=cfg)
        sm = ServingModel.load(art, "cpu")
        assert type(sm.graph).__name__ == "Graph"
        traj = sm.rollout(torch.zeros(out["nodes"], 1), 2)
        assert traj.shape == (2, out["nodes"], 1) and torch.isfinite(traj).all()


@pytest.mark.parametrize("processor,calibrate", [("gcn", False), ("gcn", True),
                                                 ("attention", False)])
def test_skill_verification_matches_reference(processor, calibrate, same_rcm):
    """``verify_skill`` against the reference's skill section
    (``gwen_tpu/cli/train_mesh.py``, after ``save_model``) from the same
    parameters and the same white noise: the four skill numbers."""
    members, n_steps = 3, 6
    fields, verts, s, r = mesh_ensemble_dataset(levels=3, members=members,
                                                steps=n_steps, seed=0)
    n, ch = fields.shape[2], fields.shape[3]
    perm = J.kd_patch_order(np.asarray(verts), s, r, n, leaf_size=64)
    s2, r2, _ = J.apply_order(perm, s, r)
    fields = np.take(fields, perm, axis=2)
    gj, gp = J.build_graph(s2, r2, n), P.build_graph(s2, r2, n)
    kw = dict(latent_size=32, process_steps=2, processor=processor)
    trained = JaxEPD(channels_in=ch, channels_out=ch, **kw)
    params = jax.tree_util.tree_map(np.asarray, trained.init(jax.random.key(1)))
    model = EncodeProcessDecode(ch, ch, device="cpu", **kw)
    model.load_state_dict(params_from_jax(params))
    if processor == "attention":  # the skill model keeps the trained graph
        dkw = dict(window_size=128, block_size=32, superblock=4,
                   transpose_tables=True)
        sj = J.to_diag_window(gj, dtype=jnp.bfloat16, **dkw)
        sp = P.to_diag_window(gp, dtype=torch.bfloat16, **dkw)
    else:
        sj, sp = gj, gp

    # The reference's skill section.
    horizon = min(4, n_steps - 1)
    base, truth = jnp.asarray(fields[0, -1]), jnp.asarray(fields[1:1 + horizon, -1])
    skill_model = JaxEPD(channels_in=ch, channels_out=ch,
                         backend="segment" if processor != "attention" else "auto",
                         **kw)

    def draw(seed, shape):
        """The white noise the reference draws from ``jax.random.key(seed)``:
        one draw of ``shape``, or for ``calibrate_sigma`` (seed 11) one per
        sigma and validation member from a folded key."""
        key = jax.random.key(seed)
        if seed != 11:
            return _t(jax.random.normal(key, shape, jnp.float32))
        return torch.stack([torch.stack([
            _t(jax.random.normal(jax.random.fold_in(key, int(sg * 1e6) + mi),
                                 shape[2:], jnp.float32))
            for mi in range(shape[1])]) for sg in (0.01, 0.02, 0.05, 0.1, 0.2)])

    sigma = 0.05
    if calibrate:
        sigma = j_ensemble.calibrate_sigma(
            skill_model, params, sj, fields[:, :-1], jax.random.key(11),
            num_members=members, horizon=horizon)["best_sigma"]
    gen = j_ensemble.generate_ensemble(skill_model, params, sj, base,
                                       jax.random.key(7), num_members=members,
                                       num_steps=horizon, sigma=sigma)
    if calibrate:
        vgen = j_ensemble.generate_ensemble(
            skill_model, params, sj, jnp.asarray(fields[0, 0]), jax.random.key(13),
            num_members=members, num_steps=horizon, sigma=sigma)
        inflation = j_ensemble.calibrate_inflation(
            vgen, jnp.asarray(fields[1:1 + horizon, 0]), ensemble_axis=0)
        gen = j_ensemble.inflate_ensemble(gen, inflation, ensemble_axis=0)
    want = j_ensemble.ensemble_skill(gen, truth, ensemble_axis=0)

    config = GwenConfig()
    config.model.latent_size, config.model.process_steps = 32, 2
    config.model.processor = processor
    config.train.calibrate_sigma = config.train.calibrate_inflation = calibrate
    got = verify_skill(config, model, fields, gp, sp, members,
                       torch.device("cpu"), draw=draw)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], k)
