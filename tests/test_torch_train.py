"""The port's training path against the reference package (CPU).

Same numpy inputs and converted params (``params_from_jax``) go through the
reference's ``Trainer`` and the port's. The reference runs its Pallas
kernels in interpret mode; the port runs its kernels' plain versions (CPU
tensors). L3 mesh, latent 128, 2 process steps, batch 2: float32 at
``rtol = atol = 1e-4``, bf16 at 1e-2 of the largest value.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu import losses as j_losses
from gwen_tpu.config import GwenConfig as JConfig
from gwen_tpu.data.dataset import MeshEnsembleDataset as JDataset
from gwen_tpu.data.synthetic import mesh_ensemble_dataset as j_synthetic
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu.train import Trainer as JTrainer
from gwen_tpu.train import TrainState as JState
from gwen_tpu.train.optim import make_optimizer as j_make_optimizer
from gwen_tpu.train.optim import make_schedule as j_make_schedule
from gwen_tpu.train.remat import remat_policy_for_budget as j_policy
from gwen_tpu.train.tasks import mesh_graph_loss_fn as j_loss_fn
from gwen_tpu_torch import losses
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.data import MeshEnsembleDataset, mesh_ensemble_dataset
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax
from gwen_tpu_torch.registry import Registry, Run
from gwen_tpu_torch.serve import ServingModel, export_model, model_from_metadata
from gwen_tpu_torch.train import (
    Checkpointer,
    Trainer,
    TrainState,
    make_optimizer,
    make_schedule,
    mesh_graph_loss_fn,
    remat_policy_for_budget,
)
from test_torch_ops import same_rcm  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
LATENT, STEPS, CH, BATCH = 128, 2, 2, 2


def _mesh(diag: bool, dtype=np.float32):
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    if diag:
        perm = J.kd_patch_order(verts, s, r, n, leaf_size=128)
        s, r, _ = J.apply_order(perm, s, r)
        kw = dict(window_size=256, block_size=32, superblock=4, esc2_min_rows=1)
        tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        return (J.to_diag_window(J.build_graph(s, r, n), dtype=dtype, **kw),
                P.to_diag_window(P.build_graph(s, r, n), dtype=tdt, **kw), n)
    return J.build_graph(s, r, n), P.build_graph(s, r, n), n


def _models(jdtype=jnp.float32, tdtype=torch.float32, remat=False, latent=LATENT):
    jm = JaxEPD(channels_in=CH, channels_out=CH, latent_size=latent,
                process_steps=STEPS, compute_dtype=jdtype)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    pm = EncodeProcessDecode(CH, CH, device="cpu", latent_size=latent,
                             process_steps=STEPS, compute_dtype=tdtype,
                             remat=remat)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm


def _batch(n, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, n, CH)).astype(np.float32)
    return x, (0.9 * x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epd_train_step_matches_reference(dtype, same_rcm):
    """One batched EPD train step on a diag graph with esc2: loss, every
    gradient, and the params after one Adam step, against the reference's
    ``Trainer`` step."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    dj, dp, n = _mesh(True, jdt)
    jm, params, pm = _models(jdt, tdt)
    x, y = _batch(n)
    j_fn = j_loss_fn(jm)
    (j_loss, _), j_grads = jax.value_and_grad(j_fn, has_aux=True)(
        params, (jnp.asarray(x), jnp.asarray(y)), dj)
    opt = j_make_optimizer(1e-3)
    jt = JTrainer(loss_fn=j_fn, optimizer=opt, context=dj)
    j_state, _ = jt._train_step(JState.create(params, opt),
                                (jnp.asarray(x), jnp.asarray(y)), jt.context)

    loss_fn = mesh_graph_loss_fn(pm)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    loss, preds = loss_fn(batch, dp)
    assert preds.shape == (BATCH, n, CH)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    state = TrainState(pm, make_optimizer(pm.parameters(), 1e-3))
    Trainer(loss_fn, "cpu", context=dp).train_step(state, batch)
    assert state.step == 1

    want_g, want_p = _flat(j_grads), _flat(j_state.params)
    assert set(grads) == set(want_g)
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(j_loss), **TOL)
        for k in grads:
            np.testing.assert_allclose(grads[k], want_g[k], **TOL, err_msg=k)
    else:  # bf16 rounds at other places in the two frameworks
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-2)
        for k in grads:
            np.testing.assert_allclose(grads[k], want_g[k], rtol=1e-2,
                                       atol=1e-2 * np.abs(want_g[k]).max(),
                                       err_msg=k)
    # Adam's first step moves each param by lr·g/(|g| + eps). In bf16 that
    # is noise where |g| is at the rounding level, so there the update is
    # held only where the gradient is above 1e-2 of its largest value, to
    # 1e-2 of lr.
    for k, p in pm.named_parameters():
        got = p.detach().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want_p[k], **TOL, err_msg=k)
        else:
            g = np.abs(want_g[k])
            sure = g > 1e-2 * g.max()
            np.testing.assert_allclose(got[sure], want_p[k][sure], rtol=0,
                                       atol=1e-5, err_msg=k)


REMAT = [True, "save_agg", "save_agg:1", "nested:1", "nested:2"]


@pytest.mark.parametrize("remat", REMAT, ids=[str(r) for r in REMAT])
def test_remat_policies_give_the_same_gradients(remat, same_rcm):
    _, dp, n = _mesh(True)
    x, y = _batch(n, seed=4)
    grads = []
    for policy in (False, remat):
        _, _, pm = _models(remat=policy)
        loss, _ = mesh_graph_loss_fn(pm)((torch.from_numpy(x), torch.from_numpy(y)), dp)
        loss.backward()
        grads.append({k: p.grad for k, p in pm.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", ["nested", "nested:0", "save_agg:x", "sometimes"])
def test_bad_remat_policies_raise(remat):
    with pytest.raises(ValueError, match="remat"):
        EncodeProcessDecode(2, 2, device="cpu", latent_size=32, remat=remat)


@pytest.mark.parametrize("scheduler,warmup", [("none", 0), ("none", 4),
                                              ("cosine", 0), ("cosine", 4),
                                              ("cyclic", 0), ("cyclic", 4)])
def test_make_schedule_matches_optax(scheduler, warmup):
    kw = dict(total_steps=40, warmup_steps=warmup, cycle_steps=10)
    js = j_make_schedule(3e-3, scheduler, **kw)
    ps = make_schedule(3e-3, scheduler, **kw)
    for step in (0, 1, warmup, warmup + 5, warmup + 23):  # 5: a cycle's midpoint
        want = float(js(step)) if callable(js) else float(js)
        assert ps(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step
    # The optimizer applies the schedule from its first update on.
    w = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([w], 3e-3, scheduler=scheduler, **kw)
    seen = []
    for _ in range(3):
        seen.append(opt.optim.param_groups[0]["lr"])
        w.grad = torch.ones(3)
        opt.step([w])
    assert seen == pytest.approx([ps(0), ps(1), ps(2)], rel=1e-6, abs=1e-12)


def test_adamw_and_clipping_match_optax():
    g = np.array([3.0, -4.0, 0.5], np.float32)
    p0 = np.array([1.0, 2.0, -1.0], np.float32)
    jopt = j_make_optimizer(1e-2, weight_decay=0.1, grad_clip=1.0)
    st = jopt.init(jnp.asarray(p0))
    jp = jnp.asarray(p0)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([w], 1e-2, weight_decay=0.1, grad_clip=1.0)
    assert isinstance(opt.optim, torch.optim.AdamW)
    for _ in range(3):
        upd, st = jopt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        w.grad = torch.from_numpy(g.copy())
        opt.step([w])
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)


def test_checkpoint_round_trip_and_resume(tmp_path):
    _, gp, n = _mesh(False)
    _, _, pm = _models(latent=32)
    ck = Checkpointer(tmp_path / "ck", max_to_keep=2)
    assert ck.latest_step() is None
    state = TrainState(pm, make_optimizer(pm.parameters(), 1e-3))
    trainer = Trainer(mesh_graph_loss_fn(pm), "cpu", checkpointer=ck, context=gp)
    batches = [_batch(n, seed=s) for s in range(3)]
    trainer.fit(state, lambda ep: batches, epochs=1, checkpoint_every=1)
    assert ck.steps() == [2, 3]  # max_to_keep
    saved = {k: v.clone() for k, v in pm.state_dict().items()}
    trainer.fit(state, lambda ep: batches[:1], epochs=1)
    assert state.step == 4

    # Restore into a fresh state: params, optimizer moments and step.
    _, _, fresh = _models(latent=32)
    st2 = TrainState(fresh, make_optimizer(fresh.parameters(), 1e-3))
    ck.restore(st2, step=3)
    assert st2.step == 3
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, saved[k])
    # Resuming continues from the latest checkpoint (step 4).
    _, _, again = _models(latent=32)
    st3 = TrainState(again, make_optimizer(again.parameters(), 1e-3))
    Trainer(mesh_graph_loss_fn(again), "cpu", checkpointer=ck, context=gp).fit(
        st3, lambda ep: batches[:1], epochs=1, resume=True)
    assert st3.step == 5
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(st3)


def test_fit_on_segment_path_matches_reference(tmp_path):
    """Five ``Trainer.fit`` steps on the CPU segment path from the same
    params and batches: per-step losses within 1e-4 of the reference's."""
    from gwen_tpu.registry import Registry as JRegistry

    gj, gp, n = _mesh(False)
    jm, params, pm = _models(latent=32)
    batches = [_batch(n, seed=10 + s) for s in range(5)]
    jrun = JRegistry(tmp_path / "j").create_run("E")
    opt = j_make_optimizer(1e-3)
    JTrainer(loss_fn=j_loss_fn(jm), optimizer=opt, context=gj, run=jrun,
             log_every=1).fit(JState.create(params, opt), lambda ep: batches, 1)
    prun = Registry(tmp_path / "p").create_run("E")
    state = TrainState(pm, make_optimizer(pm.parameters(), 1e-3))
    _, best = Trainer(mesh_graph_loss_fn(pm), "cpu", run=prun, log_every=1,
                      context=gp).fit(state, lambda ep: batches, 1)
    want = [m["value"] for m in jrun.metrics("train_loss")]
    got = [m["value"] for m in prun.metrics("train_loss")]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert best == pytest.approx(np.mean(got), rel=1e-5)
    _, preds = Trainer(mesh_graph_loss_fn(pm), "cpu", context=gp).evaluate(
        pm, batches[:2])
    assert preds.shape == (2 * BATCH, n, CH)


def test_losses_match_reference():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 3, 10, 4)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [(losses.mse_loss(ta, tb), jnp.mean((jnp.asarray(a) - b) ** 2)),
             (losses.l1_loss(ta, tb), j_losses.l1_loss(jnp.asarray(a), b)),
             (losses.rmse(ta, tb), j_losses.rmse(jnp.asarray(a), b))]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), **TOL)


# The port's GraphCast and GenCast keys (model.architecture "graphcast" and
# "gencast"), which the reference's configuration does not have.
PORT_ONLY = {"graph": ("grid_lat", "grid_lon", "g2m_radius", "k_hop"),
             "model": ("channels_in", "channels_out", "ffn_size")}


def shared_keys(cfg: GwenConfig) -> dict:
    d = cfg.to_dict()
    for section, keys in PORT_ONLY.items():
        for k in keys:
            del d[section][k]
    return d


def test_config_data_and_remat_helpers_match_reference():
    assert shared_keys(GwenConfig()) == JConfig().to_dict()
    ov = ["train.remat=save_agg", "train.batch_size=4", "graph.refine=2"]
    assert (shared_keys(GwenConfig().apply_overrides(ov))
            == JConfig().apply_overrides(ov).to_dict())
    fj, vj, sj, rj = j_synthetic(levels=2, members=3, steps=5, seed=7)
    fp, vp, sp, rp = mesh_ensemble_dataset(levels=2, members=3, steps=5, seed=7)
    for a, b in ((fj, fp), (vj, vp), (sj, sp), (rj, rp)):
        np.testing.assert_array_equal(a, b)
    for (xj, yj), (xp, yp) in zip(JDataset(fj).batches(4, shuffle=True, seed=3),
                                  MeshEnsembleDataset(fp).batches(4, shuffle=True, seed=3)):
        np.testing.assert_array_equal(xj, xp)
        np.testing.assert_array_equal(yj, yp)
    for budget in (0, 10**6, 10**7, 10**9):
        kw = dict(budget_bytes=budget, reserved_bytes=10**5)
        assert remat_policy_for_budget(1000, 256, 4, **kw) == j_policy(1000, 256, 4, **kw)


def test_train_mesh_cli_trains_and_feeds_serving(tmp_path, capsys):
    """``train-mesh`` on the CPU (RCM order, segment path), the registry
    run it leaves, and a served step from its exported params."""
    root = tmp_path / "runs"
    rc = cli(["train-mesh", "graph.refine=2", "model.latent_size=32",
              "model.process_steps=2", "train.batch_size=4", "train.log_every=1",
              "train.checkpoint_every=2", f"run.registry_root={root}",
              "--members", "3", "--steps", "5", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["layout"] == "Graph" and out["steps"] == 2
    assert np.isfinite(out["best_train_loss"])
    run = Run(tmp_path / out["run_dir"])
    assert run.meta["status"] == "FINISHED"
    assert run.meta["best_metric"] == pytest.approx(out["best_train_loss"])
    assert len(run.metrics("train_loss")) == 2
    assert Checkpointer(root / "checkpoints" / out["run_id"]).latest_step() == 2
    params, cfg = Registry(root).load_best_model("GWEN_MESH")
    assert cfg["latent_size"] == 32 and cfg["nodes"] == out["nodes"]
    model = model_from_metadata(cfg, "cpu")
    model.load_state_dict(params)
    art = export_model(model, np.zeros((out["nodes"], 1), np.float32),
                       tmp_path / "art", metadata=cfg)
    sm = ServingModel.load(art, "cpu")
    y = sm.step(torch.zeros(out["nodes"], 1))
    assert y.shape == (out["nodes"], 1) and torch.isfinite(y).all()


@pytest.mark.parametrize("args,exc", [
    # partitioned attention needs the diag partition layout
    (["mesh.force_partition=true", "model.processor=attention", "graph.refine=2"],
     ValueError),
    (["model.processor=attention", "mesh.kernel=packed", "graph.refine=2"],
     ValueError),
    (["mesh.force_partition=true", "mesh.partition_layout=tiles", "graph.refine=2"],
     ValueError),
    (["mesh.kernel=diag_packed", "model.processor=interaction", "graph.refine=2"],
     ValueError),
    (["--data", "store.zarr"], FileNotFoundError),
    (["--device", "cuda"], RuntimeError),
])
def test_train_mesh_refuses_what_is_not_ported(args, exc, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train-mesh", f"run.registry_root={tmp_path}", *args]
    if "--device" not in args:
        argv += ["--device", "cpu"]
    with pytest.raises(exc):
        cli(argv)


@pytest.mark.parametrize("args,layout,packed", [
    (["mesh.kernel=diag_packed", "model.processor=attention"], "DiagWindowGraph", True),
    (["mesh.kernel=packed"], "Graph", False),
], ids=["diag_packed-attention", "packed-gcn"])
def test_train_mesh_cli_on_the_packed_kernels(args, layout, packed, tmp_path, capsys):
    """``train-mesh`` on the CPU with the bit-packed kernels: attention takes
    the packed diag layout (neighbour lists from the S01 bits); GCN on
    ``mesh.kernel=packed`` takes the segment path, as the reference does on
    any backend but its accelerator."""
    rc = cli(["train-mesh", "graph.refine=3", "model.latent_size=32",
              "model.process_steps=2", "train.batch_size=4", *args,
              f"run.registry_root={tmp_path}", "--members", "3", "--steps", "5",
              "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["layout"], out["packed"]) == (layout, packed)
    assert out["steps"] == 2 and np.isfinite(out["best_train_loss"])


@pytest.mark.parametrize("kernel,layout", [
    ("packed", "SlidingPackedGraph"), ("sliding", "SlidingDenseGraph"),
    ("auto", "SlidingDenseGraph"),
])
def test_banded_layout_follows_the_reference_choice(kernel, layout, monkeypatch):
    """The CUDA GCN path off the diag layout: ``packed`` takes the bit-packed
    banded layout, ``sliding`` the weighted one, any other kernel the
    weighted one unless its S would reach 7 GiB (the reference's formula)."""
    from gwen_tpu_torch.cli import train_mesh
    from gwen_tpu_torch.graph import apply_order, icosphere_edges, rcm_order

    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    s2, r2, _ = apply_order(rcm_order(s, r, n), s, r)
    g = P.build_graph(s2, r2, n)
    graph = train_mesh.banded_layout(g, s2, r2, kernel, torch.float32)
    assert type(graph).__name__ == layout
    if kernel == "auto":  # a band wide enough for 7 GiB takes the packed one
        monkeypatch.setattr("gwen_tpu_torch.graph.bandwidth", lambda *a: 2**30)
        graph = train_mesh.banded_layout(g, s2, r2, kernel, torch.float32)
        assert type(graph).__name__ == "SlidingPackedGraph"


@pytest.mark.parametrize("remat", [False, True, "save_agg", "save_agg:1", "nested:1", "nested:2"])
def test_kernel_calls_per_step_follow_the_remat_policy(remat, same_rcm, monkeypatch):
    """``chip_smoke.expected_launches`` (what the chip run holds the launch
    counts to) against the calls one batched train step makes, counted on
    the CPU at the plain versions the wrappers run there."""
    import chip_smoke
    from gwen_tpu_torch.ops import fused_ln, spmm_cuda

    calls = {"B4": 0, "B10": 0, "B2": 0, "B2b": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    for key, mod, name in (("B4", spmm_cuda, "diag_window_spmm_plain"),
                           ("B10", spmm_cuda, "sliding_spmm_plain"),
                           ("B2", fused_ln, "residual_layernorm_plain"),
                           ("B2b", fused_ln, "residual_layernorm_bwd_plain")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    _, dp, n = _mesh(True)
    _, _, pm = _models(remat=remat)
    x, y = _batch(n, seed=6)
    loss, _ = mesh_graph_loss_fn(pm)((torch.from_numpy(x), torch.from_numpy(y)), dp)
    loss.backward()
    want = chip_smoke.expected_launches(remat, STEPS)
    assert calls == {k: want[k] for k in calls}
