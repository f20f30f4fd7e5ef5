"""The member-graph pipeline and store-backed mesh training of the port
against the reference package on the CPU.

``GCNStack``, ``gnn_loss_fn`` (every loss) and three ``Trainer.fit`` steps
run in both packages from the same numpy inputs and the same (converted)
parameters; float32, ``rtol = atol = 1e-4`` unless stated. The CLI pipeline
``ingest → preprocess → train-gnn → gif`` draws its initial weights from a
``torch.Generator`` where the reference draws them from a JAX key, so its
``test_loss`` is held to be finite and the registry round trip
(``train.retrain=false`` loads the best model and reproduces the test loss)
to work; equality with the reference is what the ``fit`` test holds.
``make-mesh-data → train-mesh --data`` runs eager and lazy (the same
losses), its run is exported and served, and the served step is compared
with the JAX model on the same store and weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu.train as j_train
from gwen_tpu.nn import EncodeProcessDecode as JEPD
from gwen_tpu.nn import GCNStack as JGCNStack
from gwen_tpu_torch import graph as P
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.data import MemberGraphDataset, netcdf, zarrstore
from gwen_tpu_torch.nn import GCNStack, params_from_jax, params_to_tree
from gwen_tpu_torch.registry import Registry
from gwen_tpu_torch.serve import ServingModel, export_model
from gwen_tpu_torch.train import Trainer, TrainState, gnn_loss_fn, make_optimizer

TOL = dict(rtol=1e-4, atol=1e-4)
N, F, HID = 7, 12, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def member():
    """A member graph (edge probability 0.6: on the fully connected graph
    every node would get the same output and the losses over the member
    axis would be degenerate), both models with the same weights, and a
    batch."""
    s, r = J.erdos_renyi_edges(N, 0.6, seed=0)
    jg = J.to_dense(J.build_graph(s, r, N))
    pg = P.to_dense(P.build_graph(s, r, N))
    jm = JGCNStack(channels_in=F, channels_out=F, hidden_feats=HID)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, N, F)).astype(np.float32)
    mask = np.zeros(N, bool)
    mask[[1, 4, 5]] = True
    return dict(jg=jg, pg=pg, jm=jm, params=params, x=x, mask=mask)


def _port_model(params):
    pm = GCNStack(F, F, device="cpu", hidden_feats=HID)
    pm.load_state_dict(params_from_jax(_np_tree(params)))
    return pm


def test_gcn_stack_matches_reference(member):
    pm = _port_model(member["params"])
    assert pm.widths == member["jm"].widths == [12, 16, 8, 4, 8, 16, 12]
    assert sorted(pm.state_dict()) == sorted(
        f"gcn_{i}.{k}" for i in range(6) for k in "bw")
    want = member["jm"].apply(member["params"], member["jg"], jnp.asarray(member["x"]))
    got = pm(member["pg"], torch.from_numpy(member["x"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # One sample, and the same stack over a COO graph.
    one = pm(member["pg"], torch.from_numpy(member["x"][0]))
    np.testing.assert_allclose(one.detach().numpy(), np.asarray(want)[0], **TOL)
    # A seed gives the same fresh weights twice.
    a = GCNStack(F, F, device="cpu", hidden_feats=HID,
                 generator=torch.Generator().manual_seed(3)).state_dict()
    b = GCNStack(F, F, device="cpu", hidden_feats=HID,
                 generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("loss,fmask,with_target", [
    ("l1-masked", False, False), ("l1-masked", False, True),
    ("l1-masked", True, False), ("ensemble-var-reg", False, False),
    ("crps", False, False)],
    ids=["l1-masked", "l1-masked-target", "variance-mask", "ensemble-var-reg",
         "crps"])
def test_gnn_loss_value_and_gradients_match_reference(member, loss, fmask,
                                                      with_target):
    feat = (np.random.default_rng(1).random(F) > 0.4).astype(np.float32) if fmask else None
    batch = {"x": member["x"], "mask": member["mask"]}
    if with_target:
        batch["target"] = member["x"] + 0.5
        batch["x"] = np.where(member["mask"][None, :, None], 0, member["x"]).astype(np.float32)
    j_fn = j_train.gnn_loss_fn(member["jm"], member["jg"], loss=loss,
                               mask_threshold_mask=feat, var_reg_alpha=0.2)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_val, j_preds), j_grads = jax.value_and_grad(j_fn, has_aux=True)(
        member["params"], j_batch)
    pm = _port_model(member["params"])
    p_fn = gnn_loss_fn(pm, member["pg"], loss=loss, mask_threshold_mask=feat,
                       var_reg_alpha=0.2)
    val, preds = p_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(j_preds), **TOL)
    j_grads = params_from_jax(_np_tree(j_grads))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def test_gnn_loss_refuses_unknown_loss(member):
    with pytest.raises(ValueError, match="unknown GNN loss"):
        gnn_loss_fn(_port_model(member["params"]), member["pg"], loss="mse")


def test_three_fit_steps_match_reference_trainer(member):
    values = np.random.default_rng(2).normal(size=(6, N, 3, 4)).astype(np.float32)
    ds = MemberGraphDataset(data=values, member_split=4, seed=1)

    def batches(ep):
        return ({"x": x, "mask": m} for x, m in ds.batches(2, shuffle=True, seed=ep))

    opt = optax.adam(1e-2)
    j_tr = j_train.Trainer(loss_fn=j_train.gnn_loss_fn(member["jm"], member["jg"]),
                           optimizer=opt, log_every=0)
    pm = _port_model(member["params"])
    # The reference's step donates its state: train on a copy.
    start = jax.tree_util.tree_map(jnp.array, member["params"])
    j_state, j_best = j_tr.fit(j_train.TrainState.create(start, opt),
                               batches, epochs=1)
    tr = Trainer(gnn_loss_fn(pm, member["pg"]), "cpu", log_every=0)
    state, best = tr.fit(TrainState(pm, make_optimizer(pm.parameters(), 1e-2)),
                         batches, epochs=1)
    assert state.step == int(j_state.step) == 3
    np.testing.assert_allclose(best, j_best, rtol=1e-4)
    want = params_from_jax(_np_tree(j_state.params))
    for name, p in pm.named_parameters():
        # Three Adam steps of 1e-2: an entry whose gradient is ~0 may move
        # the other way in one package, so hold the bulk tightly and every
        # entry to within the steps taken.
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 3.1e-2 and np.median(diff) <= 1e-5, name
    # evaluate returns the mean loss and the stacked predictions.
    test_batches = [{"x": x, "mask": m} for x, m in ds.batches(1)]
    loss, preds = tr.evaluate(pm, iter(test_batches))
    j_loss, j_preds = j_tr.evaluate(
        params_to_tree_jax(pm), iter(test_batches))
    assert preds.shape == j_preds.shape == (6, N, 12)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    np.testing.assert_allclose(preds, j_preds, **TOL)


def params_to_tree_jax(model):
    """A port model's parameters as the reference's param tree."""
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().numpy()),
        params_to_tree(dict(model.named_parameters())))


# ---------------------------------------------------------------------- CLI

T, H, C = 12, 4, 6


@pytest.fixture
def workdir(tmp_path):
    pytest.importorskip("h5py")
    for i in range(4):
        mid = f"{-10 - i}.0_3000.0_2000.0"
        folder = tmp_path / f"atmcirc-straka_93_{mid}"
        folder.mkdir()
        t = np.arange(T)[:, None, None]
        h = np.arange(H)[None, :, None]
        c = np.arange(C)[None, None, :]
        field = (280 + 5 * np.sin(0.3 * t + 0.2 * i)
                 * np.cos(0.5 * h + 0.1 * c)).astype(np.float32)
        netcdf.write_netcdf_like(
            folder / f"atmcirc-straka_93_{mid}_DOM01_ML_20080801T000000Z.nc",
            {"theta_v": (("time", "height", "ncells"), field)})
    cfg = {
        "batch_size": 2, "coarsen": 1, "data_path": str(tmp_path),
        "data_test": str(tmp_path / "test.zarr"),
        "data_train": str(tmp_path / "train.zarr"), "epochs": 2,
        "filename_regex": r"atmcirc-straka_93_(.+)_DOM01_ML_.*\.nc",
        "hidden_feats": 16, "lr": 1e-4, "mask_threshold": 0.0,
        "member_split": 3, "retrain": True, "seed": 42, "simplify": False,
        "zarr_path": str(tmp_path / "combined.zarr"),
        "zlib_compression_level": 1,
    }
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return tmp_path, cfg_path


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_full_pipeline(workdir, capsys, monkeypatch):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    wd, cfg = workdir
    common = ["--config", str(cfg), f"run.registry_root={wd / 'runs'}",
              "data.boundary_cells=0", f"data.scaling_path={wd / 'scaling.json'}"]
    assert cli(["ingest", *common]) == 0
    assert _last_json(capsys)["shape"] == [T, 4, H, C]
    assert cli(["preprocess", *common]) == 0
    capsys.readouterr()
    assert cli(["train-gnn", *common, "--out-dir", str(wd / "output"),
                "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert np.isfinite(out["test_loss"]) and np.isfinite(out["best_train_loss"])
    assert len(out["animations"]) == 2 and out["device"] == "cpu"
    run = Registry(wd / "runs").get_runs("GWEN")[0]
    assert run.run_id == out["run_id"] and run.meta["status"] == "FINISHED"
    assert [m["value"] for m in run.metrics("test_loss")] == [out["test_loss"]]
    assert len(run.metrics("loss")) == 2
    # retrain=false: the registry's best model, evaluated, no training.
    assert cli(["train-gnn", *common, "--no-animate", "--device", "cpu",
                "train.retrain=false"]) == 0
    again = _last_json(capsys)
    assert again["test_loss"] == out["test_loss"] and "animations" not in again
    # The variance-mask branch and node batches, streaming from the store.
    assert cli(["train-gnn", *common, "--no-animate", "--device", "cpu",
                "train.mask_threshold=0.001", "train.node_batch_size=2",
                "data.lazy=true", "train.epochs=1"]) == 0
    assert np.isfinite(_last_json(capsys)["test_loss"])
    assert cli(["gif", "--input", str(wd / "test.zarr"), "--out", str(wd / "gifs"),
                "--member", "0"]) == 0
    assert len(_last_json(capsys)["gifs"]) == 1
    # A bare `gif` prompts for its inputs.
    answers = iter([str(wd / "test.zarr"), "", str(wd / "gifs_i")])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert cli(["gif", "--member=-10.0_3000.0_2000.0"]) == 0
    assert len(_last_json(capsys)["gifs"]) == 1


def test_train_gnn_needs_cuda_or_says_so(workdir, monkeypatch):
    wd, cfg = workdir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["train-gnn", "--config", str(cfg), "--no-animate"])


def test_cli_offers_the_ported_subcommands(capsys):
    with pytest.raises(SystemExit):
        cli(["--help"])
    text = capsys.readouterr().out
    for name in ("ingest", "preprocess", "train-gnn", "train-cnn", "train-mesh",
                 "make-mesh-data", "export", "predict", "runs", "gif", "bench"):
        assert name in text
    # `bench` is offered, with the options of the port's other subcommands.
    with pytest.raises(SystemExit):
        cli(["bench", "--help"])
    text = capsys.readouterr().out
    assert "--device" in text and "--extra-out" in text


def test_missing_libraries_raise_where_they_are_used(monkeypatch, tmp_path):
    """h5py, matplotlib and Pillow are imported inside the functions that
    need them: without them the package still imports and the call raises
    the reference's RuntimeError."""
    import builtins

    from gwen_tpu_torch import viz

    real = builtins.__import__

    def no_libs(name, *a, **kw):
        if name.split(".")[0] in ("h5py", "matplotlib", "PIL"):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_libs)
    with pytest.raises(RuntimeError, match="h5py is required"):
        netcdf.list_variables(tmp_path / "f.nc")
    with pytest.raises(RuntimeError, match="matplotlib is required"):
        viz.render_frames(np.zeros((2, 3, 3), np.float32))
    with pytest.raises(RuntimeError, match="Pillow is required"):
        viz.save_gif([np.zeros((2, 2, 3), np.uint8)], tmp_path / "a.gif")
    assert viz.get_member_name("-10.0_3000.0_2000.0") == (
        "Temp: -10 °C; Height: 3000 m; Width: 2000 m")


# ------------------------------------------------------- train-mesh --data


@pytest.mark.parametrize("partition", [False, True], ids=["global", "partitioned"])
def test_train_mesh_from_a_store_eager_and_lazy(tmp_path, capsys, partition):
    store = tmp_path / "mesh.zarr"
    assert cli(["make-mesh-data", "--out", str(store), "--members", "3",
                "--steps", "5", "graph.refine=2"]) == 0
    made = _last_json(capsys)
    assert made == {"path": str(store), "fields": [5, 3, 162, 1]}
    assert zarrstore.open_array(store).meta["kind"] == "mesh-ensemble"
    outs = []
    for lazy in ("false", "true"):
        assert cli(["train-mesh", "--data", str(store), "--device", "cpu",
                    "graph.refine=2", "model.latent_size=16",
                    "model.compute_dtype=float32", "train.batch_size=2",
                    f"run.registry_root={tmp_path / 'runs'}", f"data.lazy={lazy}",
                    *(["mesh.force_partition=true"] if partition else [])]) == 0
        outs.append(_last_json(capsys))
    eager, lazy = outs
    assert eager["steps"] == lazy["steps"] == 4 and eager["nodes"] == 162
    assert eager["best_train_loss"] == pytest.approx(lazy["best_train_loss"],
                                                     rel=1e-5)
    for k in ("skill_crps", "skill_rmse_ensemble_mean", "skill_spread"):
        # The same numbers from arrays laid out differently in memory.
        assert np.isfinite(eager[k]) and eager[k] == pytest.approx(lazy[k], rel=1e-5)
    run = Registry(tmp_path / "runs").get_runs("GWEN_MESH")[0]
    assert run.load_model()[1]["data"] == str(store)


def test_store_trained_run_exports_and_serves_like_the_jax_model(tmp_path, capsys):
    """``train-mesh --data`` → ``export_model`` → ``ServingModel.load`` (the
    graph from the store's sidecar) → ``predict``, against the JAX model
    with the run's weights on the same store's mesh. 1e-3: three steps and
    LayerNorm amplify the different summation orders."""
    from gwen_tpu.data.meshstore import load_mesh_dataset as j_load
    from gwen_tpu_torch.serve import model_from_metadata

    store = tmp_path / "mesh.zarr"
    cli(["make-mesh-data", "--out", str(store), "--members", "3", "--steps", "5",
         "graph.refine=2"])
    cli(["train-mesh", "--data", str(store), "--device", "cpu", "graph.refine=2",
         "model.latent_size=16", "model.compute_dtype=float32",
         "train.batch_size=2", f"run.registry_root={tmp_path / 'runs'}"])
    capsys.readouterr()
    params, md = Registry(tmp_path / "runs").load_best_model("GWEN_MESH")
    model = model_from_metadata(md, "cpu")
    model.load_state_dict(params)
    art = export_model(model, np.zeros((162, 1), np.float32), tmp_path / "art", md)
    sm = ServingModel.load(art, "cpu")
    assert type(sm.graph).__name__ == "DiagWindowGraph" and sm.graph.num_nodes == 162

    fields, s, r, verts, _ = j_load(store)  # the reference reads the port's store
    x0 = np.ascontiguousarray(fields[0, 0])
    np.save(tmp_path / "x0.npy", x0)
    assert cli(["predict", "--artifact", str(art), "--input", str(tmp_path / "x0.npy"),
                "--steps", "3", "--out", str(tmp_path / "traj.npy"),
                "--device", "cpu"]) == 0
    traj = np.load(tmp_path / "traj.npy")
    jm = JEPD(channels_in=1, channels_out=1, latent_size=16, process_steps=4,
              backend="segment")
    j_params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params_to_tree(params))
    jg = J.build_graph(s, r, 162)  # original node order
    x, want = jnp.asarray(x0), []
    for _ in range(3):
        x = jm.apply(j_params, jg, x)
        want.append(np.asarray(x))
    np.testing.assert_allclose(traj, np.stack(want), rtol=1e-3, atol=1e-3)
    # The store gone, the artifact cannot rebuild its graph.
    (store / "mesh_graph.npz").unlink()
    with pytest.raises(FileNotFoundError, match="missing graph sidecar"):
        ServingModel.load(art, "cpu")
