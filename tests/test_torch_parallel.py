"""The port's partitioned path on two gloo ranks (CPU) against the global
model and against the reference package's partitioned apply.

One spawn for the whole module (the ``replayed`` fixture): two processes
join a gloo group through a file store and replay every case of a file
(``tests/test_torch_replay.py``); the tests read what the ranks wrote.
L3 mesh, latent 32, 2 process steps, float32 at ``rtol = atol = 1e-4``.
Inputs come from numpy seeds, parameters from the reference model through
``params_from_jax``. The reference runs ``make_partitioned_apply`` under
``shard_map`` on two of the virtual CPU devices, through its plain
references (``backend="segment"``), as its own ``tests/test_parallel.py``.
Only the first ``num_nodes`` rows are compared: pad rows hold garbage.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_replay as replay
import gwen_tpu.graph as J
import gwen_tpu_torch.graph as P
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu.parallel import make_partitioned_apply as j_make_apply
from gwen_tpu.parallel import partition_graph as j_partition
from gwen_tpu.train import make_mesh as j_make_mesh
from gwen_tpu.train.optim import make_optimizer as j_make_optimizer
from gwen_tpu.train.tasks import partitioned_ensemble_crps_loss_fn as j_crps_fn
from gwen_tpu.train.tasks import partitioned_rollout_loss_fn as j_rollout_fn
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.dryrun import dryrun_multichip, spawn_ranks
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax
from gwen_tpu_torch.train import make_optimizer

TOL = dict(rtol=1e-4, atol=1e-4)
LATENT, STEPS, CH, BATCH = 32, 2, 2, 2
DIAG = dict(block_size=32, layout="diag", diag_window=128, diag_superblock=4)
LAYOUTS = {"sliding": dict(block_size=32, layout="sliding"),
           "dense": dict(block_size=32, layout="dense"),
           "ell": dict(block_size=32, layout="ell"),
           "diag": DIAG}
MODELS = ["gcn-sliding", "gcn-dense", "gcn-ell", "gcn-diag", "attention-diag"]
CLI = ["train-mesh", "graph.refine=3", "model.latent_size=32",
       "model.process_steps=2", "model.compute_dtype=float32",
       "train.batch_size=4", "--members", "3", "--steps", "5", "--device", "cpu"]


def _edges(layout: str):
    """L3 edges in the order the layout wants: KD patches for diag, else RCM."""
    verts, s, r = J.icosphere_edges(3)
    n = verts.shape[0]
    perm = (J.kd_patch_order(verts, s, r, n, leaf_size=128) if layout == "diag"
            else J.rcm_order(s, r, n))
    s2, r2, _ = J.apply_order(perm, s, r)
    return np.asarray(s2, np.int64), np.asarray(r2, np.int64), n


def _jax_model(processor: str):
    jm = JaxEPD(channels_in=CH, channels_out=CH, latent_size=LATENT,
                process_steps=STEPS, processor=processor, attn_heads=2,
                backend="segment" if processor == "gcn" else "auto")
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    return jm, params


def _model_kw(processor: str) -> dict:
    return dict(channels_in=CH, channels_out=CH, latent_size=LATENT,
                process_steps=STEPS, processor=processor, attn_heads=2)


def _pad(x: np.ndarray, rows: int) -> np.ndarray:
    widths = [(0, 0)] * x.ndim
    widths[-2] = (0, rows - x.shape[-2])
    return np.pad(x, widths)


def _padded_nodes(n: int, parts: int, layout: str) -> int:
    mult = 32 * (4 if layout == "diag" else 1)
    return parts * (-(-(-(-n // parts)) // mult) * mult)


def _case(name: str, parts: int = 2, data: int = 1, seed: int = 0, **extra) -> dict:
    processor, layout = name.split("-")[:2]
    s, r, n = _edges(layout)
    _, params = _jax_model(processor)
    rows = _padded_nodes(n, parts, layout)
    rng = np.random.default_rng(seed)
    batch = BATCH * data
    x = rng.normal(size=(batch, n, CH)).astype(np.float32)
    y = (0.9 * x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    case = dict(s=s, r=r, n=n, partition=LAYOUTS[layout], data=data, graph=parts,
                model=_model_kw(processor), state=params_from_jax(params),
                task="mse", crop=True,
                batch=(torch.from_numpy(_pad(x, rows)), torch.from_numpy(_pad(y, rows))))
    case.update(extra)
    return case


def _cases() -> dict:
    cases = {name: _case(name, seed=i) for i, name in enumerate(MODELS)}
    cases["data2"] = _case("gcn-ell", parts=1, data=2, seed=7)
    # Rollout and CRPS through the partitioned apply, as the reference's.
    roll = _case("gcn-sliding", seed=8, task="rollout", horizon=2, crop=False)
    x0, y = roll["batch"]
    roll["batch"] = (x0, torch.stack([y, 0.9 * y], dim=1))
    cases["rollout"] = roll
    crps = _case("gcn-ell", seed=9, task="crps", members=2, sigma=0.05, crop=False)
    x, y = crps["batch"]
    noise = jax.random.normal(jax.random.key(3), (x.shape[0], 2, *x.shape[1:]),
                              jnp.float32)
    crps["batch"] = (x, y, torch.from_numpy(np.array(noise)))
    cases["crps"] = crps
    return cases


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    """The cases, and what two gloo ranks computed for each (one spawn,
    killed after 240 s)."""
    tmp = tmp_path_factory.mktemp("replay")
    cases = _cases()
    cases["cli"] = {"cli": [*CLI, "mesh.graph_axis=2",
                            f"run.registry_root={tmp / 'runs2'}"]}
    torch.save(cases, tmp / "cases.pt")
    spawn_ranks(replay.replay_rank, 2,
                (str(tmp / "store"), str(tmp / "cases.pt"), str(tmp)), 240.0)
    results = [torch.load(tmp / f"rank_{k}.pt", weights_only=False)
               for k in range(2)]
    return cases, results, tmp


def _global_step(case: dict):
    """The unpartitioned model on the global graph: predictions, the MSE
    over the real nodes, its gradients."""
    n, kw = case["n"], case["model"]
    g = P.build_graph(case["s"], case["r"], n)
    if kw["processor"] == "attention":
        rows = case["batch"][0].shape[-2]
        graph = P.to_diag_window(g, window_size=128, block_size=32, superblock=4,
                                 n_pad=rows, transpose_tables=True)
        model = EncodeProcessDecode(device="cpu", **kw)
    else:
        graph = g
        model = EncodeProcessDecode(device="cpu", backend="segment", **kw)
    model.load_state_dict(case["state"])
    x, y = (t[:, :n] for t in case["batch"][:2])
    preds = model(graph, x)
    loss = torch.mean((preds - y) ** 2)
    loss.backward()
    return preds.detach(), loss.item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", MODELS)
def test_partitioned_forward_matches_global(name, replayed):
    cases, results, _ = replayed
    case = cases[name]
    preds = replay.gather_preds(results, name)
    assert preds.shape == case["batch"][0].shape
    want, _, _ = _global_step(case)
    np.testing.assert_allclose(preds[:, :case["n"]].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_partitioned_gradients_match_global(name, replayed):
    """The mean over the real nodes: both ranks hold the global loss and the
    summed gradients, those of the unpartitioned model."""
    cases, results, _ = replayed
    _, loss, grads = _global_step(cases[name])
    for res in results:
        np.testing.assert_allclose(res[name]["crop_loss"], loss, **TOL)
        assert set(res[name]["crop_grads"]) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(res[name]["crop_grads"][k].numpy(),
                                       g.numpy(), **TOL, err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _reference_apply(case: dict):
    """The reference's partitioned apply of the case on a (1, parts) mesh."""
    kw = case["model"]
    jm, params = _jax_model(kw["processor"])
    pg = j_partition(case["s"], case["r"], case["n"], num_parts=case["graph"],
                     reorder=False, **case["partition"])
    mesh = j_make_mesh(data=1, graph=case["graph"],
                       devices=jax.devices()[:case["graph"]])
    return j_make_apply(jm, pg, mesh), params


@pytest.mark.parametrize("name", MODELS)
def test_partitioned_step_matches_reference(name, replayed):
    """Predictions, the loss over the padded node space (pad rows count in
    the reference's mean too), every gradient and the parameters after one
    Adam step against the reference's ``shard_map`` step."""
    cases, results, _ = replayed
    case = cases[name]
    apply, params = _reference_apply(case)
    x, y = (jnp.asarray(t.numpy()) for t in case["batch"])

    def loss_fn(p):
        preds = apply(p, x)
        return jnp.mean((preds - y) ** 2), preds

    (loss, preds), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    opt = j_make_optimizer(1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    n = case["n"]
    got = replay.gather_preds(results, name)
    np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(preds)[:, :n], **TOL)
    want_g, want_p = _flat(grads), _flat(new)
    for res in results:
        np.testing.assert_allclose(res[name]["loss"], float(loss), **TOL)
        for k in want_g:
            np.testing.assert_allclose(res[name]["grads"][k].numpy(), want_g[k],
                                       **TOL, err_msg=k)
            np.testing.assert_allclose(res[name]["params"][k].numpy(), want_p[k],
                                       **TOL, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_world_size_one_runs_in_process(name):
    """One partition, no process group: zero halos, no collective; the
    global model's predictions and gradients."""
    case = _case(name, parts=1, seed=11)
    res = replay.run_case(case)
    want, loss, grads = _global_step(case)
    np.testing.assert_allclose(res["preds"][:, :case["n"]].numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(res["crop_loss"], loss, **TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(res["crop_grads"][k].numpy(), g.numpy(), **TOL,
                                   err_msg=k)


def test_data_parallel_matches_single_process(replayed):
    """Two ranks as ``data=2``: each takes half the batch; the summed loss
    and gradients and the Adam step are the single process's."""
    cases, results, _ = replayed
    one = replay.run_case({**cases["data2"], "data": 1})
    preds = replay.gather_preds(results, "data2")
    np.testing.assert_allclose(preds.numpy(), one["preds"].numpy(), **TOL)
    assert {res["data2"]["coords"] for res in results} == {(0, 0), (1, 0)}
    for res in results:
        assert res["data2"]["preds"].shape[0] == BATCH
        np.testing.assert_allclose(res["data2"]["loss"], one["loss"], **TOL)
        for key in ("grads", "params", "crop_grads"):
            for k, v in one[key].items():
                np.testing.assert_allclose(res["data2"][key][k].numpy(), v.numpy(),
                                           **TOL, err_msg=f"{key} {k}")


def test_partitioned_rollout_matches_reference(replayed):
    cases, results, _ = replayed
    case = cases["rollout"]
    apply, params = _reference_apply(case)
    batch = tuple(jnp.asarray(t.numpy()) for t in case["batch"])
    fn = j_rollout_fn(apply, 2)
    (loss, preds), grads = jax.jit(jax.value_and_grad(
        lambda p: fn(p, batch, apply.tables), has_aux=True))(params)
    got = replay.gather_preds(results, "rollout")
    assert got.shape == case["batch"][1].shape
    n = case["n"]
    np.testing.assert_allclose(got[:, :, :n].numpy(), np.asarray(preds)[:, :, :n], **TOL)
    for res in results:
        np.testing.assert_allclose(res["rollout"]["loss"], float(loss), **TOL)
        for k, g in _flat(grads).items():
            np.testing.assert_allclose(res["rollout"]["grads"][k].numpy(), g, **TOL,
                                       err_msg=k)


def test_partitioned_crps_matches_reference(replayed):
    """The same white noise on both sides (drawn once from the reference's
    key): loss, ensemble-mean predictions and gradients."""
    cases, results, _ = replayed
    case = cases["crps"]
    apply, params = _reference_apply(case)
    x, y, _ = (jnp.asarray(t.numpy()) for t in case["batch"])
    noise_graph = J.build_graph(case["s"], case["r"], x.shape[-2])
    fn = j_crps_fn(apply, num_members=2, sigma=0.05)
    (loss, preds), grads = jax.jit(jax.value_and_grad(
        lambda p: fn(p, (x, y, jax.random.key(3)), (apply.tables, noise_graph)),
        has_aux=True))(params)
    got = replay.gather_preds(results, "crps")
    n = case["n"]
    np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(preds)[:, :n], **TOL)
    for res in results:
        np.testing.assert_allclose(res["crps"]["loss"], float(loss), **TOL)
        for k, g in _flat(grads).items():
            np.testing.assert_allclose(res["crps"]["grads"][k].numpy(), g, **TOL,
                                       err_msg=k)


def test_train_mesh_two_ranks_matches_one_rank(replayed, tmp_path, capsys):
    """``train-mesh mesh.graph_axis=2`` over two ranks: rank 0 alone reports,
    with the numbers of the one-rank partitioned run (the same padded node
    space) and, up to the pad rows in the mean, of the unpartitioned run."""
    _, results, _ = replayed
    assert [res["cli"]["rc"] for res in results] == [0, 0]
    assert [res["cli"]["main"] for res in results] == [True, False]
    two = results[0]["cli"]["json"]
    assert results[1]["cli"]["json"] is None
    assert (two["layout"], two["graph_parts"], two["world"]) == ("HaloGraph", 2, 2)

    def run(*args):
        assert cli([*CLI, *args, f"run.registry_root={tmp_path}"]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    one = run("mesh.force_partition=true")
    assert (one["graph_parts"], one["steps"]) == (1, two["steps"])
    for k in ("best_train_loss", "skill_crps", "skill_rmse_ensemble_mean",
              "skill_spread"):
        np.testing.assert_allclose(two[k], one[k], **TOL, err_msg=k)
    plain = run()
    pad = 768 / 642  # zero pad rows in the partitioned mean
    np.testing.assert_allclose(two["best_train_loss"] * pad,
                               plain["best_train_loss"], rtol=5e-2)
    np.testing.assert_allclose(two["skill_crps"], plain["skill_crps"], rtol=5e-2)


def test_dryrun_multichip_spawns_two_ranks():
    """The dry run's training step over two spawned gloo ranks gives the
    single process's loss."""
    np.testing.assert_allclose(dryrun_multichip(2, "cpu", timeout_s=120.0),
                               dryrun_multichip(1, "cpu"), rtol=1e-5)


def test_dryrun_multichip_asks_for_the_card():
    """Without ``device="cpu"`` the dry run takes CUDA and raises where
    there is none (or fewer cards than ranks): it never gives way to the
    CPU on its own."""
    assert not torch.cuda.is_available() or torch.cuda.device_count() < 64
    with pytest.raises(RuntimeError, match="CUDA is not available|cards"):
        dryrun_multichip(64)


def test_spawn_ranks_raises_when_a_rank_fails(tmp_path):
    """A rank that raises (here: no case file) ends the spawn with its
    error, and no child is left behind."""
    with pytest.raises(Exception, match="missing.pt"):
        spawn_ranks(replay.replay_rank, 2,
                    (str(tmp_path / "store"), str(tmp_path / "missing.pt"),
                     str(tmp_path)), timeout_s=120.0)


def test_make_optimizer_pairs_with_the_reference():
    """The Adam step the replayed cases take is the one the reference's
    ``make_optimizer`` takes (same defaults)."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    p.grad = torch.tensor([0.5, 0.25])
    make_optimizer([p], 1e-3).step([p])
    opt = j_make_optimizer(1e-3)
    jp = {"p": jnp.asarray([1.0, -2.0])}
    upd, _ = opt.update({"p": jnp.asarray([0.5, 0.25])}, opt.init(jp), jp)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["p"] + upd["p"]),
                               rtol=1e-6)
