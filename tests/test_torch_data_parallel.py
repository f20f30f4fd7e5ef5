"""Data-parallel ``train-gnn`` and ``train-cnn`` of the port on two gloo
ranks (CPU) against one rank and against the reference's ``main``.

One spawn for the whole module (the ``ran`` fixture): two processes join a
gloo group through a file store and run each CLI case
(``tests/test_torch_replay.py``), each with its own registry; the same
cases then run in this process on one rank (no process group), and the
reference's ``gwen_tpu.cli.train_gnn.main`` and ``train_cnn.main`` run on
the same stores, on the 8 virtual CPU devices of ``tests/conftest.py``
(its batch cut over its ``"data"`` axis where 8 divides it, else
replicated). Every run starts from the reference's initial parameters
(``model.init(jax.random.key(seed))``, converted). The global batch is 8
(4 a rank; 1 a device in the reference) or 3 (indivisible: kept whole on
each rank), 2 epochs, Adam. Held at ``rtol = atol = 1e-4`` in float32:
each step's logged loss, each epoch's, the test loss and every parameter of
the saved model. The UNet's widths (12 and 24) give every GroupNorm group
two channels or more: a group of one would remove its conv's bias, whose
gradient is then rounding noise that Adam turns into steps of either sign.
"""

import json

import jax
import numpy as np
import pytest
import torch

import test_torch_replay as replay
import gwen_tpu.config as j_config
from gwen_tpu.cli import train_cnn as j_train_cnn
from gwen_tpu.cli import train_gnn as j_train_gnn
from gwen_tpu.nn import GCNStack as JGCNStack
from gwen_tpu.nn import unet as j_unet
from gwen_tpu.registry import Registry as JRegistry
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.data import zarrstore
from gwen_tpu_torch.dryrun import spawn_ranks
from gwen_tpu_torch.nn import params_from_jax
from gwen_tpu_torch.registry import Registry
from gwen_tpu_torch.train import make_mesh
from gwen_tpu_torch.train.mesh import ProcessMesh, shard_batch

TOL = dict(rtol=1e-4, atol=1e-4)
T, MEMBERS, SPLIT, H, C = 30, 6, 4, 4, 8
HIDDEN_GNN, HIDDEN_CNN, DEPTH, SEED = 16, 12, 2, 42
CASES = {"gnn-8": ("train-gnn", 8), "gnn-3": ("train-gnn", 3),
         "cnn-8": ("train-cnn", 8), "cnn-3": ("train-cnn", 3)}
EXPERIMENT = {"train-gnn": "GWEN", "train-cnn": "GWEN_CNN"}


def _stores(wd) -> str:
    """A raw (time, member, height, ncells) store and its preprocessed
    train and test stores (21 and 9 steps); returns the config's path."""
    tt = np.arange(T, dtype=np.float32)[:, None, None, None]
    mm = np.arange(MEMBERS, dtype=np.float32)[None, :, None, None]
    hh = np.arange(H, dtype=np.float32)[None, None, :, None]
    cc = np.arange(C, dtype=np.float32)[None, None, None, :]
    noise = np.random.default_rng(0).normal(size=(T, MEMBERS, H, C))
    raw = (280 + 5 * np.sin(0.3 * tt + 0.2 * mm) * np.cos(0.5 * hh + 0.1 * cc)
           + noise).astype(np.float32)
    arr = zarrstore.create(wd / "raw.zarr", raw.shape,
                           ("time", "member", "height", "ncells"),
                           chunks=(8, 1, H, C),
                           meta={"members": [f"{-m}.0_3000.0_2000.0"
                                             for m in range(MEMBERS)]})
    arr.write(..., raw)
    cfg = {"data": {"zarr_path": str(wd / "raw.zarr"),
                    "data_train": str(wd / "train.zarr"),
                    "data_test": str(wd / "test.zarr"),
                    "scaling_path": str(wd / "scaling.json"),
                    "boundary_cells": 0},
           "model": {"hidden_feats": HIDDEN_GNN},
           "unet": {"hidden": HIDDEN_CNN, "depth": DEPTH},
           "train": {"member_split": SPLIT, "epochs": 2, "lr": 1e-4,
                     "log_every": 1, "seed": SEED},
           "run": {"experiment": "GWEN"}}
    path = wd / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert cli(["preprocess", "--config", str(path)]) == 0
    return str(path)


def _initial_state(task: str) -> tuple:
    """The reference's initial parameters of the task's model, as the
    port's state dict, with the class they replace."""
    if task == "train-gnn":
        feats = H * C
        jm = JGCNStack(channels_in=feats, channels_out=feats,
                       hidden_feats=HIDDEN_GNN)
        where = ("gwen_tpu_torch.nn", "GCNStack")
    else:
        jm = j_unet.UNet(channels_in=SPLIT, channels_out=MEMBERS - SPLIT,
                         hidden=HIDDEN_CNN, depth=DEPTH)
        where = ("gwen_tpu_torch.nn.unet", "UNet")
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(SEED)))
    return (*where, params_from_jax(params))


def _argv(task: str, cfg: str, batch: int, root) -> list:
    return [task, "--config", cfg, "--no-animate", "--device", "cpu",
            f"train.batch_size={batch}", f"run.registry_root={root}"]


def _port_run(root, task: str) -> dict:
    runs = Registry(root).get_runs(EXPERIMENT[task])
    run = runs[0]
    return {"run_ids": [r.run_id for r in runs],
            "params": {k: v.numpy() for k, v in run.load_model()[0].items()},
            **{m: [r["value"] for r in run.metrics(m)]
               for m in ("train_loss", "loss", "test_loss")}}


def _reference_run(root, task: str) -> dict:
    run = JRegistry(root).get_runs(EXPERIMENT[task])[0]
    params = jax.tree_util.tree_map(np.asarray, run.load_model()[0])
    return {"params": {k: v.numpy() for k, v in params_from_jax(params).items()},
            **{m: [r["value"] for r in run.metrics(m)]
               for m in ("train_loss", "loss", "test_loss")}}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """Each case on two ranks, on one rank and in the reference."""
    wd = tmp_path_factory.mktemp("data_parallel")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(wd)  # the loggers' logfile.log
        cfg = _stores(wd)
        inits = {task: _initial_state(task) for task in EXPERIMENT}
        cases = {name: {"cli": _argv(task, cfg, batch, wd / name / "two"),
                        "init": inits[task]}
                 for name, (task, batch) in CASES.items()}
        torch.save(cases, wd / "cases.pt")
        spawn_ranks(replay.replay_rank, 2,
                    (str(wd / "store"), str(wd / "cases.pt"), str(wd)),
                    timeout_s=300)
        ranks = [torch.load(wd / f"rank_{k}.pt", weights_only=False)
                 for k in range(2)]
        out = {}
        for name, (task, batch) in CASES.items():
            one = replay.run_case({"cli": _argv(task, cfg, batch, wd / name / "one"),
                                   "init": inits[task]})
            main = j_train_gnn.main if task == "train-gnn" else j_train_cnn.main
            main(j_config.load_config(cfg).apply_overrides(
                [f"train.batch_size={batch}",
                 f"run.registry_root={wd / name / 'reference'}"]),
                 animate=False, out_dir=str(wd / "output"))
            out[name] = {"ranks": [r[name] for r in ranks], "one_rank": one,
                         "two": _port_run(wd / name / "two", task),
                         "one": _port_run(wd / name / "one", task),
                         "reference": _reference_run(wd / name / "reference", task)}
    return out


def _same_run(got: dict, want: dict) -> None:
    assert len(got["train_loss"]) == len(want["train_loss"]) > 0
    for metric in ("train_loss", "loss", "test_loss"):
        np.testing.assert_allclose(got[metric], want[metric], **TOL, err_msg=metric)
    assert sorted(got["params"]) == sorted(want["params"])
    for name, value in got["params"].items():
        np.testing.assert_allclose(value, want["params"][name], **TOL, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_speak_once_and_write_one_run(ran, name):
    """Rank 0 prints the JSON line and holds the logger's console and file
    handlers; rank 1 prints nothing and logs nowhere. Each step is one
    Adam step over the global batch: the step count of one rank."""
    task, batch = CASES[name]
    r0, r1 = ran[name]["ranks"]
    assert r0["rc"] == r1["rc"] == 0 and (r0["main"], r1["main"]) == (True, False)
    assert r1["json"] is None and r0["json"]["world"] == 2
    assert r0["handlers"] == ["StreamHandler", "FileHandler"]
    assert r1["handlers"] == ["NullHandler"]
    assert ran[name]["two"]["run_ids"] == [r0["json"]["run_id"]]
    steps = 2 * (21 // batch)
    assert len(ran[name]["two"]["train_loss"]) == steps
    one = ran[name]["one_rank"]["json"]
    assert one["world"] == 1
    np.testing.assert_allclose(r0["json"]["test_loss"], one["test_loss"], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_rank_at_the_global_batch(ran, name):
    _same_run(ran[name]["two"], ran[name]["one"])


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_reference_main(ran, name):
    _same_run(ran[name]["two"], ran[name]["reference"])


def test_shard_batch_cuts_divisible_leaves_and_keeps_the_rest_whole():
    x = np.arange(8 * 3).reshape(8, 3)
    mask = np.arange(4)
    for index in range(2):
        mesh = ProcessMesh(2, 1, index, 0)
        got = shard_batch(mesh, {"x": x, "mask": mask, "odd": x[:3]},
                          replicated=("mask",))
        np.testing.assert_array_equal(got["x"], x[4 * index:4 * index + 4])
        np.testing.assert_array_equal(got["mask"], mask)  # 4 divides 2: named
        np.testing.assert_array_equal(got["odd"], x[:3])  # 3 does not divide 2
        a, b = shard_batch(mesh, (torch.from_numpy(x), torch.ones(1, 2)))
        assert torch.equal(a, torch.from_numpy(x[4 * index:4 * index + 4]))
        assert torch.equal(b, torch.ones(1, 2))
    # One rank, or a plain number (a seed): nothing is cut.
    assert shard_batch(make_mesh(), (x, 7))[0] is x
    assert shard_batch(ProcessMesh(2, 1, 1, 0), 7) == 7
