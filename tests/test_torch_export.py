"""``export``, ``runs`` and the registry's template load of the port
against the reference package on the CPU.

A registry run is written in each package's format (msgpack there, a
state dict here) with the same converted parameters and hyperparameters;
then the reference's ``export`` → ``predict`` and the port's ``export`` →
``predict --device cpu`` serve it, and the two trajectories, in original
node order, are compared in float32 at ``rtol = atol = 1e-4``. The
reference on the CPU serves the GCN on the COO graph in RCM order and the
attention model on the diag-window layout in KD order; the port serves
both on the diag-window layout in KD order through its kernels' plain
versions. ``_resolve_hparams`` is held to the reference's function on
the same stored values and overrides, ``runs`` to the reference's
subcommand on the same registry root.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gwen_tpu.cli import export_cli as j_export
from gwen_tpu.cli.main import main as j_cli
from gwen_tpu.config import GwenConfig as JConfig
from gwen_tpu.nn import EncodeProcessDecode as JEPD
from gwen_tpu.registry import Registry as JRegistry
from gwen_tpu_torch.cli import export_cli
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.nn import params_from_jax
from gwen_tpu_torch.registry import Registry
from gwen_tpu_torch.serve import ServingModel

TOL = dict(rtol=1e-4, atol=1e-4)
CH, LATENT, STEPS = 2, 16, 2


def _meta(processor, levels, nodes, data=""):
    return {"latent_size": LATENT, "process_steps": STEPS, "channels": CH,
            "levels": levels, "processor": processor, "attn_heads": 2,
            "attn_pack": "auto", "residual": True, "mlp_layers": 2,
            "diag_window": 128, "compute_dtype": "float32", "nodes": nodes,
            "data": data}


def _registries(tmp_path, meta, seed=0):
    """The same run in both packages' registries: ``(ref root, port
    root)``."""
    jm = JEPD(channels_in=CH, channels_out=CH, latent_size=LATENT,
              process_steps=STEPS, processor=meta["processor"], attn_heads=2)
    params = jm.init(jax.random.key(seed))
    roots = tmp_path / "jruns", tmp_path / "pruns"
    run = JRegistry(roots[0]).create_run("GWEN_MESH", {})
    run.save_model(params, meta, best_metric=0.5)
    run.finish()
    run = Registry(roots[1]).create_run("GWEN_MESH", {})
    run.save_model(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                   meta, best_metric=0.5)
    run.finish()
    return roots


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("processor,levels,store", [
    ("gcn", 2, False), ("gcn", 3, False), ("attention", 2, False),
    ("interaction", 2, False), ("gcn", 2, True)],
    ids=["gcn-L2", "gcn-L3", "attention-L2", "interaction-L2", "gcn-L2-data"])
def test_export_predict_matches_reference(tmp_path, capsys, processor, levels,
                                          store):
    n = 10 * 4 ** levels + 2
    data = ""
    if store:
        data = str(tmp_path / "mesh.zarr")
        assert cli(["make-mesh-data", "--out", data, "--members", "2",
                    "--steps", "3", f"graph.refine={levels}"]) == 0
    jroot, proot = _registries(tmp_path, _meta(processor, levels, n, data))
    extra = ["--data", data] if store else []
    assert j_cli(["export", "--out", str(tmp_path / "jart"), *extra,
                  f"run.registry_root={jroot}"]) == 0
    j_out = _last_json(capsys)
    assert cli(["export", "--out", str(tmp_path / "part"), "--device", "cpu",
                *extra, f"run.registry_root={proot}"]) == 0
    out = _last_json(capsys)
    assert out == {**j_out, "artifact": str(tmp_path / "part"),
                   "platform": "cpu"}
    assert (out["nodes"], out["channels"]) == (n, CH)

    x0 = np.random.default_rng(levels).normal(size=(n, CH)).astype(np.float32)
    np.save(tmp_path / "x0.npy", x0)
    assert j_cli(["predict", "--artifact", str(tmp_path / "jart"), "--input",
                  str(tmp_path / "x0.npy"), "--steps", "3", "--out",
                  str(tmp_path / "j.npy")]) == 0
    assert cli(["predict", "--artifact", str(tmp_path / "part"), "--input",
                str(tmp_path / "x0.npy"), "--steps", "3", "--out",
                str(tmp_path / "p.npy"), "--device", "cpu"]) == 0
    got, want = np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape == (3, n, CH)
    np.testing.assert_allclose(got, want, **TOL)

    # The artifact records the rollout length; its permutation is the one
    # the served graph takes.
    sm = ServingModel.load(tmp_path / "part", "cpu")
    meta = json.loads((tmp_path / "part" / "meta.json").read_text())
    assert meta["rollout_steps"] == sm.rollout_steps == 4
    assert meta["metadata"]["node_order"] == (
        "rcm" if processor == "interaction" else "kd")
    np.testing.assert_array_equal(np.load(tmp_path / "part" / "node_perm.npy"),
                                  sm.node_perm)
    assert type(sm.graph).__name__ == (
        "Graph" if processor == "interaction" else "DiagWindowGraph")


def test_export_refuses_conflicts_and_needs_cuda(tmp_path, capsys, monkeypatch):
    _, proot = _registries(tmp_path, _meta("gcn", 2, 162))
    art = str(tmp_path / "art")
    assert cli(["export", "--out", art, "--device", "cpu", "--rollout-steps",
                "0", f"run.registry_root={proot}"]) == 0
    assert ServingModel.load(art, "cpu").rollout_steps == 0
    with pytest.raises(ValueError, match="attn_heads"):
        cli(["export", "--out", art, "--device", "cpu", "model.attn_heads=4",
             f"run.registry_root={proot}"])
    with pytest.raises(ValueError, match="rebuilt mesh has 642 nodes"):
        run = Registry(proot).get_runs("GWEN_MESH")[0]
        (run.path / "artifacts" / "model.json").write_text(
            json.dumps(_meta("gcn", 3, 162)))
        cli(["export", "--out", art, "--device", "cpu",
             f"run.registry_root={proot}"])
    with pytest.raises(FileNotFoundError, match="OTHER"):
        cli(["export", "--out", art, "--device", "cpu", "--experiment", "OTHER",
             f"run.registry_root={proot}"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["export", "--out", art, f"run.registry_root={proot}"])


@pytest.mark.parametrize("stored,overrides,raises", [
    ({}, [], False),
    ({}, ["model.processor=attention", "mesh.diag_window=128"], False),
    ({"processor": "attention", "attn_heads": 4}, [], False),
    ({"processor": "attention"}, ["model.processor=attention"], False),
    ({"processor": "attention"}, ["model.processor=gcn"], False),
    ({"attn_heads": 4}, ["model.attn_heads=8"], True),
    ({"residual": False}, ["model.residual=false"], False),
    ({"mlp_layers": 3}, ["model.mlp_layers=4"], True),
    ({"compute_dtype": "float32"}, ["model.compute_dtype=bfloat16"], False),
    ({"compute_dtype": "float32"}, ["model.compute_dtype=float16"], True),
    ({"diag_window": 128}, ["mesh.diag_window=256"], True),
], ids=["none", "cli-only", "stored-only", "agree", "default-loses",
        "heads", "residual-agrees", "mlp", "dtype-default", "dtype", "window"])
def test_resolve_hparams_matches_reference(stored, overrides, raises):
    meta = {"levels": 2, **stored}

    def outcome(fn, cfg):
        try:
            return fn(meta, cfg.apply_overrides(overrides))
        except ValueError as e:
            return ("ValueError", str(e))

    got = outcome(export_cli._resolve_hparams, GwenConfig())
    want = outcome(j_export._resolve_hparams, JConfig())
    assert got == want and isinstance(got, tuple) == raises


def test_load_model_holds_the_template(tmp_path):
    run = Registry(tmp_path).create_run("E", {})
    params = {"a.w": torch.ones(2, 3), "b": torch.zeros(4)}
    run.save_model(params, {"k": 1}, best_metric=1.0)
    got, md = run.load_model({"b": torch.empty(4), "a.w": torch.empty(2, 3)})
    assert list(got) == ["b", "a.w"] and md == {"k": 1}
    assert torch.equal(got["a.w"], params["a.w"])
    got, _ = Registry(tmp_path).load_best_model(
        "E", params_template={"a.w": torch.empty(2, 3), "b": torch.empty(4)})
    assert list(got) == ["a.w", "b"]
    for template, match in (({"a.w": torch.empty(2, 3)}, "'b'.*template lacks"),
                            ({**params, "c": torch.empty(1)}, "lack 'c'"),
                            ({"a.w": torch.empty(3, 2), "b": torch.empty(4)},
                             r"'a.w' is stored with shape \(2, 3\)")):
        with pytest.raises(ValueError, match=match):
            run.load_model(template)
    env = run.environment()
    assert env["packages"]["torch"] == torch.__version__ and "python" in env
    assert Registry(tmp_path).create_run("F").environment() == {}


def test_runs_prints_the_reference_rows(tmp_path, capsys):
    reg = Registry(tmp_path / "runs")
    for exp, best in (("GWEN_MESH", 0.25), ("GWEN_MESH", None), ("GWEN_CNN", 1.5)):
        run = reg.create_run(exp, {"x": 1})
        if best is not None:
            run.save_model({"w": torch.ones(1)}, {}, best_metric=best)
            run.finish()
    (tmp_path / "runs" / "checkpoints" / "r0").mkdir(parents=True)
    for argv in (["--root", str(tmp_path / "runs")],
                 ["--root", str(tmp_path / "runs"), "--experiment", "GWEN_MESH"],
                 ["--root", str(tmp_path / "none")]):
        assert j_cli(["runs", *argv]) == 0
        want = capsys.readouterr().out
        assert cli(["runs", *argv]) == 0
        got = capsys.readouterr().out
        assert got == want
    assert cli(["runs", "--root", str(tmp_path / "runs")]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["experiment"] for r in rows] == ["GWEN_CNN", "GWEN_MESH", "GWEN_MESH"]
    assert sorted((r["status"], r["best_metric"]) for r in rows[1:]) == [
        ("FINISHED", 0.25), ("RUNNING", None)]
