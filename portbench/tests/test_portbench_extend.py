"""A later change adds a cell by adding files and entries only: in a
temporary copy of the benchmark, a new configuration, traffic mix,
limits file and per-layer metric are found by name and run, and no file
that was there changes."""

import hashlib
import json
import shutil
from pathlib import Path

import torch

from portbench.harness import ROOT, run_cell
from portbench.spec import Spec


def digest(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "portbench"
    before = digest(here)

    cfg = json.loads((here / "configs" / "epd_gcn_l7.json").read_text())
    cfg.update(name="epd_gcn_l3", reduced=["graph"])
    cfg["graph"]["refine"] = 3
    (here / "configs" / "epd_gcn_l3.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "train_b21.json").read_text())
    mix.update(batch=3, warmup_steps=3)
    (here / "traffic" / "train_b3.json").write_text(json.dumps(mix))
    (here / "limits" / "gcn_train_b3_l3.json").write_text(json.dumps(
        {"limits": {"loss_gap": 0.05, "grad_gap": 0.1, "change_gap": 0.1, "grad_diff_ratio": 4.0}}))
    (here / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return float(len(run.window.units))\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "epd_gcn_l3", "source": "test", "reduced": ["graph"],
                             "file": "portbench/configs/epd_gcn_l3.json", "why": "test"})
    bench["workloads"].append({"name": "gcn_train_b3_l3", "config": "epd_gcn_l3",
                               "traffic": "train_b3", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("gcn_train_b3_l3")
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "train_samples_per_s",
                               "workloads": ["gcn_train_b3_l3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec.load(tmp_path)
    assert spec.config("epd_gcn_l3")["graph"]["refine"] == 3
    assert "steps.train" in [m["name"] for m in spec.per_layer("gcn_train_b3_l3")]
    out, _ = run_cell("gcn_train_b3_l3", 5, 0.5, False, torch.device("cpu"), root=tmp_path)
    assert out["correct"] and out["metrics"]["train_samples_per_s"]["value"] > 0
    run = spec.reader("steps.train")
    assert callable(run.read)
    after = digest(here)
    assert {k: v for k, v in after.items() if k in before} == before
