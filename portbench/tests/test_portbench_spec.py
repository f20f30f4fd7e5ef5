"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell's
configuration, mix, driver, limits and metric readers are found by
name."""

import json
import re
from pathlib import Path

import pytest

from portbench.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPEC = Spec.load(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_metrics_keep_their_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        names = {m["name"] for m in SPEC.end_to_end(cell)}
        assert "setup_s" in names and len(names) >= 2 and SPEC.per_layer(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = SPEC.workload(cell)
    cfg = SPEC.config(w["config"])
    mix = SPEC.traffic(w["traffic"])
    assert cfg["name"] == w["config"] and callable(SPEC.driver(mix["driver"]))
    assert SPEC.limits(cell)
    for m in SPEC.end_to_end(cell) + SPEC.per_layer(cell):
        assert callable(SPEC.reader(m["name"]).read)


def test_configs_are_uncut():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"] == []
        assert cfg["graph"]["refine"] == 7 and cfg["model"]["latent_size"] == 256
        assert c["file"].startswith("portbench/")
