"""``BENCHMARK.json`` and the files it names, each found by name:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<mix>.json``, ``drivers/<kind>.py`` (the mix's ``driver``),
``limits/<workload>.json`` and ``metrics/<metric>.py``. A cell, a mix, a
configuration or a metric is added by adding files and entries."""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Spec:
    def __init__(self, bench: dict, root: Path, here: Path):
        self.bench, self.root, self.here = bench, root, here

    @classmethod
    def load(cls, root: Path) -> "Spec":
        """``root/BENCHMARK.json``, its files under ``root/portbench``."""
        return cls(json.loads((root / "BENCHMARK.json").read_text()), root,
                   root / HERE.name)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str, overrides: dict | None = None) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return _merge(json.loads((self.root / entry["file"]).read_text()), overrides or {})

    def traffic(self, name: str, overrides: dict | None = None) -> dict:
        return _merge(json.loads((self.here / "traffic" / f"{name}.json").read_text()),
                      overrides or {})

    def limits(self, workload: str) -> dict[str, float]:
        return json.loads((self.here / "limits" / f"{workload}.json").read_text())["limits"]

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def driver(self, kind: str):
        """The ``Driver`` class of ``drivers/<kind>.py``."""
        return _load(self.here / "drivers" / f"{kind}.py", "driver").Driver

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``; its ``read(run)`` gives the
        metric's value, or ``None`` where it finds nothing to read."""
        return _load(self.here / "metrics" / f"{metric}.py", "metric")


def _load(path: Path, kind: str):
    key = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
