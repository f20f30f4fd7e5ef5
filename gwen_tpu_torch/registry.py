"""Filesystem experiment registry: counterpart of ``gwen_tpu.registry``
with the same on-disk layout::

    <root>/<experiment>/<run_id>/
        meta.json        # config snapshot, status, timestamps, best metric
        metrics.jsonl    # one JSON object per logged metric
        artifacts/       # params.pt (the model's state dict), model.json,
                         # environment.json

The reference stores params as flax msgpack; the port stores the model's
state dict with ``torch.save`` (the same names and layouts), which
:func:`gwen_tpu_torch.serve.export_model` turns into a serving artifact.
"""

from __future__ import annotations

import json
import os
import platform
import socket
import sys
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import torch

from gwen_tpu_torch.logging_utils import get_logger

log = get_logger()


def _environment_snapshot() -> dict:
    """Versions of the stack that produced a model artifact."""
    import numpy as np

    from gwen_tpu_torch import __version__

    return {
        "gwen_tpu_torch": __version__,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "packages": {"torch": torch.__version__, "numpy": np.__version__,
                     "cuda": torch.version.cuda},
    }


def default_experiment(base: str = "GWEN") -> str:
    """Experiment name, suffixed with ``GWEN_SITE`` when that is set (or
    ``balfrin`` on hosts named ``nid*``), as the reference names them."""
    site = os.environ.get("GWEN_SITE")
    if site:
        return f"{base}_{site}"
    if socket.gethostname().startswith("nid"):
        return f"{base}_balfrin"
    return base


@dataclass
class Run:
    path: Path

    @property
    def run_id(self) -> str:
        return self.path.name

    @property
    def meta(self) -> dict:
        p = self.path / "meta.json"
        return json.loads(p.read_text()) if p.exists() else {}

    def _update_meta(self, **kv: Any) -> None:
        meta = self.meta
        meta.update(kv)
        (self.path / "meta.json").write_text(json.dumps(meta, indent=2, default=str))

    def log_metric(self, name: str, value: float, step: int = 0) -> None:
        with (self.path / "metrics.jsonl").open("a") as f:
            f.write(json.dumps({"name": name, "value": float(value),
                                "step": int(step), "ts": time.time()}) + "\n")

    def metrics(self, name: Optional[str] = None) -> list[dict]:
        p = self.path / "metrics.jsonl"
        if not p.exists():
            return []
        rows = [json.loads(line) for line in p.read_text().splitlines() if line]
        return [r for r in rows if name is None or r["name"] == name]

    def save_model(self, params: dict, model_config: dict,
                   best_metric: Optional[float] = None) -> None:
        """Store ``params`` (a state dict) and the hyperparameters that
        rebuild the model."""
        art = self.path / "artifacts"
        art.mkdir(exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in params.items()},
                   art / "params.pt")
        (art / "model.json").write_text(json.dumps(model_config, indent=2, default=str))
        (art / "environment.json").write_text(
            json.dumps(_environment_snapshot(), indent=2))
        if best_metric is not None:
            self._update_meta(best_metric=float(best_metric))

    def load_model(self) -> tuple[dict, dict]:
        """``(params state dict on the CPU, model_config)``."""
        art = self.path / "artifacts"
        params = torch.load(art / "params.pt", map_location="cpu",
                            weights_only=True)
        return params, json.loads((art / "model.json").read_text())

    def has_artifacts(self) -> bool:
        art = self.path / "artifacts"
        return art.exists() and any(art.iterdir())

    def finish(self, status: str = "FINISHED") -> None:
        self._update_meta(status=status, end_time=time.time())


class Registry:
    def __init__(self, root: "str | Path" = "runs"):
        self.root = Path(root)

    def create_run(self, experiment: str, config: Optional[dict] = None,
                   run_name: str = "") -> Run:
        run_id = time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6]
        if run_name:
            run_id = f"{run_id}-{run_name}"
        path = self.root / experiment / run_id
        path.mkdir(parents=True, exist_ok=False)
        (path / "meta.json").write_text(json.dumps({
            "experiment": experiment, "run_id": run_id, "status": "RUNNING",
            "start_time": time.time(), "config": config or {},
        }, indent=2, default=str))
        return Run(path)

    def get_runs(self, experiment: str, with_artifacts_only: bool = True) -> list[Run]:
        """Runs newest-first."""
        exp = self.root / experiment
        if not exp.exists():
            return []
        runs = [Run(p) for p in exp.iterdir() if p.is_dir()]
        if with_artifacts_only:
            runs = [r for r in runs if r.has_artifacts()]
        return sorted(runs, key=lambda r: r.meta.get("start_time", 0), reverse=True)

    def load_best_model(self, experiment: str, strategy: str = "best"):
        """Params and config of the run with the lowest ``best_metric``
        (``strategy="best"``) or of the newest run (``"latest"``)."""
        runs = self.get_runs(experiment)
        if not runs:
            raise FileNotFoundError(f"no runs with artifacts in experiment {experiment!r}")
        if strategy == "latest":
            chosen = runs[0]
        else:
            scored = [r for r in runs if "best_metric" in r.meta]
            chosen = min(scored, key=lambda r: r.meta["best_metric"]) if scored else runs[0]
        log.info("loading model from run %s", chosen.run_id)
        return chosen.load_model()
