"""Step checkpoints: counterpart of ``gwen_tpu.train.checkpoint`` with
``torch.save`` in place of Orbax.

A checkpoint is one file, ``step_<N>.pt``, holding the model's parameters,
the optimizer's and schedule's state and the step. Files are written under
a private name and renamed, so a reader never sees a half-written one; the
oldest are deleted beyond ``max_to_keep``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: "str | Path", max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Save ``state`` (a :class:`~gwen_tpu_torch.train.TrainState`) as
        step ``step``; a step already saved is left as it is."""
        if step in self.steps():
            return
        path = self.directory / f"step_{step}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(step)}, tmp)
        os.replace(tmp, path)
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                (self.directory / f"step_{old}.pt").unlink(missing_ok=True)

    def restore(self, state, step: Optional[int] = None):
        """Load step ``step`` (default: the latest) into ``state``, in
        place, and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        blob = torch.load(self.directory / f"step_{step}.pt",
                          map_location="cpu", weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        return state
