"""Mesh-scale next-step dataset: counterpart of
``gwen_tpu.data.dataset.MeshEnsembleDataset``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshEnsembleDataset:
    """Fields ``(time, member, nodes, channels)`` → batches of
    ``(x_t, x_{t+1})`` drawn across time × member, in the reference's
    order, with the last partial batch dropped."""

    fields: np.ndarray  # (time, member, nodes, channels)

    def __post_init__(self) -> None:
        t, m, _, _ = self.fields.shape
        self._pairs = np.asarray([(ti, mi) for mi in range(m)
                                  for ti in range(t - 1)])

    def __len__(self) -> int:
        return len(self._pairs)

    @property
    def num_nodes(self) -> int:
        return self.fields.shape[2]

    @property
    def num_channels(self) -> int:
        return self.fields.shape[3]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        order = np.arange(len(self._pairs))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = self._pairs[order[start : start + batch_size]]
            yield (self.fields[idx[:, 0], idx[:, 1]],
                   self.fields[idx[:, 0] + 1, idx[:, 1]])
