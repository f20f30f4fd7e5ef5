"""Runtime datasets: counterpart of ``gwen_tpu.data.dataset``.

* :func:`load_split` / :func:`load_data`: the train and test stores as
  ``(time, member, height, ncells)`` float32, eager or as a
  :class:`~gwen_tpu_torch.data.lazy.LazyField`, optionally coarsened.
* :class:`MemberGraphDataset`: nodes are ensemble members, node features
  the flattened ``height × ncells`` field; the member indices are shuffled
  once, the first ``member_split`` are inputs and the rest targets, marked
  by a boolean ``target_mask``. All member features go to the model and the
  mask applies in the loss; ``mask_inputs=True`` also zeroes the target
  members' features in the input.
* :class:`ConvEnsembleDataset`: the CNN view, per time step the input
  members as channels and the target members as outputs, with the same
  member split (a ``simplify`` mode takes one input and one target).
* :class:`MeshEnsembleDataset`: mesh-scale next-step pairs and trajectories.

Everything yields numpy arrays of one shape per dataset.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gwen_tpu_torch.config import DataConfig, TrainConfig
from gwen_tpu_torch.data import zarrstore
from gwen_tpu_torch.data.preprocess import coarsen_block_mean


def load_split(config: DataConfig, which: str = "train"):
    """Load the train or test store as (time, member, height, ncells) float32.

    With ``config.lazy`` the returned value is a
    :class:`~gwen_tpu_torch.data.lazy.LazyField`: time steps stream from the
    store on access, so host memory scales with the per-step slab, not the
    archive. The datasets below consume either form.
    """
    path = config.data_train if which == "train" else config.data_test
    arr = zarrstore.open_array(path)
    want = ["time", "member", "height", "ncells"]
    if config.lazy:
        from gwen_tpu_torch.data.lazy import LazyField

        return LazyField(arr, want_dims=want, coarsen=config.coarsen), arr.meta
    values = arr.read().astype(np.float32)
    dims = list(arr.dims)
    if set(want) <= set(dims):
        values = np.transpose(values, [dims.index(d) for d in want])
    if config.coarsen > 1:
        values = coarsen_block_mean(values, config.coarsen, axes=(2, 3))
    return values, arr.meta


def load_data(config: DataConfig):
    """``(train, test, meta)``: both splits, coarsened as configured."""
    train, meta = load_split(config, "train")
    test, _ = load_split(config, "test")
    return train, test, meta


def split_members(members: int, member_split: int, seed: int,
                  simplify: bool) -> tuple[np.ndarray, np.ndarray]:
    """``(input_indices, target_indices)``: the members shuffled once by
    ``seed``, the first ``member_split`` (sorted) inputs and the rest
    targets; ``simplify`` takes one input and one target."""
    perm = np.random.default_rng(seed).permutation(members)
    if simplify:
        return perm[:1], perm[1:2]
    return np.sort(perm[:member_split]), np.sort(perm[member_split:])


@dataclass
class MemberGraphDataset:
    """Ensemble-member graph view: one sample per time step.

    ``features(t)`` returns ``(members, height*ncells)`` node features;
    ``target_mask`` is fixed per dataset instance (the member
    indices are shuffled once at construction).
    """

    data: np.ndarray  # (time, member, height, ncells)
    member_split: int
    seed: int = 42
    simplify: bool = False
    mask_inputs: bool = False

    def __post_init__(self) -> None:
        m = self.data.shape[1]
        self.input_indices, self.target_indices = split_members(
            m, self.member_split, self.seed, self.simplify)
        mask = np.zeros(m, bool)
        mask[self.target_indices] = True
        self.target_mask = mask

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.data.shape[1]

    @property
    def num_features(self) -> int:
        return self.data.shape[2] * self.data.shape[3]

    def features(self, t: int) -> np.ndarray:
        x = self.data[t].reshape(self.num_nodes, self.num_features)
        if self.mask_inputs:
            x = x.copy()
            x[self.target_mask] = 0.0
        return x

    def raw_features(self, t: int) -> np.ndarray:
        """Unmasked node features — the loss target when mask_inputs=True."""
        return self.data[t].reshape(self.num_nodes, self.num_features)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        node_batch_size: int = 0,
    ):
        """Yield (x, target_mask) batches over time steps, each
        ``(batch, members, features)``; the last partial batch is dropped so
        every batch has the same shape.

        ``node_batch_size > 0`` reproduces neighbour-sampled mini-batches of
        member nodes (21 in the original GWEN config): on the
        fully-connected member graph a 2-hop neighborhood of any seed set is
        the whole graph, so it reduces to a full forward with the loss
        restricted to a random node subset — the yielded mask is
        ``target_mask ∧ sampled-nodes``.
        """
        t = len(self)
        order = np.arange(t)
        rng = np.random.default_rng(seed)
        if shuffle:
            rng.shuffle(order)
        for start in range(0, t - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            x = np.stack([self.features(i) for i in idx])
            mask = self.target_mask
            if node_batch_size and node_batch_size < self.num_nodes:
                sampled = np.zeros(self.num_nodes, bool)
                sampled[rng.choice(self.num_nodes, node_batch_size, replace=False)] = True
                if not (mask & sampled).any():  # keep at least one target node
                    sampled[rng.choice(np.nonzero(mask)[0])] = True
                mask = mask & sampled
            if self.mask_inputs:
                # Loss must see the UNMASKED ground truth at target nodes.
                target = np.stack([self.raw_features(i) for i in idx])
                yield x, mask, target
            else:
                yield x, mask


@dataclass
class ConvEnsembleDataset:
    """CNN view: per time step, input members as channels → target
    members. ``x`` is ``(batch, members_in, height, ncells)`` and ``y``
    ``(batch, members_out, height, ncells)``; the member split is
    :class:`MemberGraphDataset`'s for the same seed."""

    data: np.ndarray  # (time, member, height, ncells)
    member_split: int
    seed: int = 42
    simplify: bool = False

    def __post_init__(self) -> None:
        self.input_indices, self.target_indices = split_members(
            self.data.shape[1], self.member_split, self.seed, self.simplify)

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        return self.data[t, self.input_indices], self.data[t, self.target_indices]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        """Yield ``(x, y)`` batches over time steps (shuffled by ``seed``
        when asked); the last partial batch is dropped."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            yield (np.stack([self.data[i, self.input_indices] for i in idx]),
                   np.stack([self.data[i, self.target_indices] for i in idx]))


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

    def trajectory_batches(self, batch_size: int, horizon: int,
                           shuffle: bool = False, seed: int = 0):
        """``(x0, traj)`` batches for rollout-horizon training: ``traj`` is
        ``(batch, horizon, nodes, channels)``, the next ``horizon`` states,
        in the reference's order."""
        t, m = self.fields.shape[:2]
        starts = np.asarray([(ti, mi) for mi in range(m)
                             for ti in range(t - horizon)])
        order = np.arange(len(starts))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s0 in range(0, len(order) - batch_size + 1, batch_size):
            idx = starts[order[s0: s0 + batch_size]]
            yield (self.fields[idx[:, 0], idx[:, 1]],
                   np.stack([self.fields[ti + 1: ti + 1 + horizon, mi]
                             for ti, mi in idx]))


def make_datasets(
    data_cfg: DataConfig, train_cfg: TrainConfig, kind: str = "graph"
) -> tuple:
    """Convenience: load both splits and wrap them in the member-graph view
    (``kind="graph"``) or the CNN view (``kind="conv"``)."""
    train, test, meta = load_data(data_cfg)
    cls = MemberGraphDataset if kind == "graph" else ConvEnsembleDataset
    mk = lambda d: cls(  # noqa: E731
        data=d,
        member_split=train_cfg.member_split,
        seed=train_cfg.seed,
        simplify=train_cfg.simplify,
    )
    return mk(train), mk(test), meta
