"""Lazy, time-chunked views over zarr stores: streaming epoch iterators.

Counterpart of ``gwen_tpu.data.lazy``. :class:`LazyField` reads a store one
time step at a time, so host memory scales with the per-step slab (plus a
small LRU of recent steps), not the archive.

A ``LazyField`` looks enough like the ``(time, ...)`` numpy array the
datasets consume:

* ``.shape`` / ``len()`` — static, no data read;
* ``field[t]`` — one time step (LRU-cached; sequential epochs re-read each
  chunk once);
* ``field[t, sel]`` — step then numpy indexing;
* ``field[(t_array, m_array)]`` — paired gather (mesh batches);
* ``field[t0:t1, m]`` — trajectory slices.

Construction applies the same normalization as the eager loader: dims
transposed to a wanted order, optional block-mean coarsening, optional
``map_fn`` (e.g. partition padding) — all per step.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np

from gwen_tpu_torch.data.zarrstore import ZarrArray


class LazyField:
    """Lazy ``(time, ...)`` view of a :class:`ZarrArray`."""

    def __init__(
        self,
        arr: ZarrArray,
        want_dims: Optional[Sequence[str]] = None,
        coarsen: int = 1,
        coarsen_axes: tuple[int, ...] = (2, 3),
        map_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        cache_steps: int = 4,
        dtype=np.float32,
    ) -> None:
        self._arr = arr
        dims = list(arr.dims)
        if want_dims is not None and set(want_dims) <= set(dims):
            self._order = [dims.index(d) for d in want_dims]
        else:
            self._order = list(range(len(dims)))
        self._time_axis = self._order[0]
        self._coarsen = coarsen
        self._coarsen_axes = coarsen_axes
        self._map_fn = map_fn
        self._dtype = dtype
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_steps = max(cache_steps, 1)
        self._step_shape: Optional[tuple[int, ...]] = None

    # ------------------------------------------------------------ shape
    def __len__(self) -> int:
        return int(self._arr.shape[self._time_axis])

    @property
    def shape(self) -> tuple[int, ...]:
        if self._step_shape is None:
            self._step_shape = self._read_step(0).shape
        return (len(self),) + self._step_shape

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # ------------------------------------------------------------- reads
    def _read_step(self, t: int) -> np.ndarray:
        idx = [slice(None)] * len(self._arr.dims)
        idx[self._time_axis] = int(t)
        raw = self._arr[tuple(idx)].astype(self._dtype)
        # Transpose the remaining (non-time) axes into wanted order.
        rest = [a if a < self._time_axis else a - 1
                for a in self._order[1:]]
        step = np.transpose(raw, rest)
        if self._coarsen > 1:
            from gwen_tpu_torch.data.preprocess import coarsen_block_mean

            axes = tuple(a - 1 for a in self._coarsen_axes)  # time axis gone
            step = coarsen_block_mean(step[None], self._coarsen,
                                      axes=tuple(a + 1 for a in axes))[0]
        if self._map_fn is not None:
            step = self._map_fn(step)
        return step

    def step(self, t: int) -> np.ndarray:
        t = int(t)
        if t < 0:
            t += len(self)
        hit = self._cache.pop(t, None)
        if hit is not None:
            self._cache[t] = hit  # refresh LRU position
            return hit
        val = self._read_step(t)
        self._cache[t] = val
        while len(self._cache) > self._cache_steps:
            self._cache.popitem(last=False)
        return val

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self.step(idx)
        if isinstance(idx, slice):
            return np.stack([self.step(t) for t in range(*idx.indices(len(self)))])
        if isinstance(idx, tuple):
            t_sel, *rest = idx
            if isinstance(t_sel, (int, np.integer)):
                out = self.step(t_sel)
                return out[tuple(rest)] if rest else out
            if isinstance(t_sel, slice):
                ts = range(*t_sel.indices(len(self)))
                return np.stack(
                    [self.step(t)[tuple(rest)] if rest else self.step(t)
                     for t in ts]
                )
            t_sel = np.asarray(t_sel)
            if rest and isinstance(rest[0], np.ndarray) and rest[0].shape == t_sel.shape:
                # Paired gather: field[t_array, m_array].
                m_sel, tail = rest[0], tuple(rest[1:])
                return np.stack(
                    [self.step(t)[(m,) + tail] if tail else self.step(t)[m]
                     for t, m in zip(t_sel, m_sel)]
                )
            return np.stack(
                [self.step(t)[tuple(rest)] if rest else self.step(t)
                 for t in t_sel]
            )
        idx = np.asarray(idx)
        return np.stack([self.step(t) for t in idx])

    def map(self, fn: Callable[[np.ndarray], np.ndarray]) -> "LazyField":
        """New lazy view with ``fn`` composed onto each step read (e.g. node
        reordering, partition padding, member selection)."""
        prev = self._map_fn
        new = LazyField(
            self._arr,
            coarsen=self._coarsen,
            coarsen_axes=self._coarsen_axes,
            map_fn=(fn if prev is None else (lambda a: fn(prev(a)))),
            cache_steps=self._cache_steps,
            dtype=self._dtype,
        )
        new._order = self._order
        new._time_axis = self._time_axis
        return new

    def materialize(self) -> np.ndarray:
        """Full eager read (escape hatch; defeats streaming)."""
        return np.stack([self._read_step(t) for t in range(len(self))])
