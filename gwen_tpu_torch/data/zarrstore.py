"""Zarr ensemble archive on numpy and the standard library.

Counterpart of ``gwen_tpu.data.zarrstore`` with the same format on disk, so
either package opens the other's stores: zarr v2 (a ``.zarray`` JSON, one
file per chunk named ``i.j.k.l``, C order, every chunk stored at the full
chunk shape, ``zlib`` compression at level 1 by default, fill value 0),
resizable along a dimension for append-style ingestion. Dimension names and
scaling metadata live in a sidecar ``.gwen_meta.json`` next to the array.
The reference drives this format through tensorstore; here a chunk is
``zlib.decompress`` and ``np.frombuffer``, so reading and writing a store
needs nothing beyond numpy.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np

META_FILE = ".gwen_meta.json"
ARRAY_FILE = ".zarray"


def _zarr_dtype(dtype) -> str:
    return np.dtype(dtype).newbyteorder("<").str


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


@dataclass
class ZarrArray:
    """A chunked on-disk array with named dimensions."""

    path: Path
    dims: tuple[str, ...]
    meta: dict = field(default_factory=dict)
    zarray: dict = field(default_factory=dict)  # the parsed ``.zarray``

    # ------------------------------------------------------------ properties
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(int(n) for n in self.zarray["shape"])

    @property
    def chunks(self) -> tuple[int, ...]:
        return tuple(int(n) for n in self.zarray["chunks"])

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.zarray["dtype"])

    def axis(self, dim: str) -> int:
        return self.dims.index(dim)

    # ---------------------------------------------------------------- chunks
    def _chunk_path(self, cidx: tuple[int, ...]) -> Path:
        sep = self.zarray.get("dimension_separator", ".")
        return self.path / (sep.join(map(str, cidx)) if cidx else "0")

    def _read_chunk(self, cidx: tuple[int, ...]) -> np.ndarray:
        """One whole chunk (full chunk shape; the fill value where no file
        exists). The array is read-only when it comes straight from the
        file's bytes."""
        path = self._chunk_path(cidx)
        if not path.exists():
            return np.full(self.chunks, self.zarray.get("fill_value") or 0,
                           self.dtype)
        raw = path.read_bytes()
        if self.zarray.get("compressor") is not None:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, self.dtype).reshape(self.chunks)

    def _write_chunk(self, cidx: tuple[int, ...], values: np.ndarray) -> None:
        raw = np.ascontiguousarray(values, self.dtype).tobytes()
        comp = self.zarray.get("compressor")
        if comp is not None:
            raw = zlib.compress(raw, int(comp.get("level", 1)))
        _write_atomic(self._chunk_path(cidx), raw)

    def _region(self, idx) -> tuple[list[range], list[int]]:
        """``idx`` (ints, slices, one Ellipsis) as one ``range`` per axis and
        the axes an integer index drops."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        if any(i is Ellipsis for i in idx):
            at = next(k for k, i in enumerate(idx) if i is Ellipsis)
            fill = len(self.shape) - (len(idx) - 1)
            idx = idx[:at] + (slice(None),) * fill + idx[at + 1:]
        if len(idx) > len(self.shape):
            raise IndexError(f"too many indices for a {len(self.shape)}-d store")
        idx = idx + (slice(None),) * (len(self.shape) - len(idx))
        ranges, dropped = [], []
        for ax, (i, n) in enumerate(zip(idx, self.shape)):
            if isinstance(i, (int, np.integer)):
                i = int(i) + (n if i < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"index {i} out of range for axis {ax} "
                                     f"of length {n}")
                ranges.append(range(i, i + 1))
                dropped.append(ax)
            elif isinstance(i, slice):
                ranges.append(range(*i.indices(n)))
            else:
                raise TypeError(f"a store is indexed by ints and slices, not "
                                f"{type(i).__name__}")
        return ranges, dropped

    def _touched(self, lo: Sequence[int], hi: Sequence[int]):
        """Every chunk index overlapping the box ``[lo, hi)``, with the
        box's part of it as (chunk slices, box slices)."""
        per_axis = [range(a // c, -(-b // c)) for a, b, c in
                    zip(lo, hi, self.chunks)]
        for cidx in itertools.product(*per_axis):
            in_chunk, in_box = [], []
            for k, a, b, c in zip(cidx, lo, hi, self.chunks):
                start, stop = max(a, k * c), min(b, (k + 1) * c)
                in_chunk.append(slice(start - k * c, stop - k * c))
                in_box.append(slice(start - a, stop - a))
            yield cidx, tuple(in_chunk), tuple(in_box)

    # ------------------------------------------------------------------- io
    def __getitem__(self, idx) -> np.ndarray:
        ranges, dropped = self._region(idx)
        if any(len(r) == 0 for r in ranges):
            out = np.zeros([len(r) for r in ranges], self.dtype)
            return out.squeeze(tuple(dropped)) if dropped else out
        lo = [min(r[0], r[-1]) for r in ranges]
        hi = [max(r[0], r[-1]) + 1 for r in ranges]
        box = np.empty([b - a for a, b in zip(lo, hi)], self.dtype)
        for cidx, in_chunk, in_box in self._touched(lo, hi):
            box[in_box] = self._read_chunk(cidx)[in_chunk]
        # A step other than 1 picks from the box; a negative one walks it
        # from its far end, where the range began.
        out = box[tuple(slice(None, None, r.step) for r in ranges)]
        return out.squeeze(tuple(dropped)) if dropped else out

    def read(self) -> np.ndarray:
        return self[...]

    def write(self, idx, values: np.ndarray) -> None:
        ranges, dropped = self._region(idx)
        if any(r.step != 1 for r in ranges):
            raise ValueError("a store is written in unit-step regions")
        shape = [len(r) for r in ranges]
        values = np.asarray(values, dtype=self.dtype)
        if dropped and values.ndim == len(shape) - len(dropped):
            values = np.expand_dims(values, tuple(dropped))
        values = np.broadcast_to(values, shape)
        if 0 in shape:
            return
        lo = [r[0] for r in ranges]
        hi = [r[-1] + 1 for r in ranges]
        for cidx, in_chunk, in_box in self._touched(lo, hi):
            whole = all(s.start == 0 and s.stop == c
                        for s, c in zip(in_chunk, self.chunks))
            if whole:
                chunk = values[in_box]
            else:  # an edge or partly covered chunk: read, patch, write
                chunk = self._read_chunk(cidx).copy()
                chunk[in_chunk] = values[in_box]
            self._write_chunk(cidx, chunk)

    def append(self, values: np.ndarray, dim: str = "member") -> None:
        """Resize along ``dim`` and write ``values`` at the end."""
        ax = self.axis(dim)
        values = np.asarray(values, dtype=self.dtype)
        if values.ndim == len(self.dims) - 1:
            values = np.expand_dims(values, ax)
        old = self.shape[ax]
        new_shape = list(self.shape)
        new_shape[ax] = old + values.shape[ax]
        self.zarray["shape"] = new_shape
        self._save_zarray()
        idx = [slice(None)] * len(self.dims)
        idx[ax] = slice(old, new_shape[ax])
        self.write(tuple(idx), values)

    def _save_zarray(self) -> None:
        _write_atomic(self.path / ARRAY_FILE,
                      json.dumps(self.zarray, indent=2).encode())

    def save_meta(self) -> None:
        (self.path / META_FILE).write_text(
            json.dumps({"dims": list(self.dims), **self.meta}, indent=2)
        )


def create(
    path: str | Path,
    shape: Sequence[int],
    dims: Sequence[str],
    dtype=np.float32,
    chunks: Sequence[int] | None = None,
    compression_level: int = 1,
    meta: dict | None = None,
    delete_existing: bool = True,
) -> ZarrArray:
    """Create a zarr array (zlib-compressed, level 1 by default; level 0
    stores the chunks raw)."""
    path = Path(path)
    if chunks is None:
        chunks = list(shape)
    if delete_existing and path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)
    zarray = {
        "chunks": [max(1, int(c)) for c in chunks],
        "compressor": ({"id": "zlib", "level": int(compression_level)}
                       if compression_level > 0 else None),
        "dimension_separator": ".",
        "dtype": _zarr_dtype(dtype),
        "fill_value": 0,
        "filters": None,
        "order": "C",
        "shape": [int(n) for n in shape],
        "zarr_format": 2,
    }
    arr = ZarrArray(path=path, dims=tuple(dims), meta=dict(meta or {}),
                    zarray=zarray)
    arr._save_zarray()
    arr.save_meta()
    return arr


def open_array(path: str | Path) -> ZarrArray:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"zarr store not found: {path}")
    if not (path / ARRAY_FILE).exists():
        raise FileNotFoundError(f"{path} holds no {ARRAY_FILE}")
    zarray = json.loads((path / ARRAY_FILE).read_text())
    comp = zarray.get("compressor")
    if (zarray.get("zarr_format") != 2 or zarray.get("order", "C") != "C"
            or zarray.get("filters")
            or (comp is not None and comp.get("id") != "zlib")):
        raise ValueError(
            f"{path}: only zarr v2, C order, no filters and zlib (or no) "
            f"compression are read; got format {zarray.get('zarr_format')}, "
            f"order {zarray.get('order')}, filters {zarray.get('filters')}, "
            f"compressor {comp}")
    meta_path = path / META_FILE
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    dims = tuple(meta.pop("dims", [f"dim_{i}"
                                   for i in range(len(zarray["shape"]))]))
    return ZarrArray(path=path, dims=dims, meta=meta, zarray=zarray)


def exists(path: str | Path) -> bool:
    return (Path(path) / ARRAY_FILE).exists()
