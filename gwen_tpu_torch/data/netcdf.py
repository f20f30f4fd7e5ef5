"""ICON NetCDF reading via h5py (NetCDF4 files are HDF5).

A copy of ``gwen_tpu.data.netcdf``: NetCDF4 stores one HDF5 dataset per
variable with *dimension scales* attached, and the dimension names are
recovered from those scales. Also a writer, used to generate synthetic
ICON-like ensemble fixtures for tests. ``h5py`` is imported inside the
functions that need it, so the package imports where it is absent; a call
then raises ``RuntimeError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

@dataclass
class VariableData:
    name: str
    values: np.ndarray
    dims: tuple[str, ...]
    attrs: dict


def _require_h5py():
    try:
        import h5py
    except ImportError as err:
        raise RuntimeError(
            "h5py is required for NetCDF I/O but is not installed") from err
    return h5py


def _dim_names(ds) -> tuple[str, ...]:
    names = []
    for i, dim in enumerate(ds.dims):
        label = dim.label
        if not label and len(dim) > 0:
            # Fall back to the attached scale's name.
            label = Path(dim[0].name).name
        names.append(label or f"dim_{i}")
    return tuple(names)


def list_variables(path: str | Path) -> list[str]:
    """Non-coordinate variable names in a NetCDF file."""
    h5py = _require_h5py()
    out = []
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            if isinstance(ds, h5py.Dataset) and "CLASS" not in ds.attrs:
                out.append(name)
    return out


def read_variable(path: str | Path, name: str) -> VariableData:
    """Read one variable with its dimension names and attributes."""
    h5py = _require_h5py()
    with h5py.File(path, "r") as f:
        if name not in f:
            raise KeyError(f"{name!r} not found in {path}")
        ds = f[name]
        attrs = {
            k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in ds.attrs.items()
            if not k.startswith(("DIMENSION", "_Netcdf4", "CLASS", "NAME", "REFERENCE_LIST"))
        }
        return VariableData(
            name=name, values=ds[...], dims=_dim_names(ds), attrs=attrs
        )


def read_coordinate(path: str | Path, name: str) -> np.ndarray | None:
    h5py = _require_h5py()
    with h5py.File(path, "r") as f:
        if name in f and isinstance(f[name], h5py.Dataset):
            return f[name][...]
    return None


def write_netcdf_like(
    path: str | Path,
    variables: Mapping[str, tuple[Sequence[str], np.ndarray]],
    coords: Mapping[str, np.ndarray] | None = None,
) -> None:
    """Write an HDF5 file with netCDF4-style dimension scales.

    ``variables`` maps name -> (dims, values). Used for synthetic test
    fixtures shaped like the reference's ICON output
    (tests/test_data/atmcirc-straka_*.nc: dims time, member, height, ncells).
    """
    h5py = _require_h5py()
    coords = dict(coords or {})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        # Collect dimension sizes.
        dim_sizes: dict[str, int] = {}
        for _, (dims, values) in variables.items():
            for d, size in zip(dims, np.asarray(values).shape):
                dim_sizes.setdefault(d, size)
        # Create dimension-scale datasets.
        for d, size in dim_sizes.items():
            data = coords.get(d, np.arange(size))
            scale = f.create_dataset(d, data=data)
            scale.make_scale(d)
        for name, (dims, values) in variables.items():
            ds = f.create_dataset(name, data=np.asarray(values))
            for i, d in enumerate(dims):
                ds.dims[i].attach_scale(f[d])
                ds.dims[i].label = d
