"""The port's data layer against the reference package: the numpy zarr
store against tensorstore (each package opens the other's stores), ingest,
preprocess, the lazy fields, the mesh stores and the member-graph dataset.
Everything here is host-side numpy, so equality is exact unless stated.
"""

import json
import time

import numpy as np
import pytest

import gwen_tpu.config as j_config
import gwen_tpu.data.dataset as j_dataset
import gwen_tpu.data.ingest as j_ingest
import gwen_tpu.data.meshstore as j_meshstore
import gwen_tpu.data.preprocess as j_pre
import gwen_tpu.data.zarrstore as j_zarr
from gwen_tpu.data.lazy import LazyField as JLazyField
from gwen_tpu.data.netcdf import write_netcdf_like as j_write_netcdf
from gwen_tpu_torch.config import DataConfig, TrainConfig
from gwen_tpu_torch.data import (
    MemberGraphDataset,
    MeshEnsembleDataset,
    load_data,
    load_member_shard,
    load_split,
    make_datasets,
    meshstore,
    netcdf,
    pipeline,
    preprocess as p_pre,
    zarrstore,
)
from gwen_tpu_torch.data.ingest import find_member_files, ingest
from gwen_tpu_torch.data.lazy import LazyField

pytest.importorskip("tensorstore")

DIMS = ("time", "member", "height", "ncells")
T, M, H, C = 10, 5, 4, 6
MEMBERS = ["-10.0_3000.0_2000.0", "-12.0_3000.0_2000.0", "-10.0_2500.0_1000.0"]


def _values(shape=(T, M, H, C), seed=0, dtype=np.float32):
    a = np.random.default_rng(seed).normal(size=shape) * 10
    return a.astype(dtype)


def _whole(shape):
    return tuple(slice(None) for _ in shape)


# ------------------------------------------------------------------- stores


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.uint8])
@pytest.mark.parametrize("level", [0, 1])
def test_zarr_round_trip_partial_chunks(tmp_path, dtype, level):
    a = _values((7, 3, 5), 1, dtype)
    arr = zarrstore.create(tmp_path / "a.zarr", a.shape, ("t", "m", "c"),
                           dtype=dtype, chunks=(4, 2, 3), compression_level=level,
                           meta={"note": "x"})
    assert zarrstore.exists(tmp_path / "a.zarr") and not zarrstore.exists(tmp_path)
    arr.write(_whole(a.shape), a)
    back = zarrstore.open_array(tmp_path / "a.zarr")
    assert back.shape == a.shape and back.dtype == np.dtype(dtype)
    assert back.dims == ("t", "m", "c") and back.meta == {"note": "x"}
    np.testing.assert_array_equal(back.read(), a)
    for idx in [3, (slice(1, 6), 1), (slice(None), slice(None), slice(1, 5, 2)),
                (-1, slice(None), -2), (slice(None, None, -3), 0),
                (Ellipsis, 2), (slice(5, 2),)]:
        np.testing.assert_array_equal(back[idx], a[idx], err_msg=str(idx))
    # A region that covers some chunks wholly and others in part.
    patch = _values((3, 3, 2), 2, dtype)
    back.write((slice(2, 5), slice(None), slice(2, 4)), patch)
    a[2:5, :, 2:4] = patch
    np.testing.assert_array_equal(zarrstore.open_array(tmp_path / "a.zarr").read(), a)
    compressed = json.loads((tmp_path / "a.zarr" / ".zarray").read_text())["compressor"]
    assert compressed == ({"id": "zlib", "level": 1} if level else None)


def test_zarr_append_and_errors(tmp_path):
    arr = zarrstore.create(tmp_path / "a.zarr", shape=(5, 0, 3),
                           dims=("time", "member", "cell"), chunks=(5, 1, 3))
    a = np.ones((5, 3), np.float32)
    arr.append(a, dim="member")
    arr.append(2 * a, dim="member")
    assert arr.shape == (5, 2, 3)
    got = zarrstore.open_array(tmp_path / "a.zarr").read()
    np.testing.assert_array_equal(got[:, 0], a)
    np.testing.assert_array_equal(got[:, 1], 2 * a)
    # Along a chunked axis: the old edge chunk is patched, not replaced.
    t = zarrstore.create(tmp_path / "t.zarr", (3, 2), ("time", "x"), chunks=(4, 2),
                         dtype=np.int32)
    t.write(_whole((3, 2)), np.arange(6).reshape(3, 2))
    t.append(np.arange(6, 16).reshape(5, 2), dim="time")
    np.testing.assert_array_equal(t.read(), np.arange(16).reshape(8, 2))
    with pytest.raises(FileNotFoundError):
        zarrstore.open_array(tmp_path / "missing.zarr")
    with pytest.raises(IndexError):
        t[8]
    with pytest.raises(TypeError):
        t[np.array([0, 1])]
    with pytest.raises(ValueError, match="unit-step"):
        t.write((slice(0, 4, 2),), np.zeros((2, 2)))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_opens_the_others_store(tmp_path, writer, level):
    a = _values()
    w_mod, r_mod = ((zarrstore, j_zarr) if writer == "port" else (j_zarr, zarrstore))
    w = w_mod.create(tmp_path / "s.zarr", (T, 0, H, C), DIMS, chunks=(4, 1, H, 4),
                     compression_level=level, meta={"members": ["a", "b"]})
    for m in range(M - 1):
        w.append(a[:, m], dim="member")
    w.save_meta()
    r = r_mod.open_array(tmp_path / "s.zarr")
    assert tuple(r.shape) == (T, M - 1, H, C) and tuple(r.dims) == DIMS
    assert r.meta == {"members": ["a", "b"]}
    np.testing.assert_array_equal(r.read(), a[:, :M - 1])
    np.testing.assert_array_equal(r[3, :, 1:3], a[3, :M - 1, 1:3])
    # The reader appends and overwrites; the writer's package sees it.
    r.append(a[:, M - 1:], dim="member")
    r.write((slice(0, 2), 0), 7 * np.ones((2, H, C), np.float32))
    a[0:2, 0] = 7
    np.testing.assert_array_equal(w_mod.open_array(tmp_path / "s.zarr").read(), a)


# ------------------------------------------------------- ingest, preprocess


def _straka_like_field(member_idx: int) -> np.ndarray:
    t = np.arange(T)[:, None, None]
    h = np.arange(H)[None, :, None]
    c = np.arange(C)[None, None, :]
    return (np.sin(0.3 * t + 0.1 * member_idx) * np.cos(0.5 * h)
            * np.exp(-0.1 * (c - C / 2) ** 2)).astype(np.float32)


@pytest.fixture
def raw_dir(tmp_path):
    pytest.importorskip("h5py")
    for i, mid in enumerate(MEMBERS):
        folder = tmp_path / "raw" / f"atmcirc-straka_93_{mid}"
        folder.mkdir(parents=True)
        writer = netcdf.write_netcdf_like if i else j_write_netcdf
        writer(folder / f"atmcirc-straka_93_{mid}_DOM01_ML_20080801T000000Z.nc",
               {"theta_v": (("time", "height", "ncells"), _straka_like_field(i))})
    return tmp_path / "raw"


def _cfgs(tmp_path, raw, tag, **kw):
    """The same data config for both packages, under ``tmp_path/tag``."""
    fields = dict(data_path=str(raw), zarr_path=str(tmp_path / tag / "combined.zarr"),
                  data_train=str(tmp_path / tag / "train.zarr"),
                  data_test=str(tmp_path / tag / "test.zarr"),
                  scaling_path=str(tmp_path / tag / "scaling.json"),
                  boundary_cells=0, time_chunk=4, **kw)
    return fields


def test_netcdf_round_trip_and_member_files(raw_dir, tmp_path):
    values = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    netcdf.write_netcdf_like(tmp_path / "f.nc",
                             {"theta_v": (("time", "height", "ncells"), values)})
    var = netcdf.read_variable(tmp_path / "f.nc", "theta_v")
    assert var.dims == ("time", "height", "ncells")
    np.testing.assert_array_equal(var.values, values)
    assert "theta_v" in netcdf.list_variables(tmp_path / "f.nc")
    np.testing.assert_array_equal(netcdf.read_coordinate(tmp_path / "f.nc", "time"),
                                  np.arange(2))
    cfg = DataConfig()
    got = find_member_files(raw_dir, cfg.filename_regex, "atmcirc-straka_93_*")
    want = j_ingest.find_member_files(raw_dir, cfg.filename_regex,
                                      "atmcirc-straka_93_*")
    assert got == want and sorted(m for m, _ in got) == sorted(MEMBERS)
    with pytest.raises(FileNotFoundError):
        find_member_files(tmp_path / "nowhere", cfg.filename_regex)


def test_ingest_and_preprocess_match_reference(raw_dir, tmp_path):
    p_cfg = DataConfig(**_cfgs(tmp_path, raw_dir, "port"))
    j_cfg = j_config.DataConfig(**_cfgs(tmp_path, raw_dir, "ref"))
    arch = ingest(p_cfg)
    j_arch = j_ingest.ingest(j_cfg)
    assert arch.shape == tuple(j_arch.shape) == (T, len(MEMBERS), H, C)
    assert arch.dims == tuple(j_arch.dims) and arch.meta == j_arch.meta
    np.testing.assert_array_equal(arch.read(), j_arch.read())

    train, test = p_pre.preprocess(p_cfg)
    j_train, j_test = j_pre.preprocess(j_cfg)
    assert json.loads(open(p_cfg.scaling_path).read()) == json.loads(
        open(j_cfg.scaling_path).read())
    for mine, theirs in ((train, j_train), (test, j_test)):
        a, b = zarrstore.open_array(mine), j_zarr.open_array(theirs)
        assert a.dims == tuple(b.dims) and a.meta == b.meta
        np.testing.assert_array_equal(a.read(), b.read())
        # And across: the reference reads the port's output.
        np.testing.assert_array_equal(j_zarr.open_array(mine).read(), b.read())
    tr, te, meta = load_data(p_cfg)
    j_tr, j_te, j_meta = j_dataset.load_data(j_cfg)
    assert tr.shape[0] == 7 and te.shape[0] == 3 and meta == j_meta
    np.testing.assert_array_equal(tr, j_tr)
    np.testing.assert_array_equal(te, j_te)
    with pytest.raises(FileNotFoundError):
        ingest(DataConfig(**_cfgs(tmp_path, tmp_path / "port", "none")))


def test_preprocess_crops_interpolates_and_coarsens(tmp_path):
    raw = _values((12, 4, 4, 9), 3)
    raw[3, 1, 2, 5] = np.nan
    raw[0, 0, 0, 8] = np.nan
    for mod, tag in ((zarrstore, "port"), (j_zarr, "ref")):
        arr = mod.create(tmp_path / tag / "combined.zarr", raw.shape, DIMS,
                         chunks=(4, 1, 4, 9), meta={"variable": "theta_v"})
        arr.write(_whole(raw.shape), raw)
    kw = dict(normalization="median-mad", coarsen=2)
    p_cfg = DataConfig(**{**_cfgs(tmp_path, "", "port", **kw), "boundary_cells": 1})
    j_cfg = j_config.DataConfig(**{**_cfgs(tmp_path, "", "ref", **kw),
                                   "boundary_cells": 1})
    p_pre.preprocess(p_cfg)
    j_pre.preprocess(j_cfg)
    tr, te, _ = load_data(p_cfg)
    j_tr, j_te, _ = j_dataset.load_data(j_cfg)
    assert tr.shape == (8, 4, 2, 4) and np.isfinite(tr).all()
    np.testing.assert_array_equal(tr, j_tr)
    np.testing.assert_array_equal(te, j_te)


def test_preprocess_functions_match_reference():
    v = _values((9, 3, 4), 4)
    v[2, 1, 1] = np.nan
    v[:, 0, 0] = np.nan
    np.testing.assert_array_equal(p_pre.interpolate_nans_time(v),
                                  j_pre.interpolate_nans_time(v))
    for got, want in zip(p_pre.split_time_indices(23, 0.7, 5),
                         j_pre.split_time_indices(23, 0.7, 5)):
        np.testing.assert_array_equal(got, want)
    clean = _values((9, 3, 4), 5)
    for method in ("mean-std", "median-mad"):
        sc = p_pre.compute_scaling(clean, method)
        assert sc == j_pre.compute_scaling(clean, method)
        np.testing.assert_allclose(
            p_pre.invert_scaling(p_pre.apply_scaling(clean, sc), sc), clean,
            rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        p_pre.compute_scaling(clean, "nope")
    np.testing.assert_array_equal(
        p_pre.coarsen_block_mean(clean, 2, axes=(0, 2)),
        j_pre.coarsen_block_mean(clean, 2, axes=(0, 2)))


# --------------------------------------------------------------- lazy fields


@pytest.fixture
def store(tmp_path):
    values = _values()
    arr = zarrstore.create(tmp_path / "train.zarr", values.shape, DIMS,
                           chunks=(2, M, H, C))
    arr.write(_whole(values.shape), values)
    return tmp_path / "train.zarr", values


def test_lazy_equals_eager_and_reference(store):
    path, values = store
    cfg = DataConfig(data_train=str(path), data_test=str(path), lazy=True)
    lazy, _ = load_split(cfg, "train")
    assert isinstance(lazy, LazyField)
    assert lazy.shape == values.shape and len(lazy) == T and lazy.ndim == 4
    j_lazy = JLazyField(j_zarr.open_array(path), want_dims=list(DIMS))
    t_sel, m_sel = np.array([0, 3, 9]), np.array([4, 0, 2])
    for idx in [2, -1, slice(1, 7, 2), (3, 1), (slice(2, 5), 1),
                (t_sel, m_sel), (t_sel, slice(1, 3)), t_sel]:
        np.testing.assert_array_equal(lazy[idx], values[idx], err_msg=str(idx))
        np.testing.assert_array_equal(lazy[idx], j_lazy[idx], err_msg=str(idx))
    np.testing.assert_array_equal(lazy.materialize(), values)
    mapped = lazy.map(lambda s: s[:-1]).map(lambda s: s * 2)
    assert mapped.shape == (T, M - 1, H, C)
    np.testing.assert_array_equal(mapped[4], values[4, :-1] * 2)
    eager, _ = load_split(DataConfig(data_train=str(path), coarsen=2), "train")
    lazy2, _ = load_split(DataConfig(data_train=str(path), coarsen=2, lazy=True),
                          "train")
    np.testing.assert_array_equal(lazy2.materialize(), eager)


def test_lazy_reads_steps_only_and_caches(store, monkeypatch):
    path, values = store
    arr = zarrstore.open_array(path)
    reads = []
    orig = zarrstore.ZarrArray.__getitem__

    def spy(self, idx):
        reads.append(idx)
        return orig(self, idx)

    monkeypatch.setattr(zarrstore.ZarrArray, "__getitem__", spy)
    monkeypatch.setattr(zarrstore.ZarrArray, "read",
                        lambda self: pytest.fail("whole-archive read"))
    lazy = LazyField(arr, cache_steps=2)
    ds = MemberGraphDataset(data=lazy, member_split=3, seed=1)
    for x, _ in ds.batches(2):
        assert x.shape == (2, M, H * C)
    assert reads and all(isinstance(i[0], int) for i in reads)
    reads.clear()
    lazy[5], lazy[5], lazy[6], lazy[5]
    assert len(reads) == 2
    lazy[7], lazy[5], lazy[6]
    assert len(reads) == 4  # 6, the least recently used, fell out for 7


# ------------------------------------------------------------------ datasets


@pytest.mark.parametrize("kw", [
    dict(), dict(simplify=True), dict(mask_inputs=True),
    dict(node_batch_size=2), dict(mask_inputs=True, node_batch_size=3),
], ids=["plain", "simplify", "mask_inputs", "node_batch", "mask_inputs-node_batch"])
def test_member_graph_dataset_matches_reference(kw):
    values = _values((9, 7, 3, 4), 6)
    nbs = kw.pop("node_batch_size", 0)
    ds = MemberGraphDataset(data=values, member_split=4, seed=11, **kw)
    j_ds = j_dataset.MemberGraphDataset(data=values, member_split=4, seed=11, **kw)
    assert (len(ds), ds.num_nodes, ds.num_features) == (9, 7, 12)
    np.testing.assert_array_equal(ds.input_indices, j_ds.input_indices)
    np.testing.assert_array_equal(ds.target_indices, j_ds.target_indices)
    np.testing.assert_array_equal(ds.target_mask, j_ds.target_mask)
    np.testing.assert_array_equal(ds.features(2), j_ds.features(2))
    got = list(ds.batches(2, shuffle=True, seed=3, node_batch_size=nbs))
    want = list(j_ds.batches(2, shuffle=True, seed=3, node_batch_size=nbs))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g) == len(w) == (3 if kw.get("mask_inputs") else 2)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    if kw.get("mask_inputs"):
        x, mask, target = got[0]
        assert not x[:, ds.target_mask].any() and target[:, ds.target_mask].any()
    if nbs:
        assert all(g[1].sum() >= 1 and not (g[1] & ~ds.target_mask).any()
                   for g in got)


def test_make_datasets_and_conv_refusal(store):
    path, values = store
    cfg = DataConfig(data_train=str(path), data_test=str(path))
    tr, te, meta = make_datasets(cfg, TrainConfig(member_split=3, seed=2))
    assert isinstance(tr, MemberGraphDataset) and len(te) == T and meta == {}
    np.testing.assert_array_equal(tr.data, values)
    # The CNN view, which the port once refused, splits the members as the
    # reference's does.
    tr, te, _ = make_datasets(cfg, TrainConfig(member_split=3, seed=2),
                              kind="conv")
    j_tr, _, _ = j_dataset.make_datasets(cfg, TrainConfig(member_split=3, seed=2),
                                         kind="conv")
    assert type(tr).__name__ == type(j_tr).__name__ == "ConvEnsembleDataset"
    np.testing.assert_array_equal(tr.input_indices, j_tr.input_indices)
    np.testing.assert_array_equal(te[1][1], j_tr[1][1])


def test_meshstore_round_trip_both_ways(tmp_path):
    fields = _values((6, 3, 20, 2), 7)
    s, r = np.arange(19), np.arange(1, 20)
    verts = _values((20, 3), 8, np.float64)
    meshstore.save_mesh_dataset(tmp_path / "p.zarr", fields, s, r, verts,
                                time_chunk=4, meta={"levels": 1})
    j_meshstore.save_mesh_dataset(tmp_path / "j.zarr", fields, s, r, verts,
                                  time_chunk=4, meta={"levels": 1})
    for load, path in ((meshstore.load_mesh_dataset, "j.zarr"),
                       (j_meshstore.load_mesh_dataset, "p.zarr"),
                       (meshstore.load_mesh_dataset, "p.zarr")):
        f, s2, r2, v2, meta = load(tmp_path / path)
        np.testing.assert_array_equal(f, fields)
        np.testing.assert_array_equal(s2, s)
        np.testing.assert_array_equal(r2, r)
        np.testing.assert_array_equal(v2, verts)
        assert meta == {"kind": "mesh-ensemble", "levels": 1}
    s3, r3, v3 = meshstore.load_mesh_graph(tmp_path / "j.zarr")
    np.testing.assert_array_equal(s3, s)
    np.testing.assert_array_equal(v3, verts)
    lazy = meshstore.load_mesh_dataset(tmp_path / "p.zarr", lazy=True)[0]
    eager_ds, lazy_ds = MeshEnsembleDataset(fields), MeshEnsembleDataset(lazy)
    for a, b in zip(eager_ds.batches(4, shuffle=True, seed=1),
                    lazy_ds.batches(4, shuffle=True, seed=1)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for a, b in zip(eager_ds.trajectory_batches(2, 2), lazy_ds.trajectory_batches(2, 2)):
        np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="time, member, node, channel"):
        meshstore.save_mesh_dataset(tmp_path / "bad.zarr", fields[0], s, r)
    plain = zarrstore.create(tmp_path / "plain.zarr", (2, 2), ("a", "b"))
    with pytest.raises(ValueError, match="not a mesh-ensemble store"):
        meshstore.load_mesh_dataset(plain.path)
    with pytest.raises(FileNotFoundError):
        meshstore.load_mesh_graph(plain.path)


def test_load_member_shard_and_pipeline(store, monkeypatch):
    path, values = store
    arr = zarrstore.open_array(path)
    np.testing.assert_array_equal(load_member_shard(arr), values)
    np.testing.assert_array_equal(load_member_shard(arr, slice(2, 6)), values[2:6])
    # Rank 1 of 2: members 3 and 4 (the first slice is one longer).
    from gwen_tpu_torch.data import multihost

    monkeypatch.setattr(multihost, "_world", lambda: (2, 1))
    np.testing.assert_array_equal(load_member_shard(arr, slice(0, 3)),
                                  values[0:3, 3:5])
    batches = [(values[i], {"k": values[i + 1]}, i) for i in range(4)]
    got = list(pipeline.prefetch(iter(batches), size=2, pin_memory=True))
    assert [g[2] for g in got] == [0, 1, 2, 3]
    np.testing.assert_array_equal(got[1][0].numpy(), values[1])
    np.testing.assert_array_equal(got[1][1]["k"].numpy(), values[2])

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(pipeline.prefetch(broken()))


def test_prefetch_stops_its_producer_when_the_consumer_ends_early():
    import threading

    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = pipeline.prefetch(endless(), size=2)
    with pytest.raises(RuntimeError, match="step failed"):
        for b in it:
            if b == 3:
                raise RuntimeError("step failed")
    it.close()  # what leaving the loop's frame does to the generator
    assert threading.active_count() == before
    n = len(made)
    assert n <= 3 + 1 + 2 + 1  # taken, in flight and the queue's two
    time.sleep(0.3)
    assert len(made) == n
