"""The port's binding to its CUDA libraries (``gwen_tpu_torch.ops.cuda_lib``)
on the CPU: the build's library names, the load and the binding of each
library's entry points, the device rule and the launch-status rule of
every wrapper, and the segment sum's launch arguments.

A recording library (``fake_lib``, shared with the other wrapper tests)
stands in for every built one, and the device rule takes CPU tensors for
CUDA ones, so the wrappers' argument packing runs here as it does on the
card: ``edges.segment_sum`` on a slice of the join's cotangent passes its
row and batch strides, not a copy."""

import ctypes
import hashlib
import types
from pathlib import Path

import pytest
import torch

from gwen_tpu_torch.ops import (
    attention_cuda,
    cuda_lib,
    edges,
    fused_ln,
    spmm_cuda,
    unfused_cuda,
)


class _FakeLib:
    """Stands in for every built library: records each entry point's
    arguments and returns ``rc``."""

    def __init__(self):
        self.calls = []
        self.rc = 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    """A recording library loaded in place of every CUDA library, and the
    device rule taking every tensor for a CUDA one."""
    lib = _FakeLib()
    for held in cuda_lib.LIBRARIES:
        monkeypatch.setattr(held, "lib", lib)
    monkeypatch.setattr(cuda_lib, "on_cuda", lambda x, kernels: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return lib


SOURCES = ["edge_sum", "window_attention", "window_spmm", "window_unfused"]


def _library(stem):
    (lib,) = [lib for lib in cuda_lib.LIBRARIES if lib.source.stem == stem]
    return lib


# ----------------------------------------------------------- build and load


def test_every_source_has_one_library():
    assert sorted(lib.source.stem for lib in cuda_lib.LIBRARIES) == SOURCES
    assert sorted(p.stem for p in cuda_lib.CSRC.glob("*.cu")) == SOURCES


@pytest.mark.parametrize("stem", SOURCES)
def test_a_build_is_named_by_its_source_hash(stem, monkeypatch, tmp_path):
    """``lib{stem}_{sha256[:16]}.so`` in ``_build/``, compiled once with
    the flags for sm_90a; a second build finds it."""
    args = tmp_path / "args"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" > {args}\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib.nvcc_build, "loads", cuda_lib.nvcc_build.loads)
    monkeypatch.setattr(cuda_lib.nvcc_build, "load_seconds", cuda_lib.nvcc_build.load_seconds)
    lib = _library(stem)
    tag = hashlib.sha256(lib.source.read_bytes()).hexdigest()[:16]
    path, _ = lib.build()
    assert path == tmp_path / "build" / f"lib{stem}_{tag}.so" and path.exists()
    flags = args.read_text().split()
    assert flags[:len(cuda_lib.NVCC_FLAGS)] == cuda_lib.NVCC_FLAGS
    assert flags[-1] == str(lib.source)
    args.unlink()
    assert lib.build() == (path, "") and not args.exists()


class LoadedLib:
    """Stands in for ``ctypes.CDLL``: any entry point, any binding."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        entry = types.SimpleNamespace()
        setattr(self, name, entry)
        return entry


@pytest.mark.parametrize("stem", SOURCES)
def test_a_library_loads_its_build_and_binds_its_entries(stem, monkeypatch):
    lib = _library(stem)
    monkeypatch.setattr(lib, "lib", None)
    monkeypatch.setattr(lib, "loads", lib.loads)
    monkeypatch.setattr(lib, "load_seconds", lib.load_seconds)
    monkeypatch.setattr(lib, "build", lambda: (Path(f"lib{stem}.so"), ""))
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", LoadedLib)
    loaded = lib()
    assert loaded.path == f"lib{stem}.so" and lib.entries
    for name, argtypes in lib.entries.items():
        fn = getattr(loaded, name)
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_int


# ------------------------------------------------------------------- rules


WRAPPERS = {
    "window SpMM": lambda x: spmm_cuda.block_ell_spmm(None, x),
    "windowed-attention": lambda x: attention_cuda.attention_fwd(None, x, x, x, 1.0),
    "SDDMM or transpose-SpMM": lambda x: unfused_cuda.sddmm(None, x, x),
    "segment sum": lambda x: edges.segment_sum(x, torch.zeros(3, dtype=torch.int32)),
    "fused LayerNorm": lambda x: fused_ln.residual_layernorm_fwd(x, x, x[0], x[0]),
}


@pytest.mark.parametrize("kernels", sorted(WRAPPERS))
def test_a_wrapper_refuses_a_device_other_than_cpu_and_cuda(kernels):
    with pytest.raises(ValueError, match=f"^no {kernels} kernel for device meta$"):
        WRAPPERS[kernels](torch.zeros(4, 8, device="meta"))


@pytest.mark.parametrize("rc,says", [(-1, "arguments refused"), (700, "CUDA error 700")])
def test_a_failed_launch_raises(rc, says, fake_lib):
    fake_lib.rc = rc
    with pytest.raises(RuntimeError, match=f"^segment sum launch failed: {says}$"):
        edges.segment_sum(torch.zeros(4, 8), torch.tensor([0, 2, 4], dtype=torch.int32))
    assert len(fake_lib.calls) == 1


# ------------------------------------------------------ the segment sum launch


E, FE, FS, WIDE = 6, 8, 16, 40  # edges, the join's latent and sender widths


def _tables(order: bool):
    offsets = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int32)  # an empty segment
    return offsets, (torch.tensor([3, 0, 5, 1, 4, 2], dtype=torch.int32) if order else None)


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
@pytest.mark.parametrize("order", [False, True], ids=["receivers", "senders"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=["2d", "3d", "4d"])
def test_segment_sum_reads_the_cotangent_slice_in_place(lead, order, dtype, code, fake_lib):
    """The sender slice ``g[..., fe:fe + fs]`` of the join's cotangent is
    launched on as it lies: its pointer, a row stride of the full width and
    a batch stride of a full item; ``order`` or null; one launch."""
    offsets, perm = _tables(order)
    g = torch.zeros(*lead, E, WIDE, dtype=dtype)
    src = g[..., FE:FE + FS]
    before = edges.segment_sum.launches
    out = edges.segment_sum(src, offsets, perm)
    assert edges.segment_sum.launches == before + 1
    assert out.shape == (*lead, 4, FS) and out.dtype == dtype
    (name, args), = fake_lib.calls
    assert name == "gwen_segment_sum"
    assert args[:4] == (src.data_ptr(), offsets.data_ptr(),
                        None if perm is None else perm.data_ptr(), out.data_ptr())
    batch = 1
    for n in lead:
        batch *= n
    assert args[4] == WIDE and (batch == 1 or args[5] == E * WIDE)
    assert args[6:] == (4, E, FS, batch, code, 0)


BAD = {
    "int64 offsets": (lambda src, off, order: (src, off.long(), order), ValueError),
    "strided offsets": (lambda src, off, order: (
        src, off.repeat_interleave(2)[::2], order), ValueError),
    "int64 order": (lambda src, off, order: (src, off, order.long()), ValueError),
    "short order": (lambda src, off, order: (src, off, order[:-1]), ValueError),
    "strided features": (lambda src, off, order: (
        src.transpose(-1, -2).contiguous().transpose(-1, -2), off, order), ValueError),
    "float16": (lambda src, off, order: (src.half(), off, order), TypeError),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_segment_sum_refuses_before_any_launch(bad, fake_lib):
    offsets, perm = _tables(True)
    change, exc = BAD[bad]
    src, offsets, perm = change(torch.zeros(2, E, FS), offsets, perm)
    with pytest.raises(exc):
        edges.segment_sum(src, offsets, perm)
    assert fake_lib.calls == []


def test_segment_sum_of_nothing_launches_nothing(fake_lib):
    out = edges.segment_sum(torch.zeros(2, E, 0), torch.tensor([0, 6], dtype=torch.int32))
    assert out.shape == (2, 1, 0) and fake_lib.calls == []
