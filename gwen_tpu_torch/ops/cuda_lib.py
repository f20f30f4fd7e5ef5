"""The port's CUDA libraries, one :class:`CudaLib` per ``csrc/*.cu`` source
declared by the wrapper module that launches it, and the rules every kernel
wrapper shares: :func:`on_cuda` and :func:`launch_failed`."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PTR, INT, LONG, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
LIBRARIES: list[CudaLib] = []


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in csrc/")
    return nvcc


def nvcc_build(src: Path) -> tuple[Path, str]:
    """Compile the CUDA source ``src`` for sm_90a into a shared library in
    ``_build/`` (once per source hash). Returns the library path and the
    compiler's output (ptxas register and shared-memory use; empty when
    already built). Each compile adds one to ``nvcc_build.loads`` and its
    seconds to ``nvcc_build.load_seconds``."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if out.exists():
        return out, ""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    nvcc_build.loads += 1
    nvcc_build.load_seconds += time.perf_counter() - t0
    return out, res.stdout + res.stderr


nvcc_build.loads, nvcc_build.load_seconds = 0, 0.0


class CudaLib:
    """The library of ``csrc/<source>``, each entry point's argument types a
    keyword (every entry returns ``int``). A call returns ``lib``, built,
    loaded and bound at the first; ``loads`` and ``load_seconds`` count the
    load, not the build. :data:`LIBRARIES` holds every one declared."""

    def __init__(self, source: str, **entries: list) -> None:
        self.source = CSRC / source
        self.entries = entries
        self.lib: Optional[ctypes.CDLL] = None
        self.loads = 0
        self.load_seconds = 0.0
        LIBRARIES.append(self)

    def build(self) -> tuple[Path, str]:
        """Compile the source (see :func:`nvcc_build`)."""
        return nvcc_build(self.source)

    def __call__(self) -> ctypes.CDLL:
        if self.lib is None:
            path, _ = self.build()
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self.lib = lib
            self.loads += 1
            self.load_seconds += time.perf_counter() - t0
        return self.lib


def on_cuda(x: torch.Tensor, kernels: str) -> bool:
    """False on a CPU tensor (the plain version runs), True on a CUDA one
    (the kernel launches); any other device raises, naming the ``kernels``."""
    if x.is_cuda:
        return True
    if x.is_cpu:
        return False
    raise ValueError(f"no {kernels} kernel for device {x.device}")


def launch_failed(name: str, rc: int) -> RuntimeError:
    """The error of a launch that returned ``rc`` ≠ 0: below 0 the entry
    point refused its arguments, above 0 a CUDA error."""
    return RuntimeError(f"{name} launch failed: "
                        f"{'arguments refused' if rc < 0 else f'CUDA error {rc}'}")


def fit_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` cut or zero-padded to ``rows`` node rows."""
    have = t.shape[-2]
    if have >= rows:
        return t[..., :rows, :]
    return torch.cat([t, t.new_zeros(*t.shape[:-2], rows - have, t.shape[-1])],
                     dim=-2)
