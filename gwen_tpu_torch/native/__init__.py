"""ctypes bindings for the native graph-preprocessing library.

Builds ``graphcore.cpp`` (a copy of ``gwen_tpu/native/graphcore.cpp``) with
g++ on first use into ``gwen_tpu_torch/_build/``, keyed by source hash.
Every entry point has a pure-Python fallback in
``gwen_tpu_torch.graph.reorder``, so the package works without a toolchain;
the native path is a host-side speedup (sub-second RCM at ICON-mesh scale).
The esc2 build of ``to_diag_window`` runs RCM through this library, exactly
as the reference package does, so both produce the same permutation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "graphcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> ctypes.CDLL:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = BUILD_DIR / f"libgraphcore_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile to a private name and rename: test workers may build at
        # the same time, and a reader must never load a half-written file.
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               str(_SRC), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.gwen_rcm_order.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
    ]
    lib.gwen_rcm_order.restype = ctypes.c_int
    lib.gwen_bandwidth.argtypes = [ctypes.c_int64, i64p, i64p]
    lib.gwen_bandwidth.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built here."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build()
        except (OSError, subprocess.SubprocessError):
            _LIB = None
    return _LIB


def rcm_order(senders: np.ndarray, receivers: np.ndarray,
              num_nodes: int) -> Optional[np.ndarray]:
    """Native RCM; returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(senders, np.int64)
    r = np.ascontiguousarray(receivers, np.int64)
    out = np.empty(num_nodes, np.int64)
    rc = lib.gwen_rcm_order(num_nodes, len(s), s, r, out)
    if rc != 0:
        raise ValueError("native rcm_order: edge index out of range")
    return out


def bandwidth(senders: np.ndarray, receivers: np.ndarray) -> Optional[int]:
    """Native graph bandwidth max|s - r| (0 for no edges); returns None if
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(senders, np.int64)
    r = np.ascontiguousarray(receivers, np.int64)
    if s.shape != r.shape:
        raise ValueError("native bandwidth: senders and receivers differ in length")
    return int(lib.gwen_bandwidth(len(s), s, r))
