"""ctypes bindings to the native host-runtime library.

Port of ``orbslam2_tpu/utils/native.py``.  The C++ source is the
repository's ``native/orbslam2_native.cpp``; it is compiled on first use,
with the flags of ``native/Makefile``, into the gitignored
``build/orbslam2_tpu_torch/native/`` (nothing is written into ``native/``),
through a temporary file renamed into place so concurrent processes never
load a half-written library, and under a lock, so threads that ask at once
build it once.  Every entry point returns None when no C++
toolchain is available, and its callers then take their pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "native" / "orbslam2_native.cpp"
BUILD_DIR = _REPO / "build" / "orbslam2_tpu_torch" / "native"
LIB_PATH = BUILD_DIR / "liborbslam2_native.so"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _build() -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not SOURCE.is_file():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir) / LIB_PATH.name
        try:
            subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        os.replace(tmp, LIB_PATH)
    return True


def _load() -> Optional[ctypes.CDLL]:
    if _lib is not None:
        return _lib
    with _lock:
        return _lib if _lib is not None else _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib
    if not LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None

    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    lib.parse_orbvoc.restype = ctypes.c_int64
    lib.parse_orbvoc.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i32p, i32p, u8p, u8p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.parse_float_table.restype = ctypes.c_int64
    lib.parse_float_table.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    lib.decode_pgm.restype = ctypes.c_int32
    lib.decode_pgm.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p, ctypes.c_char_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_orbvoc_fast(path: str):
    """Native ORBvoc.txt parse -> (header k/L/s/w, parents, is_leaf,
    desc (n, 32) uint8, weights), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    # Upper bound on the node count: about one node per 80 bytes of text.
    max_nodes = max(len(data) // 60, 1024)
    header = np.zeros(4, np.int32)
    parents = np.zeros(max_nodes, np.int32)
    is_leaf = np.zeros(max_nodes, np.uint8)
    desc = np.zeros((max_nodes, 32), np.uint8)
    weight = np.zeros(max_nodes, np.float32)
    n = lib.parse_orbvoc(
        data, len(data), _ptr(header, ctypes.c_int32), _ptr(parents, ctypes.c_int32),
        _ptr(is_leaf, ctypes.c_uint8), _ptr(desc, ctypes.c_uint8),
        _ptr(weight, ctypes.c_float), max_nodes,
    )
    if n < 0:
        return None
    return (header, parents[:n].copy(), is_leaf[:n].astype(bool), desc[:n].copy(),
            weight[:n].copy())


def parse_float_table_fast(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    out = np.zeros(max(len(data) // 2, 64), np.float64)
    n = lib.parse_float_table(data, len(data), _ptr(out, ctypes.c_double), len(out))
    return out[:n].copy()


def decode_pgm_fast(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.decode_pgm(data, len(data), ctypes.byref(w), ctypes.byref(h), None):
        return None
    out = np.zeros((h.value, w.value), np.uint8)
    if lib.decode_pgm(data, len(data), ctypes.byref(w), ctypes.byref(h),
                      out.ctypes.data_as(ctypes.c_char_p)):
        return None
    return out.astype(np.float32)
