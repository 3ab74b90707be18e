"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use they are
compiled by ``nvcc`` for ``sm_90a`` into one shared library under
``build/orbslam2_tpu_torch/<hash of the sources>/`` at the repository root
(so an edit rebuilds), loaded with ``ctypes`` and launched on PyTorch's
current stream.  Each C entry returns ``cudaGetLastError()`` and the
wrapper raises if it is not 0.

Each wrapper takes CUDA tensors only and raises on anything else; the
dispatch to the plain PyTorch versions for CPU tensors lives in the
callers (``ops/fast.py``, ``ops/hamming.py``).  ``LAUNCHES`` counts the
launches of each kernel; nothing else changes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("fast_nms.cu", "hamming.cu")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "orbslam2_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = {"fast_score_nms": 0, "hamming_matrix": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "liborbslam2_kernels.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(_CSRC / s) for s in _SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load():
    """Build if needed, then load the library (once per process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fast_score_nms_launch.argtypes = [vp, vp, ci, ci, vp]
        lib.fast_score_nms_launch.restype = ci
        lib.hamming_matrix_launch.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.hamming_matrix_launch.restype = ci
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fast_score_nms_cuda(image: torch.Tensor) -> torch.Tensor:
    """K1: (H, W) float32 CUDA image -> (H, W) float32 FAST-9 score after
    3x3 NMS, equal to ``ops.fast.nms3x3(ops.fast.fast_score(image))``."""
    _check("fast_score_nms", image, torch.float32, 2)
    h, w = image.shape
    out = torch.empty_like(image)
    lib = load()
    with torch.cuda.device(image.device):
        err = lib.fast_score_nms_launch(image.data_ptr(), out.data_ptr(), h, w, _stream(image))
    _raise_on(err, "fast_score_nms")
    LAUNCHES["fast_score_nms"] += 1
    return out


def hamming_matrix_cuda(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """K2: (Na, 8) x (Nb, 8) int32 CUDA descriptors (uint32 bits) ->
    (Na, Nb) int32 Hamming distances, any Na, Nb >= 1."""
    _check("hamming_matrix a", desc_a, torch.int32, 2)
    _check("hamming_matrix b", desc_b, torch.int32, 2)
    if desc_a.shape[1] != 8 or desc_b.shape[1] != 8:
        raise ValueError("hamming_matrix: descriptors must be (N, 8) words")
    if desc_a.device != desc_b.device:
        raise ValueError("hamming_matrix: operands on different devices")
    na, nb = desc_a.shape[0], desc_b.shape[0]
    if na < 1 or nb < 1 or (na + 31) // 32 > 65535:
        raise ValueError(f"hamming_matrix: unsupported sizes Na={na}, Nb={nb}")
    out = torch.empty((na, nb), dtype=torch.int32, device=desc_a.device)
    lib = load()
    with torch.cuda.device(desc_a.device):
        err = lib.hamming_matrix_launch(
            desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(), na, nb, _stream(desc_a)
        )
    _raise_on(err, "hamming_matrix")
    LAUNCHES["hamming_matrix"] += 1
    return out
