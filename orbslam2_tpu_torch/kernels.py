"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use each is
compiled by its own ``nvcc`` for ``sm_90a`` (all started together), and the
objects are linked into one shared library under
``build/orbslam2_tpu_torch/<hash of the sources>/`` at the repository root
(so an edit rebuilds), loaded with ``ctypes`` and launched on PyTorch's
current stream.  Each C entry returns ``cudaGetLastError()`` and the
wrapper raises if it is not 0.

Each wrapper takes CUDA tensors only and raises on anything else; the
dispatch to the plain PyTorch versions for CPU tensors lives in the
callers (``ops/fast.py``, ``ops/hamming.py``, ``solvers/ba_kernels.py``).
``LAUNCHES`` counts the launches of each kernel; nothing else changes it.
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
_SOURCES = ("fast_nms.cu", "hamming.cu", "ba_kernels.cu")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "orbslam2_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

LAUNCHES = {"fast_score_nms": 0, "hamming_matrix": 0, "ba_normal_equations": 0, "ba_chi2": 0}

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
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (Path(name).stem + ".o") for name in _SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(_CSRC / name)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, obj in zip(_SOURCES, objs)
        ]
        errors = []
        for name, proc in zip(_SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        lib = Path(tmp) / out.name
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(lib, out)
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
        cf = ctypes.c_float
        lib.ba_normal_equations_launch.argtypes = (
            [vp] * 10 + [ci, ci] + [cf] * 5 + [ci, vp])
        lib.ba_normal_equations_launch.restype = ci
        lib.ba_chi2_launch.argtypes = [vp] * 8 + [ci, ci] + [cf] * 5 + [vp]
        lib.ba_chi2_launch.restype = ci
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


def _ba_inputs(poses, X, uv, ur, inv_s2, mask):
    """Checks of the K4/K5 inputs; returns (C, N)."""
    _check("ba poses", poses, torch.float32, 3)
    _check("ba X", X, torch.float32, 3)
    _check("ba uv", uv, torch.float32, 3)
    _check("ba ur", ur, torch.float32, 2)
    _check("ba inv_s2", inv_s2, torch.float32, 2)
    _check("ba mask", mask, torch.bool, 2)
    C, _, N = X.shape
    if C < 1 or N < 1:
        raise ValueError(f"ba kernels: empty problem C={C}, N={N}")
    shapes = {"poses": (poses.shape, (C, 4, 4)), "X": (X.shape, (C, 3, N)),
              "uv": (uv.shape, (C, 2, N)), "ur": (ur.shape, (C, N)),
              "inv_s2": (inv_s2.shape, (C, N)), "mask": (mask.shape, (C, N))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"ba kernels: {name} has shape {tuple(got)}, expected {want}")
    if len({t.device for t in (poses, X, uv, ur, inv_s2, mask)}) != 1:
        raise ValueError("ba kernels: operands on different devices")
    return C, N


def ba_normal_equations_cuda(poses, X, uv, ur, inv_s2, mask, intrinsics, robust: bool):
    """K4: poses (C, 4, 4), X (C, 3, N), uv (C, 2, N), ur / inv_s2 (C, N)
    float32 and mask (C, N) bool, all CUDA; ``intrinsics`` the floats
    (fx, fy, cx, cy, bf).  Returns (H_cc (C, 6, 6), b_c (C, 6),
    pack (C, 32, N), chi2_sum (C,)), as ``solvers.ba_kernels``."""
    C, N = _ba_inputs(poses, X, uv, ur, inv_s2, mask)
    dev = X.device
    pack = torch.empty((C, 32, N), dtype=torch.float32, device=dev)
    H = torch.empty((C, 6, 6), dtype=torch.float32, device=dev)
    b = torch.empty((C, 6), dtype=torch.float32, device=dev)
    chi2 = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.ba_normal_equations_launch(
            poses.data_ptr(), X.data_ptr(), uv.data_ptr(), ur.data_ptr(), inv_s2.data_ptr(),
            mask.data_ptr(), pack.data_ptr(), H.data_ptr(), b.data_ptr(), chi2.data_ptr(),
            C, N, *(float(v) for v in intrinsics), int(bool(robust)), _stream(X),
        )
    _raise_on(err, "ba_normal_equations")
    LAUNCHES["ba_normal_equations"] += 1
    return H, b, pack, chi2


def ba_chi2_cuda(poses, X, uv, ur, inv_s2, mask, intrinsics):
    """K5: the inputs of K4.  Returns (chi2 (C, N), chi2_sum (C,))."""
    C, N = _ba_inputs(poses, X, uv, ur, inv_s2, mask)
    dev = X.device
    chi2 = torch.empty((C, N), dtype=torch.float32, device=dev)
    total = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.ba_chi2_launch(
            poses.data_ptr(), X.data_ptr(), uv.data_ptr(), ur.data_ptr(), inv_s2.data_ptr(),
            mask.data_ptr(), chi2.data_ptr(), total.data_ptr(), C, N,
            *(float(v) for v in intrinsics), _stream(X),
        )
    _raise_on(err, "ba_chi2")
    LAUNCHES["ba_chi2"] += 1
    return chi2, total
