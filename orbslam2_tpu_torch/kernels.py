"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use one
``nvcc`` per source, all at once, compiles them for ``sm_90a``, and one
link makes them a shared library under
``build/orbslam2_tpu_torch/<hash of the sources>/`` at the repository root
(so an edit rebuilds), which is loaded with ``ctypes``; the kernels launch
on PyTorch's current stream.  Each C entry returns ``cudaGetLastError()``
and the wrapper raises if it is not 0.

Each wrapper takes CUDA tensors only and raises on anything else; the
dispatch to the plain PyTorch versions for CPU tensors lives in the
callers (``ops/fast.py``, ``ops/hamming.py``, ``ops/matcher.py``,
``solvers/ba_kernels.py``).
``LAUNCHES`` counts the launches of each kernel, and
``THREAD_LAUNCHES`` the same launches by the name of the thread that made
them (the async mapping worker launches beside the tracker); nothing else
changes them.  The build, the load and the counts are guarded by locks, so
threads that launch at once build the library once and lose no count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("fast_nms.cu", "hamming.cu", "projection_best2.cu", "ba_kernels.cu")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "orbslam2_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# The most pyramid levels one K1 launch takes (MAX_LEVELS in csrc/fast_nms.cu).
FAST_MAX_LEVELS = 16

LAUNCHES = {"fast_score_nms": 0, "hamming_matrix": 0, "projection_best2": 0,
            "ba_normal_equations": 0, "ba_chi2": 0}
THREAD_LAUNCHES: dict = {}  # thread name -> {kernel: launches}

_lib = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        THREAD_LAUNCHES.clear()


def _count(name: str) -> None:
    """One launch of kernel ``name``, in the total and under the thread."""
    with _count_lock:
        LAUNCHES[name] += 1
        thread = threading.current_thread().name
        THREAD_LAUNCHES.setdefault(thread, dict.fromkeys(LAUNCHES, 0))[name] += 1


def thread_launch_counts() -> dict:
    """A copy of ``THREAD_LAUNCHES``."""
    with _count_lock:
        return {t: dict(c) for t, c in THREAD_LAUNCHES.items()}


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
    ``nvcc -c`` per source, all started together, then one link into a
    temporary file that is renamed into place, so a process never loads a
    half-written library."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        objs = [Path(tmp_dir) / (Path(n).stem + ".o") for n in _SOURCES]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / n)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for n, o in zip(_SOURCES, objs)]
        for n, p in zip(_SOURCES, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                    q.wait()
                raise RuntimeError(f"nvcc failed on {n} ({p.returncode}):\n{err}")
        tmp = Path(tmp_dir) / out.name
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    return out


def load():
    """Build if needed, then load the library (once per process, whichever
    threads ask at once)."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cf = ctypes.c_float
        vpp, cip = ctypes.POINTER(vp), ctypes.POINTER(ci)
        lib.fast_score_nms_levels_launch.argtypes = [vpp, vpp, cip, cip, ci, cf, vp]
        lib.fast_score_nms_levels_launch.restype = ci
        lib.hamming_matrix_launch.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.hamming_matrix_launch.restype = ci
        lib.projection_best2_launch.argtypes = [vp] * 10 + [ci, ci, ci] + [vp] * 4
        lib.projection_best2_launch.restype = ci
        lib.ba_normal_equations_launch.argtypes = (
            [vp] * 10 + [ci, ci, ci] + [cf] * 5 + [ci, vp])
        lib.ba_normal_equations_launch.restype = ci
        lib.ba_chi2_launch.argtypes = [vp] * 8 + [ci, ci, ci] + [cf] * 5 + [vp]
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


def fast_score_nms_levels_cuda(levels, min_th: float = 0.0) -> list:
    """K1: 1 to FAST_MAX_LEVELS (H, W) float32 CUDA images (the levels of a
    pyramid), one launch -> for each, its FAST-9 score after 3x3 NMS,
    thresholded: ``where(s >= min_th, s, 0)`` for
    ``s = ops.fast.nms3x3(ops.fast.fast_score(level))``.  The outputs are
    views of one buffer."""
    levels = list(levels)
    if not 1 <= len(levels) <= FAST_MAX_LEVELS:
        raise ValueError(f"fast_score_nms: {len(levels)} levels, one launch takes 1 to "
                         f"{FAST_MAX_LEVELS}")
    for i, x in enumerate(levels):
        _check(f"fast_score_nms level {i}", x, torch.float32, 2)
        if x.numel() == 0:
            raise ValueError(f"fast_score_nms: level {i} is empty, shape {tuple(x.shape)}")
    dev = levels[0].device
    if any(x.device != dev for x in levels):
        raise ValueError("fast_score_nms: levels on different devices")
    sizes = [x.numel() for x in levels]
    outs = [o.view(x.shape) for o, x in zip(
        torch.empty(sum(sizes), dtype=torch.float32, device=dev).split(sizes), levels)]
    n = len(levels)
    ptrs, ints = ctypes.c_void_p * n, ctypes.c_int * n
    lib = load()
    with torch.cuda.device(dev):
        err = lib.fast_score_nms_levels_launch(
            ptrs(*(x.data_ptr() for x in levels)), ptrs(*(o.data_ptr() for o in outs)),
            ints(*(x.shape[0] for x in levels)), ints(*(x.shape[1] for x in levels)), n,
            float(min_th), _stream(levels[0]))
    _raise_on(err, "fast_score_nms")
    _count("fast_score_nms")
    return outs


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
    _count("hamming_matrix")
    return out


def _levels(t: torch.Tensor) -> torch.Tensor:
    """Octave levels as int32 (``predict_scale`` gives int64)."""
    return t.to(torch.int32) if t.dtype == torch.int64 else t


def projection_best2_cuda(proj_uv, rr2, proj_level, proj_desc, proj_valid,
                          frame_xy, frame_level, frame_desc, frame_valid,
                          level_band: int, level_dir=None):
    """K3: sources proj_uv (M, 2) / rr2 (M,) float32, proj_level (M,)
    int32 or int64, proj_desc (M, 8) int32, proj_valid (M,) bool; targets
    frame_xy (N, 2) float32, frame_level (N,) int32 or int64, frame_desc
    (N, 8) int32, frame_valid (N,) bool; ``level_dir`` None or a 0-d / 1-
    element int32 tensor read on the device.  All CUDA and contiguous.
    Returns (best_idx (M,) int64, best (M,) int32, second (M,) int32), as
    ``ops.matcher._projection_best2_plain``; any M, N >= 1."""
    proj_level, frame_level = _levels(proj_level), _levels(frame_level)
    for name, t, dtype, ndim in (
        ("proj_uv", proj_uv, torch.float32, 2), ("rr2", rr2, torch.float32, 1),
        ("proj_level", proj_level, torch.int32, 1), ("proj_desc", proj_desc, torch.int32, 2),
        ("proj_valid", proj_valid, torch.bool, 1), ("frame_xy", frame_xy, torch.float32, 2),
        ("frame_level", frame_level, torch.int32, 1), ("frame_desc", frame_desc, torch.int32, 2),
        ("frame_valid", frame_valid, torch.bool, 1),
    ):
        _check(f"projection_best2 {name}", t, dtype, ndim)
    M, N = proj_desc.shape[0], frame_desc.shape[0]
    shapes = {"proj_uv": (proj_uv.shape, (M, 2)), "rr2": (rr2.shape, (M,)),
              "proj_level": (proj_level.shape, (M,)), "proj_desc": (proj_desc.shape, (M, 8)),
              "proj_valid": (proj_valid.shape, (M,)), "frame_xy": (frame_xy.shape, (N, 2)),
              "frame_level": (frame_level.shape, (N,)), "frame_desc": (frame_desc.shape, (N, 8)),
              "frame_valid": (frame_valid.shape, (N,))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"projection_best2: {name} has shape {tuple(got)}, expected {want}")
    if M < 1 or N < 1:
        raise ValueError(f"projection_best2: unsupported sizes M={M}, N={N}")
    tensors = [proj_uv, rr2, proj_level, proj_desc, proj_valid,
               frame_xy, frame_level, frame_desc, frame_valid]
    if level_dir is not None:
        if level_dir.device.type != "cuda" or level_dir.dtype != torch.int32 or (
                level_dir.numel() != 1):
            raise ValueError("projection_best2: level_dir must be one int32 on a CUDA device")
        tensors.append(level_dir)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("projection_best2: operands on different devices")
    dev = proj_desc.device
    idx = torch.empty((M,), dtype=torch.int64, device=dev)
    best = torch.empty((M,), dtype=torch.int32, device=dev)
    second = torch.empty((M,), dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.projection_best2_launch(
            proj_desc.data_ptr(), proj_uv.data_ptr(), rr2.data_ptr(), proj_level.data_ptr(),
            proj_valid.data_ptr(), frame_desc.data_ptr(), frame_xy.data_ptr(),
            frame_level.data_ptr(), frame_valid.data_ptr(),
            None if level_dir is None else level_dir.data_ptr(), M, N, int(level_band),
            idx.data_ptr(), best.data_ptr(), second.data_ptr(), _stream(proj_desc),
        )
    _raise_on(err, "projection_best2")
    _count("projection_best2")
    return idx, best, second


# K4/K5's launch shape (THREADS, MAX_SPLIT in csrc/ba_kernels.cu): blocks of
# BA_THREADS threads, each camera's observations split over a cluster of
# ba_split(C, N) blocks, for at least BA_BLOCKS blocks in all where the
# cluster limit allows.
BA_THREADS = 128
BA_MAX_SPLIT = 8
BA_BLOCKS = 128


def ba_split(C: int, N: int) -> int:
    """The number of blocks S (1, 2, 4 or 8) over which K4 and K5 split
    each camera's N observations: the smallest S with C * S >= BA_BLOCKS,
    else BA_MAX_SPLIT, halved while S > N so that no block is empty.
    Block r of S takes observations [r N // S, (r + 1) N // S).  A pure
    function of the shape, so the order of the kernels' sums is too."""
    S = 1
    while S < BA_MAX_SPLIT and C * S < BA_BLOCKS:
        S *= 2
    while S > max(N, 1):
        S //= 2
    return S


def _split(split, C: int, N: int) -> int:
    """``split`` checked (1, 2, 4 or 8, at most N), or ba_split(C, N)."""
    if split is None:
        return ba_split(C, N)
    if split not in (1, 2, 4, 8) or split > max(N, 1):
        raise ValueError(f"ba kernels: split {split} for N={N}")
    return int(split)


def _ba_inputs(poses, X, uv, ur, inv_s2, mask):
    """Checks of the K4/K5 inputs; returns (C, N)."""
    _check("ba poses", poses, torch.float32, 3)
    _check("ba X", X, torch.float32, 3)
    _check("ba uv", uv, torch.float32, 3)
    _check("ba ur", ur, torch.float32, 2)
    _check("ba inv_s2", inv_s2, torch.float32, 2)
    _check("ba mask", mask, torch.bool, 2)
    C, _, N = X.shape
    if C < 1 or N < 1 or C > 65535:
        raise ValueError(f"ba kernels: unsupported sizes C={C}, N={N}")
    shapes = {"poses": (poses.shape, (C, 4, 4)), "X": (X.shape, (C, 3, N)),
              "uv": (uv.shape, (C, 2, N)), "ur": (ur.shape, (C, N)),
              "inv_s2": (inv_s2.shape, (C, N)), "mask": (mask.shape, (C, N))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"ba kernels: {name} has shape {tuple(got)}, expected {want}")
    if len({t.device for t in (poses, X, uv, ur, inv_s2, mask)}) != 1:
        raise ValueError("ba kernels: operands on different devices")
    return C, N


def ba_normal_equations_cuda(poses, X, uv, ur, inv_s2, mask, intrinsics, robust: bool,
                             split=None):
    """K4: poses (C, 4, 4), X (C, 3, N), uv (C, 2, N), ur / inv_s2 (C, N)
    float32 and mask (C, N) bool, all CUDA; ``intrinsics`` the floats
    (fx, fy, cx, cy, bf).  Returns (H_cc (C, 6, 6), b_c (C, 6),
    pack (C, 32, N), chi2_sum (C,)), as ``solvers.ba_kernels``; one launch
    of (S, C) blocks in clusters of S = ``split``, by default
    ba_split(C, N) (a sharded solve passes its whole problem's)."""
    C, N = _ba_inputs(poses, X, uv, ur, inv_s2, mask)
    S = _split(split, C, N)
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
            C, N, S, *(float(v) for v in intrinsics), int(bool(robust)),
            _stream(X),
        )
    _raise_on(err, "ba_normal_equations")
    _count("ba_normal_equations")
    return H, b, pack, chi2


def ba_chi2_cuda(poses, X, uv, ur, inv_s2, mask, intrinsics, split=None):
    """K5: the inputs of K4 (``split`` as there).  Returns (chi2 (C, N),
    chi2_sum (C,))."""
    C, N = _ba_inputs(poses, X, uv, ur, inv_s2, mask)
    S = _split(split, C, N)
    dev = X.device
    chi2 = torch.empty((C, N), dtype=torch.float32, device=dev)
    total = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.ba_chi2_launch(
            poses.data_ptr(), X.data_ptr(), uv.data_ptr(), ur.data_ptr(), inv_s2.data_ptr(),
            mask.data_ptr(), chi2.data_ptr(), total.data_ptr(), C, N, S,
            *(float(v) for v in intrinsics), _stream(X),
        )
    _raise_on(err, "ba_chi2")
    _count("ba_chi2")
    return chi2, total
