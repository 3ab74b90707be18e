"""K4 and K5 of the PyTorch/CUDA port against an earlier commit's, on one card.

    python3 tools/torch_ba_compare.py --parent DIR

``DIR`` holds a checkout of the earlier commit (``git archive <commit> |
tar -x -C DIR``).  The script builds that commit's
``orbslam2_tpu_torch/csrc/ba_kernels.cu`` alone into a shared library
under ``build/ba_compare/`` and this checkout's kernels as the port
builds them, then, at the local-BA windows (C = 16 x N = 1024 RGB-D,
16 x 2048 stereo, 48 x 1024 the 32+16 window), on the same seeded inputs
(``chip_smoke.ba_problem``, a seventh of the points behind the cameras):

- holds both versions' K4 (robust) and K5 outputs against the plain
  versions with ``chip_smoke``'s limits;
- times each kernel's device time per launch with the profiler
  (``chip_smoke.device_us``, median of 10 launches) in the order earlier,
  this, this, earlier, and prints the bound (``chip_smoke.ba_bounds``).

An earlier ``ba_kernels.cu`` whose launch functions take no split
argument (before the cluster split) is called without one.  Needs one
CUDA card and ``nvcc``; prints the card's name and power limit, then one
JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPES = [(16, 1024), (16, 2048), (48, 1024)]


def build_earlier(parent: Path):
    """(library, whether its launches take the split) of the earlier
    commit's ba_kernels.cu."""
    from orbslam2_tpu_torch import kernels

    src = parent / "orbslam2_tpu_torch" / "csrc" / "ba_kernels.cu"
    text = src.read_bytes()
    out = ROOT / "build" / "ba_compare" / hashlib.sha256(text).hexdigest()[:16] / "libba.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out),
                        str(src)], check=True)
    takes_split = b"int S," in text
    lib = ctypes.CDLL(str(out))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = [ci, ci, ci] if takes_split else [ci, ci]
    lib.ba_normal_equations_launch.argtypes = [vp] * 10 + ints + [cf] * 5 + [ci, vp]
    lib.ba_normal_equations_launch.restype = ci
    lib.ba_chi2_launch.argtypes = [vp] * 8 + ints + [cf] * 5 + [vp]
    lib.ba_chi2_launch.restype = ci
    return lib, takes_split


def earlier_calls(lib, takes_split, args, cam):
    """K4 (robust) and K5 of the earlier library as functions of no
    argument, each one launch into outputs allocated once."""
    import torch

    from orbslam2_tpu_torch import kernels

    poses, X, uv, ur, inv_s2, mask = args
    C, _, N = X.shape
    dev = X.device
    pack = torch.empty((C, 32, N), device=dev)
    H, b, s4 = torch.empty((C, 6, 6), device=dev), torch.empty((C, 6), device=dev), \
        torch.empty((C,), device=dev)
    chi2, s5 = torch.empty((C, N), device=dev), torch.empty((C,), device=dev)
    ins = [t.data_ptr() for t in args]
    split = [kernels.ba_split(C, N)] if takes_split else []
    intr = [float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)]
    stream = torch.cuda.current_stream().cuda_stream

    def k4():
        err = lib.ba_normal_equations_launch(
            *ins, pack.data_ptr(), H.data_ptr(), b.data_ptr(), s4.data_ptr(), C, N, *split,
            *intr, 1, stream)
        if err:
            raise RuntimeError(f"earlier K4 launch failed: CUDA error {err}")
        return H, b, pack, s4

    def k5():
        err = lib.ba_chi2_launch(*ins, chi2.data_ptr(), s5.data_ptr(), C, N, *split, *intr,
                                 stream)
        if err:
            raise RuntimeError(f"earlier K5 launch failed: CUDA error {err}")
        return chi2, s5

    return k4, k5


def check(label, k4_out, k5_out, args, cam):
    """K4 (robust) and K5 outputs against the plain versions, with
    chip_smoke's limits."""
    import torch

    from orbslam2_tpu_torch.solvers import ba_kernels as bk

    H, b, pack, s = k4_out
    Hp, bp, packp, sp = bk._ba_normal_equations_plain(*args, cam, True)
    obs, tot = k5_out
    obsp, totp = bk._ba_chi2_plain(*args, cam)
    torch.cuda.synchronize()
    errs = {"H": cs.scaled_err(H, Hp), "b": cs.scaled_err(b, bp),
            "rows": max(cs.scaled_err(pack[:, r], packp[:, r]) for r in range(29) if r != 27),
            "chi2_row": cs.chi2_err(pack[:, 27], packp[:, 27]), "sum": cs.sum_err(s, sp),
            "k5_chi2": cs.chi2_err(obs, obsp), "k5_sum": cs.sum_err(tot, totp)}
    limits = {"H": 1e-4, "b": 1e-4, "rows": 1e-4, "chi2_row": 1e-4, "sum": 1e-5,
              "k5_chi2": 1e-4, "k5_sum": 1e-5}
    bad = {k: v for k, v in errs.items() if not v < limits[k]}
    if bad:
        raise AssertionError(f"{label} differs from the plain versions: {bad}")
    return errs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the earlier commit")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs one GPU")
    card = cs.card_line()
    cs.CLOCK_HZ = cs.max_sm_clock_hz()
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.solvers import ba_kernels as bk
    from orbslam2_tpu_torch.utils.camera import make_camera

    kernels.load()
    lib, takes_split = build_earlier(opts.parent)
    cam = make_camera(517.3, 516.5, 318.6, 255.3, bf=40.0, width=640, height=480)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for C, N in SHAPES:
        args = cs.ba_problem(C, N, gen, 7)
        old4, old5 = earlier_calls(lib, takes_split, args, cam)

        def new4():
            return bk.ba_normal_equations(*args, cam, True)

        def new5():
            return bk.ba_chi2(*args, cam)

        errs_old = check("the earlier K4/K5", old4(), old5(), args, cam)
        errs_new = check("this K4/K5", new4(), new5(), args, cam)
        row = {"C": C, "N": N, "split": kernels.ba_split(C, N)}
        for name, old, new, tag in (("k4", old4, new4, "ba_normal_equations_kernel"),
                                    ("k5", old5, new5, "ba_chi2_kernel")):
            turns = [cs.device_us(fn, tag) for fn in (old, new, new, old)]
            row[f"{name}_earlier_us"] = statistics.mean([turns[0], turns[3]])
            row[f"{name}_us"] = statistics.mean([turns[1], turns[2]])
            row[f"{name}_turns_us"] = turns
        b4, b5 = cs.ba_bounds(C, N)
        row["k4_bound_us"], row["k5_bound_us"] = b4[0] * 1e3, b5[0] * 1e3
        row["errors_earlier"], row["errors"] = errs_old, errs_new
        rows.append(row)
        print(f"[compare] {card}: C={C} N={N} S={row['split']}: K4 earlier "
              f"{row['k4_earlier_us']:.2f} us, this {row['k4_us']:.2f} us (turns " +
              ", ".join(f"{t:.2f}" for t in row["k4_turns_us"]) + f"), bound "
              f"{row['k4_bound_us']:.3f} us; K5 earlier {row['k5_earlier_us']:.2f} us, this "
              f"{row['k5_us']:.2f} us (turns " + ", ".join(f"{t:.2f}" for t in row["k5_turns_us"])
              + f"), bound {row['k5_bound_us']:.3f} us", flush=True)
    print(card)
    print(json.dumps({"ba_compare": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
