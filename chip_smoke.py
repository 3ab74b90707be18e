"""GPU smoke run of the PyTorch/CUDA port (``orbslam2_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and the repository
checkout; imports nothing of JAX.  Phases, each printing a line and raising
on failure (the script then exits non-zero and prints no result):

  1. device   require a CUDA device; print the card, its power limit and
              the torch/CUDA versions
  2. build    compile the kernels from ``orbslam2_tpu_torch/csrc``
  3. K1       FAST-9 + NMS kernel against its plain version (torch.equal)
              at the eight pyramid level shapes of a 640x480 frame, on noise
              and on ragged shapes; CUDA-event medians of 20 runs
  4. K2       packed-Hamming kernel against its plain version (torch.equal)
              at the tracker's shapes and ragged ones
  5. slice    RGB-D tracking, bench settings, 24 synthetic frames on the
              card: every frame OK, ATE <= 0.02 m, launch counts, and
              frames 0-3 agree with the same run on the CPU
  6. timing   tracking frames/s (median of 3 passes after a warm pass),
              extraction ms/frame and host syncs per frame; a profiler
              window over 5 frames gives device busy time, idle share,
              launches per frame and each kernel's device time; then
              wall and device time per call of each layer of a step

The last lines are the kernel table as one JSON object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

K1_SOURCE = "orbslam2_tpu_torch/csrc/fast_nms.cu"
K1_REPLACES = "orbslam2_tpu/ops/pallas_kernels.py:162"
K2_SOURCE = "orbslam2_tpu_torch/csrc/hamming.cu"
K2_REPLACES = "orbslam2_tpu/ops/pallas_kernels.py:46"

N_FRAMES = 24
ATE_LIMIT_M = 0.02
# CPU-vs-GPU agreement on frames 0-3: the tolerance of the port's CPU
# parity test of the whole slice (tests/test_torch_slice.py).
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 20) -> float:
    """Median CUDA-event time of ``fn()`` over ``n`` runs, after a warm run."""
    import torch

    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bench_settings():
    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings

    return Settings(
        camera=CameraSettings(
            fx=517.3, fy=516.5, cx=318.6, cy=255.3,
            width=640, height=480, bf=40.0, th_depth=40.0,
        ),
        orb=OrbSettings(n_features=1000, n_levels=8),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=128, max_points=16384),
    )


def run_slice(settings, seq, device, n_frames):
    """Track ``n_frames`` frames; returns (system, states, seconds)."""
    import torch

    from orbslam2_tpu_torch.models.system import SlamSystem

    system = SlamSystem(
        settings, "rgbd", enable_mapping=False, enable_loop_closing=False, device=device,
    )
    images = [torch.as_tensor(im, device=device) for im in seq.images[:n_frames]]
    depths = [torch.as_tensor(d, device=device) for d in seq.depths[:n_frames]]
    if device == "cuda":
        torch.cuda.synchronize()
    states = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        system.track_rgbd(images[i], depths[i], float(seq.timestamps[i]))
        states.append(system.tracking_state())
    if device == "cuda":
        torch.cuda.synchronize()
    return system, states, time.perf_counter() - t0


def profile_frames(settings, seq, card, first: int = 6, n: int = 5) -> None:
    """torch.profiler over ``n`` steady frames: device busy time and idle
    share per frame, kernel launches per frame, and the device time of
    each launch of the two hand-written kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    system, _, _ = run_slice(settings, seq, "cuda", first)
    images = [torch.as_tensor(im, device="cuda") for im in seq.images[first:first + n]]
    depths = [torch.as_tensor(d, device="cuda") for d in seq.depths[first:first + n]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for im, d in zip(images, depths):
            system.track_rgbd(im, d, 0.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    per_kernel = {}
    for e in dev:
        for tag in ("fast_nms_kernel", "hamming_kernel"):
            if tag in e.name:
                per_kernel.setdefault(tag, []).append(e.time_range.elapsed_us())
    kern = ", ".join(
        f"{tag} {statistics.median(v):.2f} us/launch x {len(v) / n:.1f}/frame"
        for tag, v in sorted(per_kernel.items())
    )
    phase("profile", f"{card}: {n} frames: wall {wall_us / n / 1e3:.2f} ms/frame, "
          f"device busy {busy_us / n / 1e3:.2f} ms/frame, idle share "
          f"{1 - busy_us / wall_us:.3f}, {len(dev) / n:.0f} kernel launches/frame; {kern}")
    nxt = first + n
    layer_times(system, torch.as_tensor(seq.images[nxt], device="cuda"),
                torch.as_tensor(seq.depths[nxt], device="cuda"), card)


def layer_times(system, image, depth, card: str, n: int = 10) -> None:
    """Wall time (host clock around ``n`` calls, then a synchronize),
    device time and launches per call of each layer of one tracking step,
    on the tracker's current state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orbslam2_tpu_torch.models import tracking as T
    from orbslam2_tpu_torch.models.frame import build_rgbd_frame
    from orbslam2_tpu_torch.models.map_state import update_point_stats
    from orbslam2_tpu_torch.solvers.pose_opt import pose_optimization

    tr = system.tracker
    frame = build_rgbd_frame(image, depth, tr.extractor, tr.cam)
    ctx = tr._make_ctx()

    def motion():
        return T.track_motion_model(
            tr.map, frame, ctx.velocity @ ctx.T_last, ctx.last_xy, ctx.last_bindings,
            ctx.last_level, tr.cam, tr.scale_factors, tr.inv_sigma2, 7.0,
            T_last=ctx.T_last, last_angle=ctx.last_angle, baseline=tr.cam.baseline)

    T_m, b_m, *_ = motion()
    ids, valid = T.gather_local_points(tr.map, b_m, n_local_kfs=tr.settings.tpu.local_window)
    obs = T._pose_obs_from_bindings(tr.map, frame, b_m, tr.inv_sigma2)

    def keyframe():
        pos, ok = T.unproject_frame_depth(frame, T_m, tr.cam)
        m, pids = T.add_points(tr.map, pos, frame.desc, ok & (b_m < 0), tr.map.n_kf,
                               reverse=True)
        m, _ = T.insert_keyframe(m, frame, T_m, tr.frame_id, torch.where(pids >= 0, pids, b_m),
                                 tr.ref_kf)
        return update_point_stats(m, tr.scale_factors)

    layers = [
        ("extract (pyramid, K1, select, ORB)", lambda: tr.extractor(image)),
        ("track_motion_model (K2, pose opt)", motion),
        ("gather_local_points", lambda: T.gather_local_points(
            tr.map, b_m, n_local_kfs=tr.settings.tpu.local_window)),
        ("track_local_map (K2, pose opt)", lambda: T.track_local_map(
            tr.map, frame, T_m, b_m, ids, valid, tr.cam, tr.scale_factors, tr.inv_sigma2)),
        ("pose_optimization alone", lambda: pose_optimization(T_m, obs, tr.cam)),
        ("keyframe insertion", keyframe),
    ]
    for name, fn in layers:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        phase("layer", f"{card}: {name}: wall {wall_ms:.3f} ms/call, device {dev_ms:.3f} "
              f"ms/call, {len(dev)} launches/call")


def rot_angle(R) -> float:
    import numpy as np

    c = (np.trace(R) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def main() -> int:
    import numpy as np
    import torch

    # 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one GPU")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | torch {torch.__version__} | CUDA {torch.version.cuda} | {kind}")

    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.ops import fast, hamming
    from orbslam2_tpu_torch.ops import pyramid as pyr_ops
    from orbslam2_tpu_torch.utils import synthetic

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load()
    phase("build", f"{time.perf_counter() - t0:.2f} s -> {lib_path}")

    settings = bench_settings()
    cam = settings.camera_model()
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(
        cam, n_frames=N_FRAMES, n_points=1500, with_depth=True, seed=0,
        radius=0.25, forward=0.5,
    )
    phase("data", f"{N_FRAMES} frames rendered in {time.perf_counter() - t0:.2f} s")

    # 3. K1 against plain ---------------------------------------------------
    frame0 = torch.as_tensor(seq.images[0], device="cuda")
    levels = pyr_ops.build_pyramid(frame0, settings.orb.n_levels, settings.orb.scale_factor)
    gen = torch.Generator(device="cpu").manual_seed(0)
    k1_inputs = [(f"level{i}", lv.contiguous()) for i, lv in enumerate(levels)]
    k1_inputs += [
        ("noise", (torch.rand(480, 640, generator=gen) * 255).cuda()),
        ("noise_int", torch.randint(0, 256, (480, 640), generator=gen).float().cuda()),
        ("ragged", (torch.rand(33, 129, generator=gen) * 255).cuda()),
        ("tiny", (torch.rand(7, 7, generator=gen) * 255).cuda()),
    ]
    k1_err = 0.0
    k1_ms = k1_plain_ms = 0.0
    for name, x in k1_inputs:
        got = fast.fast_score_nms(x)
        want = fast.nms3x3(fast.fast_score(x))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K1 differs from plain at {name} {tuple(x.shape)}: "
                f"{int((got != want).sum())} pixels"
            )
        k1_err = max(k1_err, float((got - want).abs().max()))
        ms = time_ms(lambda: fast.fast_score_nms(x))
        plain_ms = time_ms(lambda: fast.nms3x3(fast.fast_score(x)))
        if name.startswith("level"):
            k1_ms += ms
            k1_plain_ms += plain_ms
        phase("K1", f"{name} {tuple(x.shape)} equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    phase("K1", f"8 levels of a frame: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")

    # 4. K2 against plain ---------------------------------------------------
    def rand_desc(n):
        return torch.randint(-2**31, 2**31, (n, 8), generator=gen, dtype=torch.int64).to(
            torch.int32).cuda()

    k2_err = 0.0
    k2_ms = k2_plain_ms = None
    for na, nb in [(1024, 1024), (4096, 1024), (1000, 777), (1, 1)]:
        a, b = rand_desc(na), rand_desc(nb)
        got = hamming.hamming_matrix(a, b)
        want = hamming._hamming_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from plain at {na}x{nb}")
        k2_err = max(k2_err, float((got - want).abs().max()))
        ms = time_ms(lambda: hamming.hamming_matrix(a, b))
        plain_ms = time_ms(lambda: hamming._hamming_plain(a, b))
        if (na, nb) == (4096, 1024):
            k2_ms, k2_plain_ms = ms, plain_ms
        phase("K2", f"{na}x{nb} equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # 5. the slice on the card ----------------------------------------------
    kernels.reset_launch_counts()
    system, states, secs = run_slice(settings, seq, "cuda", N_FRAMES)
    launches = dict(kernels.LAUNCHES)
    poses = system.poses_wc()
    if not np.isfinite(poses).all() or poses.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"bad trajectory: shape {poses.shape}")
    ate = synthetic.ate_rmse(poses, seq.poses_wc)
    n_ok = sum(s == 1 for s in states)
    metrics = system.metrics()
    phase("slice", f"{n_ok}/{N_FRAMES} frames OK, ATE {ate:.6f} m, "
          f"keyframes {metrics['keyframes_created'] + 1}, launches {launches}")
    if n_ok != N_FRAMES:
        raise AssertionError(f"frames not OK: {states}")
    if not ate <= ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m > {ATE_LIMIT_M} m")
    if launches["fast_score_nms"] != settings.orb.n_levels * N_FRAMES:
        raise AssertionError(f"K1 launched {launches['fast_score_nms']} times")
    if launches["hamming_matrix"] < 2 * (N_FRAMES - 1):
        raise AssertionError(f"K2 launched {launches['hamming_matrix']} times")

    n_cpu = 4
    cpu_sys, cpu_states, _ = run_slice(settings, seq, "cpu", n_cpu)
    cpu_poses = cpu_sys.poses_wc()
    if cpu_states != states[:n_cpu]:
        raise AssertionError(f"CPU states {cpu_states} != GPU states {states[:n_cpu]}")
    dt = np.abs(cpu_poses[:, :3, 3] - poses[:n_cpu, :3, 3]).max()
    dr = max(rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(cpu_poses, poses[:n_cpu]))
    phase("slice", f"frames 0-{n_cpu - 1} CPU vs GPU: states equal, "
          f"max |dt| {dt:.3e} m, max rotation {dr:.3e} rad")
    if dt > POSE_TOL_M or dr > POSE_TOL_RAD:
        raise AssertionError("CPU and GPU poses disagree")

    # 6. timing -------------------------------------------------------------
    run_slice(settings, seq, "cuda", N_FRAMES)  # warm pass
    passes = [run_slice(settings, seq, "cuda", N_FRAMES) for _ in range(3)]
    fps = statistics.median(N_FRAMES / p[2] for p in passes)
    syncs = passes[0][0].metrics()["host_syncs"] / N_FRAMES
    ext = system.tracker.extractor
    images = [torch.as_tensor(im, device="cuda") for im in seq.images]
    ext(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for im in images:
        ext(im)
    torch.cuda.synchronize()
    extract_ms = (time.perf_counter() - t0) / len(images) * 1e3
    phase("timing", f"{card}: tracking {fps:.2f} frames/s (median of 3 passes of "
          f"{N_FRAMES}), extraction {extract_ms:.3f} ms/frame, "
          f"{syncs:.2f} host syncs/frame")
    profile_frames(settings, seq, card)

    print(json.dumps({"kernels": [
        {"name": "fast_score_nms", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["fast_score_nms"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "hamming_matrix", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["hamming_matrix"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
