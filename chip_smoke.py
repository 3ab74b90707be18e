"""GPU smoke run of the PyTorch/CUDA port (``orbslam2_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and the repository
checkout; imports nothing of JAX.  Phases, each printing a line and raising
on failure (the script then exits non-zero and prints no result):

  1. device   require a CUDA device; print the card, its power limit and
              the torch/CUDA versions
  2. build    compile the kernels from ``orbslam2_tpu_torch/csrc`` (one
              nvcc per source, all at once)
  3. K1       FAST-9 + NMS kernel against its plain version (torch.equal)
              at the eight pyramid level shapes of a 640x480 frame, on noise
              and on ragged shapes; CUDA-event medians of 20 runs
  4. K2       packed-Hamming kernel against its plain version (torch.equal)
              at the tracker's shapes and ragged ones
  5. K4/K5    bundle-adjustment kernels against their plain versions at the
              local-BA windows (C = 48 and 16 cameras x N = 1024) and a
              ragged shape (3 x 77), robust weights both ways, with a
              seventh of the points behind the cameras and with none:
              blocks and pack rows plane-scaled within 1e-4, chi2 equal at
              the 1e9 sentinels and within 1e-4 relative elsewhere, sums
              within 1e-5 relative
  6. slice    RGB-D tracking with mapping off, bench settings, 24 synthetic
              frames on the card: every frame OK, ATE <= 0.02 m, launch
              counts, and frames 0-3 agree with the same run on the CPU
  7. mapping  the main path, ``SlamSystem(enable_mapping=True)``, on the
              same frames: every frame OK, ATE within ATE_LIMIT_MAPPING_M,
              K1 8 x 24 launches, K2 more than with mapping off, K4 15 and
              K5 19 per keyframe created; tracking agrees with the CPU
              through the frame after the first keyframe, and each mapping
              pass, run again on the CPU from the card's input map, gives
              the same map within MAP_TOL
  8. timing   with mapping off and on: frames/s, extraction ms/frame, host
              syncs per frame (and per keyframe), mapping ms per keyframe,
              local-BA LM iterations/s at 32+16 cameras, profiler windows
              (device busy, idle share, launches per frame, each kernel's
              device time per launch), wall and device time per call of
              each layer of a tracking step, and per pass of each stage of
              mapping (its profiler ranges)

Each path's launch counts are set to 0 just before it runs and read just
after.  The last lines are the kernel table as one JSON object, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

K1_SOURCE = "orbslam2_tpu_torch/csrc/fast_nms.cu"
K1_REPLACES = "orbslam2_tpu/ops/pallas_kernels.py:162"
K2_SOURCE = "orbslam2_tpu_torch/csrc/hamming.cu"
K2_REPLACES = "orbslam2_tpu/ops/pallas_kernels.py:46"
BA_SOURCE = "orbslam2_tpu_torch/csrc/ba_kernels.cu"
K4_REPLACES = "orbslam2_tpu/solvers/ba_kernels.py:196"
K5_REPLACES = "orbslam2_tpu/solvers/ba_kernels.py:243"

N_FRAMES = 24
ATE_LIMIT_M = 0.02
# The JAX reference (Tracker with LocalMapper, loop closing off) on this
# sequence and these settings reaches 0.01215325204529769 m, all 24 frames
# OK, 4 keyframes created (tests/torch_reference_ate.py, run on the CPU).
# The port's mapping slice matches the reference within 1e-3 m of ATE on
# the CPU (tests/test_torch_mapping_slice.py); the card sums in other
# orders, so the limit leaves three times that.
ATE_REF_MAPPING_M = 0.01215325204529769
ATE_LIMIT_MAPPING_M = ATE_REF_MAPPING_M + 0.003
# CPU-vs-GPU agreement of tracked poses (frames 0-3 with mapping off; with
# mapping on, through the frame after the first keyframe): the tolerance
# of the port's CPU parity test of the whole slice (tests/test_torch_slice.py).
N_CPU = 4
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3
# CPU-vs-GPU agreement of each mapping pass, (atol, rtol) per float field;
# every other field equal: the tolerances of the port's CPU parity test of
# process_keyframe (tests/test_torch_local_mapping.py).
MAP_TOL = {"kf_pose_cw": (1e-4, 0.0), "pt_pos": (1e-3, 1e-3), "pt_normal": (1e-5, 0.0),
           "pt_min_dist": (1e-5, 1e-5), "pt_max_dist": (1e-5, 1e-5)}

# Least-time bounds (H100 SXM data sheet): HBM at 3.35 TB/s, float32
# outside the tensor cores at 67 TFLOP/s (an FMA counts two).  Operations
# per element, counting each add, multiply, min, max, compare, select,
# divide and square root as one, from the kernels' sources:
#   K1  16 differences, 16 arcs x (1 negation + 8 x (2 min + 1 negation)
#       + 2 max), a clamp, 8 NMS compares and 4 flag tests: 460 per pixel
#   K2  8 x (XOR + popcount + add): 24 per pair
#   K4  projection and residual ~40, weight ~9, Jacobian rows ~45, H_pp 36,
#       b_p 18, G 108, H_cc 147, b_c 42, chi2 sum 2: 450 per observation
#   K5  projection and residual ~40, chi2 sum 2: 42 per observation
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_PX = 460
K2_OPS_PER_PAIR = 24
K4_OPS_PER_OBS = 450
K5_OPS_PER_OBS = 42


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of the memory and the arithmetic
    time."""
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


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


def make_system(settings, device, mapping):
    from orbslam2_tpu_torch.models.system import SlamSystem

    return SlamSystem(settings, "rgbd", enable_mapping=mapping, enable_loop_closing=False,
                      device=device)


def drive(system, seq, device, frames, on_frame=None, keep_poses=0):
    """Track ``frames`` of ``seq``; returns (states, seconds, poses): the
    world-to-camera pose of each of the first ``keep_poses`` frames as
    tracked (later mapping may still move the keyframes it is relative
    to).  ``on_frame(i, before)`` is called around each frame."""
    import torch

    images = [torch.as_tensor(seq.images[i], device=device) for i in frames]
    depths = [torch.as_tensor(seq.depths[i], device=device) for i in frames]
    if device == "cuda":
        torch.cuda.synchronize()
    states, poses = [], []
    t0 = time.perf_counter()
    for k, i in enumerate(frames):
        if on_frame:
            on_frame(i, True)
        system.track_rgbd(images[k], depths[k], float(seq.timestamps[i]))
        if on_frame:
            on_frame(i, False)
        states.append(system.tracking_state())
        if k < keep_poses:
            poses.append(system.tracker.last_T.cpu().numpy())
    if device == "cuda":
        torch.cuda.synchronize()
    return states, time.perf_counter() - t0, poses


def run_slice(settings, seq, device, n_frames, mapping=False, keep_poses=0):
    """Track ``n_frames`` frames; returns (system, states, seconds, poses)."""
    system = make_system(settings, device, mapping)
    return (system, *drive(system, seq, device, range(n_frames), keep_poses=keep_poses))


def rot_angle(R) -> float:
    import numpy as np

    c = (np.trace(R) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def compare_with_cpu(settings, seq, poses_cw, states, mapping):
    """The first len(poses_cw) frames of the same run on the CPU: equal
    states, tracked poses within POSE_TOL_M / POSE_TOL_RAD."""
    import numpy as np

    n = len(poses_cw)
    cpu_sys, cpu_states, _, cpu_poses = run_slice(settings, seq, "cpu", n, mapping=mapping,
                                                  keep_poses=n)
    if cpu_states != states[:n]:
        raise AssertionError(f"CPU states {cpu_states} != GPU states {states[:n]}")
    a = np.linalg.inv(np.stack(cpu_poses))
    b = np.linalg.inv(np.stack(poses_cw))
    dt = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
    dr = max(rot_angle(x[:3, :3].T @ y[:3, :3]) for x, y in zip(a, b))
    if dt > POSE_TOL_M or dr > POSE_TOL_RAD:
        raise AssertionError(f"CPU and GPU poses disagree: {dt} m, {dr} rad")
    return dt, dr, cpu_sys.tracker.metrics["keyframes_created"]


# -- K4 / K5 ------------------------------------------------------------------


def ba_problem(C, N, gen, behind_every):
    """A seeded bundle-adjustment problem on the card, in the kernels'
    N-minor layout: poses near the identity, points 3-7 m ahead with every
    ``behind_every``-th behind the cameras (none for 0), half the
    observations stereo."""
    import torch

    def rnd(*shape):
        return torch.rand(*shape, generator=gen)

    poses = torch.eye(4).repeat(C, 1, 1)
    poses[:, :3, 3] = (rnd(C, 3) - 0.5) * 0.2
    X = torch.stack([(rnd(C, N) - 0.5) * 4, (rnd(C, N) - 0.5) * 3, 3 + 4 * rnd(C, N)], 1)
    if behind_every:
        X[:, 2, ::behind_every] = -2.0
    uv = torch.stack([rnd(C, N) * 640, rnd(C, N) * 480], 1)
    ur = torch.where(rnd(C, N) < 0.5, uv[:, 0] - 40 * rnd(C, N), torch.full((C, N), -1.0))
    inv_s2 = rnd(C, N) + 0.5
    mask = rnd(C, N) < 0.9
    return [t.contiguous().cuda() for t in (poses, X, uv, ur, inv_s2, mask)]


def scaled_err(a, b) -> float:
    """max |a - b| / max(max |b|, 1): the tests' plane-scaled error."""
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def chi2_err(a, b) -> float:
    """Per-observation chi2 against its plain version: inf unless equal
    wherever the plain value is the 1e9 sentinel, else the largest
    |a - b| / (|b| + 1) over the other observations."""
    import torch

    sentinel = b == 1e9
    if not torch.equal(a[sentinel], b[sentinel]):
        return float("inf")
    return float(torch.where(sentinel, 0.0, (a - b).abs() / (b.abs() + 1.0)).max())


def sum_err(a, b) -> float:
    """Per-camera chi2 sums: the largest |a - b| / max(|b|, 1)."""
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def check_ba(cam, C, N, gen):
    """K4 and K5 against their plain versions at (C, N), on a problem with a
    seventh of the points behind the cameras and on one with none, where
    the per-camera sums hold only real residuals and their 1e-5 relative
    limit is about them.  Returns the problem with sentinels and the
    largest absolute error of K4's blocks and pack and of K5's chi2."""
    import torch

    from orbslam2_tpu_torch.solvers import ba_kernels as bk

    k4_abs = k5_abs = 0.0
    problems = {behind_every: ba_problem(C, N, gen, behind_every) for behind_every in (7, 0)}
    for behind_every, args in problems.items():
        for robust in (True, False):
            H, b, pack, s = bk.ba_normal_equations(*args, cam, robust)
            Hp, bp, packp, sp = bk._ba_normal_equations_plain(*args, cam, robust)
            torch.cuda.synchronize()
            errs = {"H": scaled_err(H, Hp), "b": scaled_err(b, bp)}
            errs["rows"] = max(scaled_err(pack[:, r], packp[:, r]) for r in range(29) if r != 27)
            errs["chi2_row"] = chi2_err(pack[:, 27], packp[:, 27])
            errs["sum"] = sum_err(s, sp)
            bad = [errs["H"] >= 1e-4, errs["b"] >= 1e-4, errs["rows"] >= 1e-4,
                   errs["chi2_row"] >= 1e-4, errs["sum"] >= 1e-5,
                   not torch.equal(H, H.transpose(1, 2)), bool((pack[:, 29:] != 0).any())]
            if any(bad):
                raise AssertionError(f"K4 differs from plain at C={C} N={N} "
                                     f"behind_every={behind_every} robust={robust}: {errs}")
            k4_abs = max(k4_abs, float((H - Hp).abs().max()), float((b - bp).abs().max()),
                         float((pack - packp).abs().max()))
            phase("K4", f"C={C} N={N} behind_every={behind_every} robust={robust}: errors " +
                  ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        obs, tot = bk.ba_chi2(*args, cam)
        obsp, totp = bk._ba_chi2_plain(*args, cam)
        torch.cuda.synchronize()
        e_obs, e_sum = chi2_err(obs, obsp), sum_err(tot, totp)
        if e_obs >= 1e-4 or e_sum >= 1e-5:
            raise AssertionError(f"K5 differs from plain at C={C} N={N} "
                                 f"behind_every={behind_every}: {e_obs}, {e_sum}")
        sentinels = int(((obsp == 1e9) & args[5]).sum())
        phase("K5", f"C={C} N={N} behind_every={behind_every}: chi2 {e_obs:.3e}, sums "
              f"{e_sum:.3e} (relative), {sentinels} masked sentinels")
        k5_abs = max(k5_abs, float((obs - obsp).abs().max()))
    return problems[7], k4_abs, k5_abs


def ba_bounds(C, N):
    """(K4 bound, K5 bound) at (C, N): inputs X, uv, ur, inv_s2 float32 and
    the mask byte per observation plus the poses; K4 writes the 32-row pack
    and the per-camera blocks, K5 a chi2 per observation and the sums."""
    obs = C * N
    read = obs * (3 + 2 + 1 + 1) * 4 + obs + C * 16 * 4
    k4 = bound(read + obs * 32 * 4 + C * (36 + 6 + 1) * 4, obs * K4_OPS_PER_OBS)
    k5 = bound(read + obs * 4 + C * 4, obs * K5_OPS_PER_OBS)
    return k4, k5


# -- profiling ------------------------------------------------------------------

KERNEL_TAGS = ("fast_nms_kernel", "hamming_kernel", "ba_normal_equations_kernel",
               "ba_chi2_kernel")


def device_ops(prof):
    """The device operations of a profile (kernels, copies, fills), without
    the device-side spans of named ranges."""
    import torch

    from orbslam2_tpu_torch.models.local_mapping import STAGE_PREFIX

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(STAGE_PREFIX)]


def profile_window(system, seq, frames, card, label):
    """torch.profiler over ``frames`` of a running system: device busy time
    and idle share per frame, kernel launches per frame, and the device time
    of each launch of the hand-written kernels.  Returns (the median device
    us per launch of each hand-written kernel, the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    images = [torch.as_tensor(seq.images[i], device="cuda") for i in frames]
    depths = [torch.as_tensor(seq.depths[i], device="cuda") for i in frames]
    kc0 = system.tracker.metrics["keyframes_created"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for im, d in zip(images, depths):
            system.track_rgbd(im, d, 0.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(frames)
    dev = device_ops(prof)
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    per_kernel = {}
    for e in dev:
        for tag in KERNEL_TAGS:
            if tag in e.name:
                per_kernel.setdefault(tag, []).append(e.time_range.elapsed_us())
    kern = ", ".join(
        f"{tag} {statistics.median(v):.2f} us/launch x {len(v) / n:.1f}/frame"
        for tag, v in sorted(per_kernel.items())
    )
    kc = system.tracker.metrics["keyframes_created"] - kc0
    phase("profile", f"{card}: {label}: {n} frames ({kc} keyframes): wall "
          f"{wall_us / n / 1e3:.2f} ms/frame, device busy {busy_us / n / 1e3:.2f} ms/frame, "
          f"idle share {1 - busy_us / wall_us:.3f}, {len(dev) / n:.0f} kernel launches/frame; "
          f"{kern}")
    return {tag: statistics.median(v) for tag, v in per_kernel.items()}, prof


def mapping_stage_lines(prof, card: str) -> None:
    """[layer] lines for the stages of the mapping passes in a profile (the
    named ranges of LocalMapper.process_keyframe): host time under the
    profiler, device time, device operations and launches of the hand-
    written kernels, per pass.  The profiler links each PyTorch operation's
    device work to the operation, hence to its range; the hand-written
    kernels, launched through ctypes, are linked to none, and count for the
    range in whose host time they start (the device idles most of the
    time, so a kernel starts microseconds after its launch)."""
    import torch

    from orbslam2_tpu_torch.models.local_mapping import STAGE_PREFIX

    def own(name):
        return next((tag for tag in KERNEL_TAGS if tag in name), None)

    def ops(e):
        mine = [k.duration for k in e.kernels
                if not k.name.startswith(STAGE_PREFIX) and not own(k.name)]
        return mine + [d for ch in e.cpu_children for d in ops(ch)]

    hand_written = [e for e in device_ops(prof) if own(e.name)]
    stages = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(STAGE_PREFIX):
            stages.setdefault(e.name[len(STAGE_PREFIX):], []).append(e)
    if not stages:
        raise AssertionError("the profile window holds no mapping pass")
    totals = [0.0, 0.0, 0]
    for name, events in stages.items():
        n = len(events)
        wall_ms = sum(e.time_range.elapsed_us() for e in events) / n / 1e3
        linked = [d for e in events for d in ops(e)]
        started = [k for k in hand_written for e in events
                   if e.time_range.start <= k.time_range.start <= e.time_range.end]
        k = linked + [s.time_range.elapsed_us() for s in started]
        dev_ms = sum(k) / n / 1e3
        own_counts = collections.Counter(own(s.name) for s in started)
        totals = [totals[0] + wall_ms, totals[1] + dev_ms, totals[2] + len(k) / n]
        phase("layer", f"{card}: mapping stage {name}: wall {wall_ms:.3f} ms/pass, device "
              f"{dev_ms:.3f} ms/pass, {len(k) / n:.0f} device operations/pass, hand-written "
              f"kernels {dict(own_counts)} in {n} passes")
    phase("layer", f"{card}: mapping stages together: wall {totals[0]:.3f} ms/pass, device "
          f"{totals[1]:.3f} ms/pass, {totals[2]:.0f} device operations/pass")


def time_layers(layers, card: str, n: int) -> None:
    """Wall time (host clock around ``n`` calls, then a synchronize),
    device time and launches per call of each layer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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


def tracking_layers(system, image, depth):
    """The layers of one tracking step on the tracker's current state."""
    import torch

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

    return [
        ("extract (pyramid, K1, select, ORB)", lambda: tr.extractor(image)),
        ("track_motion_model (K2, pose opt)", motion),
        ("gather_local_points", lambda: T.gather_local_points(
            tr.map, b_m, n_local_kfs=tr.settings.tpu.local_window)),
        ("track_local_map (K2, pose opt)", lambda: T.track_local_map(
            tr.map, frame, T_m, b_m, ids, valid, tr.cam, tr.scale_factors, tr.inv_sigma2)),
        ("pose_optimization alone", lambda: pose_optimization(T_m, obs, tr.cam)),
        ("keyframe insertion", keyframe),
    ]


def compare_mapping_passes(mapper, passes):
    """Each mapping pass of the card's run again on the CPU, from the same
    input map: integer and boolean fields equal, floats within MAP_TOL
    (the tolerances of tests/test_torch_local_mapping.py's whole
    process_keyframe, port against reference).  Returns (the largest
    difference of each float field, the largest move of a keyframe pose
    entry in the CPU passes)."""
    import torch

    from orbslam2_tpu_torch.models.map_state import MapState

    worst = dict.fromkeys(MAP_TOL, 0.0)
    moved = 0.0
    for m_in, kf_id, n_now, out in passes:
        m_cpu = MapState(*(t.cpu() for t in m_in))
        ref = mapper.process_keyframe(m_cpu, kf_id, n_now)
        for f in MapState._fields:
            a, b = getattr(out, f).cpu(), getattr(ref, f)
            if f in MAP_TOL:
                atol, rtol = MAP_TOL[f]
                excess = float(((a - b).abs() - atol - rtol * b.abs()).max())
                worst[f] = max(worst[f], float((a - b).abs().max()))
                if excess > 0:
                    raise AssertionError(f"mapping pass on keyframe {kf_id}: {f} differs "
                                         f"from the CPU by {worst[f]}")
            elif not torch.equal(a, b):
                raise AssertionError(f"mapping pass on keyframe {kf_id}: {f} differs from the "
                                     f"CPU in {int((a != b).sum())} entries")
        valid = ref.kf_valid
        moved = max(moved, float((ref.kf_pose_cw - m_cpu.kf_pose_cw)[valid].abs().max()))
    return worst, moved


def ba_iterations_per_sec(system, card: str) -> float:
    """bench.py's measurement: the local-BA window of 32 free + 16 fixed
    cameras around the newest keyframe of the map, one warm call, then 5
    calls of 5 + 10 LM iterations on the host clock."""
    import torch

    from orbslam2_tpu_torch.solvers.local_ba import local_bundle_adjustment

    m = system.map
    mapper = system.local_mapper
    tpu = system.settings.tpu
    kf = int(m.n_kf) - 1
    kw = dict(n_local=tpu.ba_local_window, n_fixed=tpu.ba_fixed_window, phase_iters=(5, 10))
    inv_s2 = mapper.tables("cuda")[2]
    out = local_bundle_adjustment(m, kf, mapper.cam, inv_s2, **kw)
    torch.cuda.synchronize()
    n_calls = 5
    t0 = time.perf_counter()
    for _ in range(n_calls):
        out = local_bundle_adjustment(m, kf, mapper.cam, inv_s2, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(out.kf_pose_cw).all():
        raise AssertionError("local BA at 32+16 gave non-finite poses")
    ips = n_calls * 15 / dt
    phase("timing", f"{card}: local BA {tpu.ba_local_window}+{tpu.ba_fixed_window} cameras "
          f"on the slice's map ({int(m.kf_valid.sum())} keyframes): {ips:.1f} LM "
          f"iterations/s ({dt / n_calls * 1e3:.1f} ms per call of 15)")
    return ips


def main() -> int:
    import numpy as np
    import torch

    t_start = time.perf_counter()
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
    k1_px = sum(lv.numel() for lv in levels)
    k1_bound = bound(k1_px * 8, k1_px * K1_OPS_PER_PX)
    phase("K1", f"8 levels of a frame ({k1_px} px): kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms, bound {k1_bound[0]:.5f} ms ({k1_bound[1]})")

    # 4. K2 against plain ---------------------------------------------------
    def rand_desc(n):
        return torch.randint(-2**31, 2**31, (n, 8), generator=gen, dtype=torch.int64).to(
            torch.int32).cuda()

    k2_err = 0.0
    k2_ms = k2_plain_ms = None
    k2_shape = (4096, 1024)
    for na, nb in [(1024, 1024), k2_shape, (1000, 777), (1, 1)]:
        a, b = rand_desc(na), rand_desc(nb)
        got = hamming.hamming_matrix(a, b)
        want = hamming._hamming_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from plain at {na}x{nb}")
        k2_err = max(k2_err, float((got - want).abs().max()))
        ms = time_ms(lambda: hamming.hamming_matrix(a, b))
        plain_ms = time_ms(lambda: hamming._hamming_plain(a, b))
        if (na, nb) == k2_shape:
            k2_ms, k2_plain_ms = ms, plain_ms
        phase("K2", f"{na}x{nb} equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    na, nb = k2_shape
    k2_bound = bound((na + nb) * 32 + na * nb * 4, na * nb * K2_OPS_PER_PAIR)
    phase("K2", f"bound at {na}x{nb}: {k2_bound[0]:.5f} ms ({k2_bound[1]})")

    # 5. K4 / K5 against plain -------------------------------------------------
    from orbslam2_tpu_torch.solvers import ba_kernels as bk

    k4_err = k5_err = 0.0
    ba_times = {}
    for C, N in [(48, 1024), (16, 1024), (3, 77)]:
        args, e4, e5 = check_ba(cam, C, N, gen)
        k4_err, k5_err = max(k4_err, e4), max(k5_err, e5)
        if N == 1024:
            t = (time_ms(lambda: bk.ba_normal_equations(*args, cam, True)),
                 time_ms(lambda: bk._ba_normal_equations_plain(*args, cam, True)),
                 time_ms(lambda: bk.ba_chi2(*args, cam)),
                 time_ms(lambda: bk._ba_chi2_plain(*args, cam)))
            ba_times[C] = t
            b4, b5 = ba_bounds(C, N)
            phase("K4/K5", f"C={C} N={N}: K4 kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound "
                  f"{b4[0]:.5f} ms ({b4[1]}); K5 kernel {t[2]:.4f} ms, plain {t[3]:.4f} ms, "
                  f"bound {b5[0]:.5f} ms ({b5[1]})")

    # 6. the slice with mapping off -------------------------------------------
    kernels.reset_launch_counts()
    system, states, _, first_poses = run_slice(settings, seq, "cuda", N_FRAMES,
                                               keep_poses=N_CPU)
    launches_off = dict(kernels.LAUNCHES)
    poses = system.poses_wc()
    if not np.isfinite(poses).all() or poses.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"bad trajectory: shape {poses.shape}")
    ate = synthetic.ate_rmse(poses, seq.poses_wc)
    n_ok = sum(s == 1 for s in states)
    metrics = system.metrics()
    phase("slice", f"mapping off: {n_ok}/{N_FRAMES} frames OK, ATE {ate:.6f} m, "
          f"keyframes {metrics['keyframes_created'] + 1}, launches {launches_off}")
    if n_ok != N_FRAMES:
        raise AssertionError(f"frames not OK: {states}")
    if not ate <= ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m > {ATE_LIMIT_M} m")
    if launches_off["fast_score_nms"] != settings.orb.n_levels * N_FRAMES:
        raise AssertionError(f"K1 launched {launches_off['fast_score_nms']} times")
    if launches_off["hamming_matrix"] < 2 * (N_FRAMES - 1):
        raise AssertionError(f"K2 launched {launches_off['hamming_matrix']} times")
    if launches_off["ba_normal_equations"] or launches_off["ba_chi2"]:
        raise AssertionError("the mapping-off slice launched a BA kernel")
    dt, dr, _ = compare_with_cpu(settings, seq, first_poses, states, mapping=False)
    phase("slice", f"frames 0-3 CPU vs GPU: states equal, max |dt| {dt:.3e} m, "
          f"max rotation {dr:.3e} rad")

    # 7. the main path: mapping on ---------------------------------------------
    syncs = []
    caught = []

    def count_syncs(i, before):
        if before:
            count_syncs.n0 = len(caught)
        else:
            syncs.append(len(caught) - count_syncs.n0)

    msystem = make_system(settings, "cuda", mapping=True)
    kc_log = []
    passes = []  # (input map, kf_id, n_now, output map) of each mapping pass
    process_keyframe = msystem.local_mapper.process_keyframe

    def recorded_process(m, kf_id, n_now=None):
        out = process_keyframe(m, kf_id, n_now)
        passes.append((m, kf_id, n_now, out))
        return out

    msystem.local_mapper.process_keyframe = recorded_process
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")

            def on_frame(i, before):
                count_syncs(i, before)
                if not before:
                    kc_log.append(msystem.tracker.metrics["keyframes_created"])

            mstates, _, mposes_cw = drive(msystem, seq, "cuda", range(N_FRAMES), on_frame,
                                          keep_poses=N_FRAMES)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(kernels.LAUNCHES)
    del msystem.local_mapper.process_keyframe
    other = [str(w.message) for w in caught if "synchroniz" not in str(w.message)]
    if other:
        phase("mapping", f"other warnings: {sorted(set(other))[:3]}")
    root = os.path.dirname(os.path.abspath(__file__))
    sync_sites = collections.Counter(
        f"{os.path.relpath(w.filename, root)}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))
    mposes = msystem.poses_wc()
    if not np.isfinite(mposes).all() or mposes.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"bad trajectory with mapping: shape {mposes.shape}")
    m_ate = synthetic.ate_rmse(mposes, seq.poses_wc)
    kc = msystem.tracker.metrics["keyframes_created"]
    m_ok = sum(s == 1 for s in mstates)
    mmetrics = msystem.metrics()
    phase("mapping", f"{m_ok}/{N_FRAMES} frames OK, ATE {m_ate:.6f} m (reference "
          f"{ATE_REF_MAPPING_M:.6f} m, limit {ATE_LIMIT_MAPPING_M:.6f} m), {kc} keyframes "
          f"created, {mmetrics['n_keyframes']} valid, {mmetrics['n_points']} points, "
          f"launches {launches}")
    if m_ok != N_FRAMES:
        raise AssertionError(f"frames not OK with mapping: {mstates}")
    if not m_ate <= ATE_LIMIT_MAPPING_M:
        raise AssertionError(f"ATE with mapping {m_ate} m > {ATE_LIMIT_MAPPING_M} m")
    if kc < 1:
        raise AssertionError("the mapping slice created no keyframe")
    if launches["fast_score_nms"] != settings.orb.n_levels * N_FRAMES:
        raise AssertionError(f"K1 launched {launches['fast_score_nms']} times with mapping")
    if launches["hamming_matrix"] <= launches_off["hamming_matrix"]:
        raise AssertionError(f"K2 launched {launches['hamming_matrix']} times with mapping, "
                             f"{launches_off['hamming_matrix']} without")
    if launches["ba_normal_equations"] != 15 * kc or launches["ba_chi2"] != 19 * kc:
        raise AssertionError(f"K4/K5 launched {launches['ba_normal_equations']} / "
                             f"{launches['ba_chi2']} times for {kc} keyframes")
    if len(passes) != kc:
        raise AssertionError(f"{len(passes)} mapping passes for {kc} keyframes")
    # Tracking on the CPU through the frame after the first keyframe, whose
    # pose is tracked against the map of the first mapping pass.
    n_cmp = min(next(i for i, n in enumerate(kc_log) if n) + 2, N_FRAMES)
    dt, dr, cpu_kc = compare_with_cpu(settings, seq, mposes_cw[:n_cmp], mstates, mapping=True)
    if cpu_kc < 1:
        raise AssertionError(f"the CPU run of frames 0-{n_cmp - 1} mapped no keyframe")
    phase("mapping", f"frames 0-{n_cmp - 1} CPU vs GPU ({cpu_kc} keyframe mapped): states "
          f"equal, max |dt| {dt:.3e} m, max rotation {dr:.3e} rad")
    worst, moved = compare_mapping_passes(msystem.local_mapper, passes)
    pose_tol = MAP_TOL["kf_pose_cw"][0]
    phase("mapping", f"each of the {len(passes)} mapping passes again on the CPU from the card's "
          f"input map: integer and boolean fields equal, largest float differences " +
          ", ".join(f"{f} {v:.3e}" for f, v in worst.items()) +
          f"; the passes moved keyframe pose entries by up to {moved:.3e}")
    if moved <= 10 * pose_tol:
        raise AssertionError(f"the mapping passes moved keyframe poses by {moved} only, "
                             f"within ten times the pose tolerance {pose_tol}")
    del passes

    # 8. timing ------------------------------------------------------------------
    secs = run_slice(settings, seq, "cuda", N_FRAMES)[2]
    ext = system.tracker.extractor
    images = [torch.as_tensor(im, device="cuda") for im in seq.images]
    ext(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for im in images:
        ext(im)
    torch.cuda.synchronize()
    extract_ms = (time.perf_counter() - t0) / len(images) * 1e3
    phase("timing", f"{card}: mapping off: tracking {N_FRAMES / secs:.2f} frames/s (one pass "
          f"of {N_FRAMES}), extraction {extract_ms:.3f} ms/frame, "
          f"{metrics['host_syncs'] / N_FRAMES:.2f} host syncs/frame (tracker's count)")
    off_sys = run_slice(settings, seq, "cuda", 6)[0]
    profile_window(off_sys, seq, range(6, 11), card, "mapping off")
    time_layers(tracking_layers(off_sys, torch.as_tensor(seq.images[11], device="cuda"),
                                torch.as_tensor(seq.depths[11], device="cuda")), card, n=5)

    # Mapping on: a timed pass with each mapping pass timed on its own.
    tsys = make_system(settings, "cuda", mapping=True)
    mapper = tsys.local_mapper
    process = mapper.process_keyframe
    map_s = []

    def timed_process(m, kf_id, n_now=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = process(m, kf_id, n_now)
        torch.cuda.synchronize()
        map_s.append(time.perf_counter() - t)
        return out

    mapper.process_keyframe = timed_process
    m_secs = drive(tsys, seq, "cuda", range(N_FRAMES))[1]
    kf_frames = [i for i in range(N_FRAMES) if kc_log[i] > (kc_log[i - 1] if i else 0)]
    kf_syncs = [syncs[i] for i in kf_frames]
    plain_syncs = [syncs[i] for i in range(N_FRAMES) if i not in kf_frames and i > 0]
    phase("timing", f"{card}: mapping on: {N_FRAMES / m_secs:.2f} frames/s (one pass of "
          f"{N_FRAMES}), mapping {statistics.mean(map_s) * 1e3:.1f} ms per keyframe "
          f"({len(map_s)} keyframes: " + ", ".join(f"{s * 1e3:.1f}" for s in map_s) + " ms)")
    phase("timing", f"{card}: mapping on: host syncs (torch sync debug mode) "
          f"{sum(syncs) / N_FRAMES:.2f}/frame overall, "
          f"{statistics.mean(plain_syncs):.2f} on frames without a keyframe, "
          f"{statistics.mean(kf_syncs):.2f} on frames with one; tracker's count "
          f"{mmetrics['host_syncs'] / N_FRAMES:.2f}/frame")
    phase("timing", "mapping on: the lines that synchronized most, per frame: " + ", ".join(
        f"{site} {n / N_FRAMES:.1f}" for site, n in sync_sites.most_common(10)))
    ba_iterations_per_sec(msystem, card)
    k_last = max(i for i in kf_frames if i >= 1)
    start = min(max(k_last - 2, 1), N_FRAMES - 5)
    psys = make_system(settings, "cuda", mapping=True)
    drive(psys, seq, "cuda", range(start))
    per_launch, window = profile_window(psys, seq, range(start, start + 5), card,
                                        f"mapping on, frames {start}-{start + 4}")
    phase("profile", f"{card}: K4 {per_launch.get('ba_normal_equations_kernel', float('nan')):.2f}"
          f" us/launch, K5 {per_launch.get('ba_chi2_kernel', float('nan')):.2f} us/launch "
          "(device)")
    mapping_stage_lines(window, card)

    # The camera count of the main path's local-BA window (its last keyframe).
    from orbslam2_tpu_torch.models.local_mapping import _bucket

    n_local = _bucket(mapper.ba_n_local, int(msystem.map.n_kf))
    c_main = n_local + min(mapper.ba_n_fixed, n_local)
    k4_bound, k5_bound = ba_bounds(c_main, 1024)
    phase("K4/K5", f"the main path's window: C={c_main} N=1024 (the kernel table's shape)")
    print(json.dumps({"kernels": [
        {"name": "fast_score_nms", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["fast_score_nms"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "hamming_matrix", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["hamming_matrix"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
        {"name": "ba_normal_equations", "route": "cuda", "source": BA_SOURCE,
         "replaces": K4_REPLACES, "launches": launches["ba_normal_equations"],
         "max_abs_err": k4_err, "ms": ba_times[c_main][0], "plain_ms": ba_times[c_main][1],
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None},
        {"name": "ba_chi2", "route": "cuda", "source": BA_SOURCE,
         "replaces": K5_REPLACES, "launches": launches["ba_chi2"],
         "max_abs_err": k5_err, "ms": ba_times[c_main][2], "plain_ms": ba_times[c_main][3],
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "library_ms": None},
    ]}))
    phase("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
