"""The per-frame Track() chain.

Port of ``orbslam2_tpu/models/track_fused.py::_fused_track``
(Tracking::Track, src/Tracking.cc:≈340):

    TrackWithMotionModel (+ doubled-window retry, Tracking.cc:≈880)
    -> TrackReferenceKeyFrame fallback (≈770)
    -> TrackLocalMap (≈930)
    -> ref-KF rescue if the motion path collapsed
    -> visual odometry in localization-only mode (mbVO, ≈900)
    -> NeedNewKeyFrame decision (≈980)
    -> velocity + relative-pose bookkeeping

The reference runs the chain as one device program with ``lax.cond``
branches.  Here each branch is a host ``if`` on a count read back from the
device; reads are batched so a frame on the motion path makes three (the
motion-model counts, the local-map inlier count, and the flags the tracker
reads).  ``TrackOut.host_syncs`` reports the reads made here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.lie import orthonormalize_se3, se3_inverse
from ..utils.camera import CameraModel
from . import map_state as ms
from .frame import Frame
from .tracking import (
    gather_local_points,
    track_local_map,
    track_motion_model,
    track_reference_keyframe,
)

# flags vector layout (int32):
FLAG_OK = 0
FLAG_N_INLIERS = 1
FLAG_NEED_KF = 2
FLAG_PATH = 3  # 0 = lost, 1 = motion model, 2 = reference keyframe, 3 = VO
N_FLAGS = 4


class TrackCtx(NamedTuple):
    """Per-frame tracker context (Tracking's member state: mVelocity, last
    frame, reference KF, keyframe-policy inputs).  Arrays are device
    tensors; the scalars the host decides on are host values."""

    T_last: torch.Tensor          # (4, 4) last frame pose (world->camera)
    velocity: torch.Tensor        # (4, 4) motion model T_cur<-last
    has_velocity: bool
    last_xy: torch.Tensor         # (N, 2) last frame keypoints
    last_level: torch.Tensor      # (N,)
    last_bindings: torch.Tensor   # (N,) last frame slot -> point id
    ref_kf: int                   # reference keyframe id
    weak: bool                    # last frame tracked < 50 points
    frames_since_kf: int
    # Temporary VO sources (Tracking::UpdateLastFrame, Tracking.cc:≈810):
    # the last frame's depth, descriptors and validity.
    last_depth: torch.Tensor      # (N,) last frame depth (<0 = none)
    last_desc: torch.Tensor       # (N, 8) int32
    last_valid: torch.Tensor      # (N,) bool
    only_tracking: bool           # localization-only mode (mbOnlyTracking)
    last_angle: torch.Tensor      # (N,) last frame keypoint angles


class TrackOut(NamedTuple):
    m: ms.MapState
    frame: Frame
    T_cw: torch.Tensor       # final pose (valid iff flags[FLAG_OK])
    bindings: torch.Tensor   # (N,) frame slot -> point id
    velocity: torch.Tensor   # (4, 4) new motion model
    T_cr: torch.Tensor       # (4, 4) pose relative to the ref KF (trajectory log)
    flags: torch.Tensor      # (N_FLAGS,) int32
    host_syncs: int          # device-to-host reads made by the chain


def _fused_track(
    m: ms.MapState,
    frame: Frame,
    ctx: TrackCtx,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    inv_sigma2: torch.Tensor,
    th_depth: float,
    *,
    local_window: int,
    kf_max_gap: int,
    kf_busy_frames: int,
) -> TrackOut:
    """One stereo or RGB-D frame of the Track() chain (the two sensors
    share every branch; mono is not ported).  The keyframe-policy knobs
    come from ``TpuSettings`` (the reference's function default for
    ``kf_busy_frames`` disagrees with its settings; the port has none)."""
    dev = frame.xy.device
    th = 7.0  # the reference's stereo/RGB-D search radius (15 for mono)
    reads = 0

    def host(x):
        nonlocal reads
        reads += 1
        return x.tolist()

    # --- 1. motion-model tracking with doubled-window retry ---------------
    def run_motion(radius):
        T, b, n_map, n_match, n_tot = track_motion_model(
            m, frame, ctx.velocity @ ctx.T_last, ctx.last_xy, ctx.last_bindings,
            ctx.last_level, cam, scale_factors, inv_sigma2, radius,
            T_last=ctx.T_last, last_angle=ctx.last_angle, baseline=cam.baseline,
            last_depth=ctx.last_depth, last_desc=ctx.last_desc, last_valid=ctx.last_valid,
            temp_depth_cap=th_depth, use_temp=ctx.only_tracking,
        )
        return T, b, *host(torch.stack([n_map, n_match, n_tot.to(n_map.dtype)]))

    ok_motion = False
    n_tot_h = 0
    if ctx.has_velocity:
        T_m, b_m, n_m_h, n_match_h, n_tot_h = run_motion(th)
        if n_match_h < 20:
            T_m, b_m, n_m_h, n_match_h, n_tot_h = run_motion(2.0 * th)
        ok_motion = n_m_h >= 10
    # Localization-only VO eligibility (mbVO, Tracking.cc:≈900): enough
    # motion-model inliers, map and temporary together, to dead-reckon.
    vo_eligible = ctx.only_tracking and ctx.has_velocity and n_tot_h >= 20

    # --- 2. reference-keyframe fallback ------------------------------------
    def refkf_path():
        T, b, n_in, _ = track_reference_keyframe(
            m, frame, ctx.ref_kf, ctx.T_last, inv_sigma2, cam
        )
        return T, b, host(n_in)

    if ok_motion:
        T0, b0, n0 = T_m, b_m, n_m_h
    else:
        T0, b0, n0 = refkf_path()
    ok0 = n0 >= 10

    # --- 3. local-map tracking ---------------------------------------------
    def run_local(T, b, rmult):
        local_ids, local_valid = gather_local_points(m, b, n_local_kfs=local_window)
        T2, b2, n2, m2 = track_local_map(
            m, frame, T, b, local_ids, local_valid, cam,
            scale_factors, inv_sigma2, rmult,
        )
        return T2, b2, host(n2), m2.pt_visible, m2.pt_found

    if ok0:
        T1, b1, n1, ptv1, ptf1 = run_local(T0, b0, 2.0 if ctx.weak else 1.0)
    else:
        T1, b1, n1, ptv1, ptf1 = T0, b0, 0, m.pt_visible, m.pt_found
    ok1 = ok0 and n1 >= 30

    # --- 4. ref-KF rescue when the motion path collapsed in TrackLocalMap --
    use_rescue = (not ok1) and ok_motion
    if use_rescue:
        T, b, n_in = refkf_path()
        if n_in >= 6:
            Tf, bf, nf, ptv, ptf = run_local(T, b, 2.0)
        else:
            Tf, bf, nf, ptv, ptf = T, b, 0, m.pt_visible, m.pt_found
    else:
        Tf, bf, nf, ptv, ptf = T1, b1, n1, ptv1, ptf1
    ok = nf >= 30
    # VO mode: the map-anchored chain failed, but the motion model had
    # enough (map + temporary) inliers; its dead-reckoned pose is taken.
    vo_mode = vo_eligible and not ok
    if vo_mode:
        Tf, bf, nf, ok = T_m, b_m, n_tot_h, True
    m = m._replace(pt_visible=ptv, pt_found=ptf)

    # --- 5. bookkeeping: velocity, trajectory log, keyframe policy ---------
    T_out = orthonormalize_se3(Tf)
    velocity_new = T_out @ se3_inverse(ctx.T_last)
    T_log = T_out if ok else ctx.T_last
    T_cr = T_log @ se3_inverse(m.kf_pose_cw[ctx.ref_kf])

    # NeedNewKeyFrame (Tracking.cc:≈980), `(c1a || c1b || c1c) && c2`:
    #   c1a  max frame gap since the last keyframe
    #   c1b  the deterministic mapper-occupancy window (kf_busy_frames)
    #   c1c  tracking collapsed vs the reference KF, or close-point
    #        starvation
    #   c2   weak ref-KF match ratio (or close starvation) AND > 15 inliers
    # nRefMatches counts ref-KF points with >= nMinObs observers (3 above
    # two keyframes, 2 with two, 1 with one — see the reference package).
    # The thresholds are the stereo/RGB-D ones (mono has no close points
    # and a 0.9 ratio).
    P = m.pt_capacity
    obs_ok = (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    obs_idx = torch.where(obs_ok, m.kf_point, P).reshape(-1).long()
    obs_counts = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add(
        0, obs_idx, torch.ones_like(obs_idx, dtype=torch.int32)
    )[:P]
    ref_pid = m.kf_point[ctx.ref_kf]
    ref_bound = (ref_pid >= 0) & m.kf_kp_valid[ctx.ref_kf]
    min_obs = torch.where(m.n_kf > 2, 3, torch.where(m.n_kf > 1, 2, 1))
    kf_tracked = (ref_bound & (obs_counts[ref_pid.clamp(min=0).long()] >= min_obs)).sum()
    kf_tracked = kf_tracked.to(torch.float32)
    close = (frame.depth > 0) & (frame.depth < th_depth)
    n_close_tracked = (close & (bf >= 0)).sum()
    n_close_total = (close & frame.valid).sum()
    close_starved = (n_close_tracked < 100) & (n_close_total > 70)
    c1c = (nf < 0.25 * kf_tracked) | close_starved
    ratio_weak = nf < 0.75 * kf_tracked
    c1ab = ctx.frames_since_kf >= kf_max_gap or ctx.frames_since_kf >= kf_busy_frames
    c2 = (ratio_weak | close_starved) & (nf > 15)
    need = (c1c | c1ab) & c2
    need = need & (ctx.frames_since_kf >= 1 and ok) & (m.n_kf < m.kf_capacity - 1)

    if vo_mode:
        path = 3
    elif ok and ok_motion and not use_rescue:
        path = 1
    else:
        path = 2 if ok else 0
    flags = torch.stack([
        torch.tensor(int(ok), dtype=torch.int32, device=dev),
        torch.tensor(nf, dtype=torch.int32, device=dev),
        need.to(torch.int32),
        torch.tensor(path, dtype=torch.int32, device=dev),
    ])
    return TrackOut(
        m=m, frame=frame, T_cw=T_out, bindings=bf, velocity=velocity_new,
        T_cr=T_cr, flags=flags, host_syncs=reads,
    )
