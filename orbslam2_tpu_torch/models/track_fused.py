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
reads).  ``TrackOut.host_syncs`` reports the reads made here, and
``TrackOut.next_ctx`` is the context the next frame starts from, which the
pipelined and chunked drivers chain.  ``make_fused_chunk_tracker`` runs C
frames with the keyframe decision and insertion inside (the reference's
``lax.scan``, a host loop here).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
    next_ctx: TrackCtx       # the context the next frame starts from


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
    sensor: str = "rgbd",
) -> TrackOut:
    """One frame of the Track() chain.  Stereo and RGB-D share every
    branch; mono (``sensor="mono"``) searches a 15 px window (7 otherwise),
    has no temporary VO points and no depth-direction octave gate, and its
    keyframe policy has a 0.9 ratio, no close points and no c1c.  The
    keyframe-policy knobs come from ``TpuSettings`` (the reference's
    function default for ``kf_busy_frames`` disagrees with its settings;
    the port has none)."""
    dev = frame.xy.device
    mono = sensor == "mono"
    th = 15.0 if mono else 7.0
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
            T_last=ctx.T_last, last_angle=ctx.last_angle,
            baseline=None if mono else cam.baseline,
            last_depth=None if mono else ctx.last_depth, last_desc=ctx.last_desc,
            last_valid=ctx.last_valid, temp_depth_cap=th_depth,
            use_temp=ctx.only_tracking and not mono,
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
    # Mono has no close points, no c1c and a 0.9 ratio.
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
    if mono:
        close_starved = torch.zeros((), dtype=torch.bool, device=dev)
        c1c = close_starved
    else:
        close = (frame.depth > 0) & (frame.depth < th_depth)
        n_close_tracked = (close & (bf >= 0)).sum()
        n_close_total = (close & frame.valid).sum()
        close_starved = (n_close_tracked < 100) & (n_close_total > 70)
        c1c = (nf < 0.25 * kf_tracked) | close_starved
    ratio_weak = nf < (0.9 if mono else 0.75) * kf_tracked
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
    # The context the next frame starts from (the reference's device-chained
    # ctx, read by the pipelined and chunked drivers).  ref_kf and
    # frames_since_kf are overridden by the driver when a keyframe is made.
    next_ctx = TrackCtx(
        T_last=T_log,
        velocity=velocity_new if ok else torch.eye(4, dtype=torch.float32, device=dev),
        has_velocity=ok,
        last_xy=frame.xy,
        last_level=frame.level,
        last_bindings=bf if ok else ctx.last_bindings,
        ref_kf=ctx.ref_kf,
        weak=nf < 50,
        frames_since_kf=ctx.frames_since_kf + 1,
        last_depth=frame.depth,
        last_desc=frame.desc,
        last_valid=frame.valid,
        only_tracking=ctx.only_tracking,
        last_angle=frame.angle,
    )
    return TrackOut(
        m=m, frame=frame, T_cw=T_out, bindings=bf, velocity=velocity_new,
        T_cr=T_cr, flags=flags, host_syncs=reads, next_ctx=next_ctx,
    )


class ChunkOut(NamedTuple):
    """A C-frame chunk's outputs: the per-frame tensors the host resolves
    (read in one copy), the map and the context after the chunk."""

    m: ms.MapState
    next_ctx: TrackCtx
    flags: torch.Tensor      # (C, N_FLAGS) int32
    T_cw: torch.Tensor       # (C, 4, 4) per-frame pose (valid iff flags ok)
    T_cr: torch.Tensor       # (C, 4, 4) pose relative to the logged ref KF
    log_ref: np.ndarray      # (C,) int32 ref-KF id of each trajectory entry
    kf_id: np.ndarray        # (C,) int32 created keyframe id, -1 if none
    # Copies of the pool state, read with the chunk's outputs so that pool
    # maintenance needs no read of its own (the map itself is replaced by
    # the next chunk).
    kf_valid: torch.Tensor   # (K,) bool
    n_kf: torch.Tensor       # int32
    host_syncs: int          # device-to-host reads made by the chunk


def make_fused_chunk_tracker(
    build_frame,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    inv_sigma2: torch.Tensor,
    th_depth: float,
    *,
    local_window: int,
    kf_max_gap: int,
    kf_busy_frames: int,
    sensor: str,
):
    """C frames of tracking in one call: the port of the reference's
    ``make_fused_chunk_tracker`` (a ``lax.scan`` there, a host loop here,
    strictly serial over frames).  The keyframe decision and insertion
    happen inside the chunk, so a new keyframe is trackable by the frames
    after it; triangulation, culling, local BA and loop closing run after
    the chunk (the reference's queue hand-off to LocalMapping, with a lag
    of at most C frames).

    Returns ``chunk(*img_stacks, m, ctx, fid0, min_kf_fid) -> ChunkOut``:
    ``img_stacks[i][j]`` is input i of frame j, ``build_frame(inputs)``
    makes a frame of them, ``fid0`` is the first frame's id, and frames
    with an id below ``min_kf_fid`` insert no keyframe (localization-only
    mode passes 2**30, the post-relocalization suppression its threshold,
    Tracking.cc:≈990).  A keyframe frame reads the device once more than a
    tracked one: whether the policy wants a keyframe, with the slot it
    takes.  ``sensor`` goes to ``_fused_track``; a mono keyframe spawns no
    close-depth points (it has no depth)."""
    from .tracking import add_points, insert_keyframe, unproject_frame_depth

    def chunk(*args):
        *img_stacks, m, ctx, fid0, min_kf_fid = args
        reads = 0
        flags, T_cws, T_crs, log_ref, kf_ids = [], [], [], [], []
        for j in range(len(img_stacks[0])):
            fid = fid0 + j
            frame = build_frame(tuple(s[j] for s in img_stacks))
            out = _fused_track(
                m, frame, ctx, cam, scale_factors, inv_sigma2, th_depth,
                local_window=local_window, kf_max_gap=kf_max_gap,
                kf_busy_frames=kf_busy_frames, sensor=sensor,
            )
            reads += out.host_syncs + 1
            need, slot = torch.stack([out.flags[FLAG_NEED_KF], out.m.n_kf.to(torch.int32)]).tolist()
            m, nctx, T_cr, kid = out.m, out.next_ctx, out.T_cr, -1
            if need and fid >= min_kf_fid:
                bindings = out.bindings
                if sensor != "mono":
                    # Close-depth point spawning (Tracking.cc:≈1060), from
                    # the tracker's end of the free list (see add_points).
                    pos_w, okd = unproject_frame_depth(frame, out.T_cw, cam)
                    okd = okd & (bindings < 0) & (frame.depth < th_depth)
                    m, pids = add_points(m, pos_w, frame.desc, okd, m.n_kf, reverse=True)
                    bindings = torch.where(okd & (pids >= 0), pids, bindings)
                m, _ = insert_keyframe(m, frame, out.T_cw, fid, bindings, ctx.ref_kf)
                m = ms.update_point_stats(m, scale_factors)
                kid = slot
                # A keyframe event is the only override of the chained ctx;
                # the reference logs the relative pose after
                # CreateNewKeyFrame moved mpReferenceKF (Tracking.cc:≈470-490),
                # so a keyframe frame's is the identity.
                nctx = nctx._replace(ref_kf=kid, frames_since_kf=0, last_bindings=bindings)
                T_cr = torch.eye(4, dtype=torch.float32, device=T_cr.device)
            flags.append(out.flags)
            T_cws.append(out.T_cw)
            T_crs.append(T_cr)
            log_ref.append(kid if kid >= 0 else ctx.ref_kf)
            kf_ids.append(kid)
            ctx = nctx
        return ChunkOut(
            m=m, next_ctx=ctx, flags=torch.stack(flags), T_cw=torch.stack(T_cws),
            T_cr=torch.stack(T_crs), log_ref=np.array(log_ref, np.int32),
            kf_id=np.array(kf_ids, np.int32), kf_valid=m.kf_valid.clone(),
            n_kf=m.n_kf.clone(), host_syncs=reads,
        )

    return chunk
