"""Tracking: the per-frame front end (mono, stereo and RGB-D).

Port of ``orbslam2_tpu/models/tracking.py`` (``Tracking``,
src/Tracking.cc).  The device functions keep the reference's
names and fixed shapes:

  track_motion_model    SearchByProjection(cur, last) + PoseOptimization
                        (Tracking::TrackWithMotionModel, Tracking.cc:≈860)
  track_reference_keyframe  matching vs the reference KF + PoseOptimization
                        (Tracking::TrackReferenceKeyFrame, ≈770)
  gather_local_points / track_local_map
                        Tracking::UpdateLocalKeyFrames/Points +
                        SearchLocalPoints (≈930-1300)
  insert_keyframe / add_points / unproject_frame_depth
                        keyframe insertion and depth-spawned points
  relocalize_candidate  BoW candidate -> node-gated matching -> P3P RANSAC
                        -> pose polish (Tracking::Relocalization, ≈1310)

The host ``Tracker`` runs the state machine.  Initialization builds the
first keyframe from stereo or sensor depth (StereoInitialization, ≈500),
or for mono the first two from a two-view reconstruction
(MonocularInitialization and CreateInitialMapMonocular, ≈560-740: frames
extracted with twice the feature budget, ``matcher.
search_for_initialization``, ``twoview.initialize_two_view``); every later
frame goes through ``track_fused._fused_track``, one frame at
a time, pipelined (frame k resolved after frame k+1 is tracked) or in
chunks of C frames (``track_fused.make_fused_chunk_tracker``); with
``use_fused=False`` it goes through the same chain step by step on the
host (``Tracker._track``, the reference's unfused path).  A
``LocalMapper`` given to the tracker maps each new keyframe, in line or,
with an ``AsyncMappingPipeline``, in a worker thread on a map snapshot
that is adopted at a later frame boundary; a ``KeyframeDatabase`` takes
every keyframe and serves the relocalization of LOST frames (and of
visual-odometry frames in localization-only mode); a ``LoopCloser`` given
to it runs after local mapping on each keyframe.

Repeated scatter targets are resolved as the reference's CPU run resolves
them (the highest source row wins), through ``map_state.scatter_last``.
Every ``top_k`` is a stable descending sort (lower index first on ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Settings
from ..ops import matcher, pnp, twoview
from ..ops import pyramid as pyr_ops
from ..ops.extractor import OrbExtractor
from ..ops.hamming import TH_HIGH, TH_LOW, match_descriptors, rotation_consistency
from ..ops.select import topk_stable
from ..solvers.lie import orthonormalize_se3, se3_apply, se3_inverse
from ..solvers.pose_opt import PoseObs, pose_optimization
from ..utils.camera import CameraModel, in_image
from . import map_state as ms
from .frame import Frame, build_mono_frame, build_rgbd_frame, build_stereo_frame

NO_POINT = ms.NO_POINT


# ---------------------------------------------------------------------------
# Device tracking steps
# ---------------------------------------------------------------------------


def _pose_obs_from_bindings(
    m: ms.MapState, frame: Frame, bindings: torch.Tensor, inv_sigma2_lut: torch.Tensor
) -> PoseObs:
    """PoseObs for all frame slots bound to a map point."""
    bound = bindings >= 0
    pid = torch.where(bound, bindings, 0).long()
    lvl = torch.clamp(frame.level, 0, inv_sigma2_lut.shape[0] - 1).long()
    return PoseObs(
        points_w=m.pt_pos[pid],
        uv=frame.xy,
        ur=frame.ur,
        inv_sigma2=inv_sigma2_lut[lvl],
        valid=bound & frame.valid & m.pt_valid[pid],
    )


def _project(cam: CameraModel, p_c: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(p_c[:, 2], min=1e-6)
    return torch.stack(
        [cam.fx * p_c[:, 0] / z + cam.cx, cam.fy * p_c[:, 1] / z + cam.cy], -1
    )


def _bind(n: int, ok: torch.Tensor, idx: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
    """Frame-slot bindings from match results: ``full(n, NO_POINT)
    .at[where(ok, idx, 0)].set(where(ok, pid, NO_POINT))`` with the
    reference's last-writer rule (rows that did not match write NO_POINT
    into slot 0, as in the reference)."""
    base = torch.full((n,), NO_POINT, dtype=torch.int32, device=ok.device)
    tgt = torch.where(ok, idx, 0)
    return ms.scatter_last(base, tgt, torch.where(ok, pid, NO_POINT).to(torch.int32))


def track_motion_model(
    m: ms.MapState,
    frame: Frame,
    T_pred: torch.Tensor,
    last_xy: torch.Tensor,
    last_bindings: torch.Tensor,
    last_level: torch.Tensor,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    inv_sigma2_lut: torch.Tensor,
    radius: float,
    T_last: torch.Tensor,
    last_angle: torch.Tensor,
    baseline: Optional[float],
    last_depth: Optional[torch.Tensor] = None,
    last_desc: Optional[torch.Tensor] = None,
    last_valid: Optional[torch.Tensor] = None,
    temp_depth_cap: float = 1e9,
    use_temp: bool = False,
):
    """Project the last frame's map points with the predicted pose, match
    in a window, optimize the pose.

    Temporary visual-odometry points (Tracking::UpdateLastFrame,
    src/Tracking.cc:≈810), with ``use_temp`` (localization-only mode): the
    last frame's unbound keypoints with close depth are unprojected at the
    last pose and matched as extra sources; they never enter the map or the
    bindings.  The pose is optimized on the map matches first and, when
    that leaves fewer than 20 inliers, again with the temporary ones.
    Without ``use_temp`` the reference's gated sources are all off and it
    computes exactly the map-only search.  ``baseline`` None (mono) drops
    the depth-direction octave gate.

    Returns (T, bindings, n_inliers_map, n_matches, n_inliers_total).
    """
    bound = last_bindings >= 0
    pid = torch.where(bound, last_bindings, 0).long()
    is_map = bound & m.pt_valid[pid]
    use_temp = use_temp and last_depth is not None

    p_w, desc_src, valid_src = m.pt_pos[pid], m.pt_desc[pid], is_map
    if use_temp:
        has_temp = ~is_map & last_valid & (last_depth > 0) & (last_depth < temp_depth_cap)
        x = (last_xy[:, 0] - cam.cx) / cam.fx * last_depth
        y = (last_xy[:, 1] - cam.cy) / cam.fy * last_depth
        p_w_temp = se3_apply(se3_inverse(T_last), torch.stack([x, y, last_depth], -1))
        p_w = torch.where(is_map[:, None], p_w, p_w_temp)
        desc_src = torch.where(is_map[:, None], desc_src, last_desc)
        valid_src = is_map | has_temp
    p_c = se3_apply(T_pred, p_w)
    uv = _project(cam, p_c)
    valid_src = valid_src & (p_c[:, 2] > 0.1) & in_image(cam, uv)

    # Depth-direction octave gate (ORBmatcher.cc:≈1180), stereo/RGB-D only:
    # forward motion searches higher octaves, backward motion lower ones.
    level_dir = None
    if baseline is not None:
        tz = (T_pred @ se3_inverse(T_last))[2, 3]
        one = torch.ones((), dtype=torch.int32, device=tz.device)
        level_dir = torch.where(tz > baseline, one, torch.where(-tz > baseline, -one, 0 * one))
    mres = matcher.search_by_projection(
        uv, last_level, desc_src, valid_src, frame.features,
        scale_factors, radius=radius, max_dist=TH_HIGH, ratio=0.9,
        level_dir=level_dir,
    )
    # Rotation-consistency histogram (ComputeThreeMaxima, ≈1600).
    mres = mres._replace(ok=rotation_consistency(last_angle, frame.angle, mres.idx, mres.ok))

    # Bindings take map matches only; temporary sources never reach the map.
    N = frame.xy.shape[0]
    bindings = _bind(N, mres.ok & is_map, mres.idx, pid)
    obs = _pose_obs_from_bindings(m, frame, bindings, inv_sigma2_lut)
    # The retry gate counts map matches only.
    n_matches = obs.valid.sum()
    res = pose_optimization(T_pred, obs, cam)
    if use_temp:
        # Temporary matches per frame slot (map bindings win collisions).
        ok_temp = mres.ok & has_temp
        src_ids = torch.arange(last_xy.shape[0], dtype=torch.int32, device=ok_temp.device)
        temp_src = ms.scatter_last(torch.full((N,), -1, dtype=torch.int32, device=ok_temp.device),
                                   torch.where(ok_temp, mres.idx, 0),
                                   torch.where(ok_temp, src_ids, -1))
        temp_src = torch.where(bindings >= 0, -1, temp_src)
        t_ok = (temp_src >= 0) & frame.valid
        pts_w = torch.where(t_ok[:, None], p_w[temp_src.clamp(min=0).long()], obs.points_w)
        res_full = pose_optimization(T_pred, obs._replace(points_w=pts_w, valid=obs.valid | t_ok),
                                     cam)
        # The reference's lax.cond as a select: no host read.
        redo = (res.n_inliers < 20) & t_ok.any()
        res = type(res)(*(torch.where(redo, b, a) for a, b in zip(res, res_full)))
    n_map = (res.inlier & (bindings >= 0)).sum()
    bindings = torch.where(res.inlier, bindings, NO_POINT)
    return res.T_cw, bindings, n_map, n_matches, res.n_inliers


def track_reference_keyframe(
    m: ms.MapState,
    frame: Frame,
    ref_kf: int,
    T_init: torch.Tensor,
    inv_sigma2_lut: torch.Tensor,
    cam: CameraModel,
):
    """Match the frame against the reference keyframe's bound descriptors
    (cross-checked, ratio 0.7), then optimize.  Dense matching stands in for
    SearchByBoW, as in the reference package."""
    kf_pts = m.kf_point[ref_kf]
    kf_has_pt = (kf_pts >= 0) & m.kf_kp_valid[ref_kf]
    pid = torch.where(kf_has_pt, kf_pts, 0).long()
    src_valid = kf_has_pt & m.pt_valid[pid]

    mres = match_descriptors(
        m.kf_desc[ref_kf], src_valid, frame.desc, frame.valid,
        max_dist=TH_LOW, ratio=0.7, cross_check=True,
    )
    bindings = _bind(frame.xy.shape[0], mres.ok, mres.idx, pid)
    obs = _pose_obs_from_bindings(m, frame, bindings, inv_sigma2_lut)
    n_matches = obs.valid.sum()
    res = pose_optimization(T_init, obs, cam)
    bindings = torch.where(res.inlier, bindings, NO_POINT)
    return res.T_cw, bindings, res.n_inliers, n_matches


def gather_local_points(
    m: ms.MapState, bindings: torch.Tensor, n_local: int = 4096,
    n_local_kfs: int = 80,
):
    """Local map = points seen by the keyframes sharing the most points
    with the frame (K1, ~60% of the cap) plus the keyframes most covisible
    with that group (K2) — Tracking::UpdateLocalKeyFrames/Points
    (Tracking.cc:≈1190-1300).  Returns (pt_ids (n_local,) int32,
    valid (n_local,) bool)."""
    P, K = m.pt_capacity, m.kf_capacity
    n_local = min(n_local, P)
    n_local_kfs = min(n_local_kfs, K)
    n_k1 = max(1, (n_local_kfs * 3) // 5)
    n_k2 = n_local_kfs - n_k1
    bound = bindings >= 0
    in_frame = ms.scatter_max(P, torch.where(bound, bindings, P), bound.to(torch.int32)) > 0
    obs_ok = (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pts_all = torch.where(obs_ok, m.kf_point, 0).long()
    votes = (in_frame[pts_all] & obs_ok).sum(1).to(torch.float32)
    _, local_kfs = topk_stable(votes, n_k1)
    k1_hit = votes[local_kfs] > 0

    def union_points(kf_ids, ok_rows):
        sel_pts = m.kf_point[kf_ids]
        sel_ok = (
            (sel_pts >= 0) & m.kf_kp_valid[kf_ids]
            & m.kf_valid[kf_ids][:, None] & ok_rows[:, None]
        )
        return ms.scatter_max(P, torch.where(sel_ok, sel_pts, P), 1) > 0

    seen = union_points(local_kfs, k1_hit)
    if n_k2 > 0:
        in_k1 = ms.scatter_max(K, local_kfs, k1_hit.to(torch.int32)) > 0
        votes2 = (seen[pts_all] & obs_ok).sum(1).to(torch.float32)
        votes2 = torch.where(in_k1, -1.0, votes2)
        v2, k2_kfs = topk_stable(votes2, n_k2)
        seen = seen | union_points(k2_kfs, v2 > 0)
    seen = seen & m.pt_valid
    _, pt_ids = topk_stable(seen.to(torch.float32), n_local)
    return pt_ids.to(torch.int32), seen[pt_ids]


def track_local_map(
    m: ms.MapState,
    frame: Frame,
    T: torch.Tensor,
    bindings: torch.Tensor,
    local_ids: torch.Tensor,
    local_valid: torch.Tensor,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    inv_sigma2_lut: torch.Tensor,
    radius_mult: float = 1.0,
):
    """SearchLocalPoints + the final pose optimization (Tracking.cc:≈930-
    1180), with Frame::isInFrustum per local point (positive depth, in
    image, distance within [0.8 min, 1.2 max], viewing angle < 60 deg).
    Returns (T, bindings, n_inliers, map with visibility statistics)."""
    ids = local_ids.long()
    p_w = m.pt_pos[ids]
    p_c = se3_apply(T, p_w)
    zok = p_c[:, 2] > 0.1
    uv = _project(cam, p_c)
    O_w = -(T[:3, :3].T @ T[:3, 3])
    po = p_w - O_w
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist >= 0.8 * m.pt_min_dist[ids]) & (dist <= 1.2 * m.pt_max_dist[ids])
    view_cos = (po * m.pt_normal[ids]).sum(-1) / torch.clamp(dist, min=1e-9)
    # Already-bound points are not searched again (mnLastFrameSeen).
    bound = bindings >= 0
    already = ms.scatter_last(
        torch.zeros(m.pt_capacity, dtype=torch.bool, device=bound.device),
        torch.where(bound, bindings, 0), bound,
    )
    vis = local_valid & zok & in_image(cam, uv) & dist_ok & (view_cos > 0.5) & ~already[ids]

    pred_level = ms.predict_scale(dist, m.pt_max_dist[ids], scale_factors)
    # 2.5 px if viewed head-on (cos > 0.998) else 4.0, times the octave scale.
    r = torch.where(view_cos > 0.998, 2.5, 4.0) * radius_mult
    rr = (r * scale_factors[pred_level]) ** 2
    mres = matcher.projection_match(
        uv, rr, pred_level, m.pt_desc[ids], vis,
        frame.xy, frame.level, frame.desc, frame.valid,
        level_band=1, max_dist=TH_HIGH, ratio=0.8,
    )
    incoming = _bind(bindings.shape[0], mres.ok, mres.idx, local_ids)
    new_bindings = torch.where((bindings < 0) & (incoming >= 0), incoming, bindings)

    obs = _pose_obs_from_bindings(m, frame, new_bindings, inv_sigma2_lut)
    res = pose_optimization(T, obs, cam)
    new_bindings = torch.where(res.inlier, new_bindings, NO_POINT)

    # Visibility statistics for point culling (IncreaseVisible/Found).
    pt_visible = m.pt_visible.index_add(0, torch.where(vis, ids, 0), vis.to(torch.int32))
    found = new_bindings >= 0
    pt_found = m.pt_found.index_add(
        0, torch.where(found, new_bindings, 0).long(), found.to(torch.int32)
    )
    return res.T_cw, new_bindings, res.n_inliers, m._replace(pt_visible=pt_visible, pt_found=pt_found)


# ---------------------------------------------------------------------------
# Keyframe insertion and map growth
# ---------------------------------------------------------------------------


def _set_row(arr: torch.Tensor, k: torch.Tensor, value) -> torch.Tensor:
    """``arr.at[k].set(value)`` for a 0-d index tensor, out of place."""
    value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    return arr.index_put((k.view(1).long(),), value.expand(arr.shape[1:])[None])


def insert_keyframe(
    m: ms.MapState,
    frame: Frame,
    T_cw: torch.Tensor,
    frame_id: int,
    bindings: torch.Tensor,
    parent: int,
) -> Tuple[ms.MapState, torch.Tensor]:
    """Append the frame as keyframe row n_kf (Tracking::CreateNewKeyFrame
    plus the binding half of LocalMapping::ProcessNewKeyFrame).  Returns
    (map, kf_id as a 0-d tensor)."""
    k = m.n_kf
    m = m._replace(
        kf_pose_cw=_set_row(m.kf_pose_cw, k, T_cw),
        kf_xy=_set_row(m.kf_xy, k, frame.xy),
        kf_level=_set_row(m.kf_level, k, frame.level),
        kf_angle=_set_row(m.kf_angle, k, frame.angle),
        kf_desc=_set_row(m.kf_desc, k, frame.desc),
        kf_ur=_set_row(m.kf_ur, k, frame.ur),
        kf_kp_valid=_set_row(m.kf_kp_valid, k, frame.valid),
        kf_point=_set_row(m.kf_point, k, torch.where(frame.valid, bindings, NO_POINT)),
        kf_valid=_set_row(m.kf_valid, k, True),
        kf_frame_id=_set_row(m.kf_frame_id, k, frame_id),
        kf_parent=_set_row(m.kf_parent, k, parent),
        n_kf=k + 1,
    )
    return m, k


def add_points(
    m: ms.MapState,
    pos: torch.Tensor,        # (M, 3) world positions
    desc: torch.Tensor,       # (M, 8)
    good: torch.Tensor,       # (M,) which rows are real new points
    ref_kf,                   # keyframe id (int or 0-d tensor)
    reverse: bool = False,
) -> Tuple[ms.MapState, torch.Tensor]:
    """Insert up to M points into free pool slots, lowest index first (or
    highest with ``reverse``, the tracker's side of the free list).
    Returns (map, ids (M,) with -1 where not added)."""
    M = pos.shape[0]
    P = m.pt_capacity
    dev = pos.device
    order = torch.argsort((~good).to(torch.int32), stable=True)  # good first
    pos_s, desc_s, good_s = pos[order], desc[order], good[order]
    n_new = good.sum().to(torch.int32)
    idx_bias = torch.arange(P, dtype=torch.float32, device=dev) * (1.0 / P)
    free_score = torch.where(m.pt_valid, -1.0, 1.0) + (idx_bias if reverse else -idx_bias)
    _, slot = topk_stable(free_score, M)
    write = good_s & ~m.pt_valid[slot]
    ref = torch.as_tensor(ref_kf, dtype=torch.int32, device=dev)

    def put(arr, new):
        w = write.view((-1,) + (1,) * (arr.dim() - 1))
        return arr.index_put((slot,), torch.where(w, new, arr[slot]))

    m = m._replace(
        pt_pos=put(m.pt_pos, pos_s),
        pt_desc=put(m.pt_desc, desc_s),
        pt_ref_kf=put(m.pt_ref_kf, ref.expand(M)),
        pt_first_kf=put(m.pt_first_kf, ref.expand(M)),
        pt_valid=put(m.pt_valid, torch.ones_like(write)),
        pt_visible=put(m.pt_visible, torch.ones_like(m.pt_visible[slot])),
        pt_found=put(m.pt_found, torch.ones_like(m.pt_found[slot])),
        n_pt=torch.clamp(m.n_pt + n_new, max=P),
    )
    ids_sorted = torch.where(write, slot.to(torch.int32), NO_POINT)
    return m, ids_sorted[torch.argsort(order)]


def unproject_frame_depth(
    frame: Frame, T_cw: torch.Tensor, cam: CameraModel
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World positions for keypoints with valid depth (StereoInitialization
    and CreateNewKeyFrame's close-point spawning, Tracking.cc:≈500/≈1060)."""
    z = frame.depth
    ok = (z > 0) & frame.valid
    x = (frame.xy[:, 0] - cam.cx) / cam.fx * z
    y = (frame.xy[:, 1] - cam.cy) / cam.fy * z
    return se3_apply(se3_inverse(T_cw), torch.stack([x, y, z], -1)), ok


# ---------------------------------------------------------------------------
# Mono initialization's map bootstrap (CreateInitialMapMonocular, ≈640)
# ---------------------------------------------------------------------------


def median_depth_scale(points: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    """1 / the median depth of the ``good`` points (N, 3), float32 (1e-6
    floor on the median): the reference's ``np.median``, which takes the
    mean of the two middle depths of an even count (``torch.median`` takes
    the lower one), in float32, and the quotient in float64.  No host
    read."""
    z = points[:, 2]
    z = torch.sort(torch.where(good, z, torch.full_like(z, float("inf")))).values
    n = good.sum()
    med = z.gather(0, torch.stack([(n - 1) // 2, n // 2])).sum() / 2
    return (1.0 / torch.clamp(med.double(), min=1e-6)).to(torch.float32)


def init_bindings(n: int, idx: torch.Tensor, ok: torch.Tensor, pids: torch.Tensor) -> torch.Tensor:
    """The current frame's bindings after initialization: every match row i
    writes ``pids[i]`` (``ok``) or NO_POINT to slot ``idx[i]`` (the
    reference's ``.at[idx].set(..., mode="drop")``): a row that failed
    still writes, and targets repeat, so the last writer wins
    (``map_state.scatter_last``)."""
    base = torch.full((n,), NO_POINT, dtype=torch.int32, device=idx.device)
    return ms.scatter_last(base, idx, torch.where(ok, pids, NO_POINT).to(torch.int32))


# ---------------------------------------------------------------------------
# Relocalization (Tracking::Relocalization, src/Tracking.cc:≈1310)
# ---------------------------------------------------------------------------


def relocalize_candidate(
    m: ms.MapState,
    frame: Frame,
    kf_id: int,
    inv_sigma2_lut: torch.Tensor,
    cam: CameraModel,
    sample,
    kf_nodes: Optional[torch.Tensor] = None,
    frame_nodes: Optional[torch.Tensor] = None,
    ratio: float = 0.75,
    pnp_iters: int = 2048,
):
    """One relocalization attempt against a candidate keyframe: match the
    frame's descriptors to the keyframe's bound map points (K2; restricted
    to pairs in the same vocabulary node when node ids are given, the
    node-gated SearchByBoW, ORBmatcher.cc:≈250), P3P RANSAC over
    ``pnp_iters`` hypotheses, then the pose polish.  ``sample(valid, iters,
    k)`` gives the RANSAC's (iters, k) sample indices (the tracker draws
    them from its generator).

    Returns (T, bindings, n_inliers, n_matches, pnp_ok), all on the
    device."""
    kf_pts = m.kf_point[kf_id]
    kf_has = (kf_pts >= 0) & m.kf_kp_valid[kf_id]
    pid = torch.where(kf_has, kf_pts, 0).long()
    src_ok = kf_has & m.pt_valid[pid]
    pair_mask = None
    if kf_nodes is not None and frame_nodes is not None:
        pair_mask = (kf_nodes[:, None] == frame_nodes[None, :]) & (kf_nodes[:, None] >= 0)
    mres = match_descriptors(
        m.kf_desc[kf_id], src_ok, frame.desc, frame.valid,
        pair_mask=pair_mask, max_dist=TH_LOW, ratio=ratio, cross_check=True,
    )
    # 2D-3D correspondences: frame keypoint <- map point.
    bindings = _bind(frame.xy.shape[0], mres.ok, mres.idx, pid)
    bound = bindings >= 0
    bpid = torch.where(bound, bindings, 0).long()
    lvl = torch.clamp(frame.level, 0, inv_sigma2_lut.shape[0] - 1).long()
    valid = bound & frame.valid & m.pt_valid[bpid]
    pres = pnp.p3p_ransac(frame.xy, m.pt_pos[bpid], valid, inv_sigma2_lut[lvl], cam,
                          iters=pnp_iters, samples=sample(valid, pnp_iters, 4))
    obs = _pose_obs_from_bindings(m, frame, bindings, inv_sigma2_lut)
    res = pose_optimization(pres.T_cw, obs, cam)
    bindings = torch.where(res.inlier, bindings, NO_POINT)
    return res.T_cw, bindings, res.n_inliers, obs.valid.sum(), pres.ok


# ---------------------------------------------------------------------------
# Host-side tracker (the state machine)
# ---------------------------------------------------------------------------


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


_PATHS = {0: "none", 1: "motion", 2: "refkf", 3: "vo"}


class Tracker:
    """Host orchestrator for per-frame stereo and RGB-D tracking: motion
    model (mVelocity), last frame, reference keyframe, and the relative-pose
    log for trajectory export (mlRelativeFramePoses, Tracking.cc:≈480).

    Three drivers, as the reference's:

      * per frame (default): each frame is tracked and resolved at once;
      * ``pipeline=True``: frame k+1 is tracked before frame k is resolved,
        so frame k's keyframe enters the map one frame late (the
        reference's lag-1 readback, on the context each frame hands the
        next, ``TrackOut.next_ctx``);
      * ``chunk=C`` (C > 1): C frames are buffered and tracked in one call
        of ``track_fused.make_fused_chunk_tracker``, which decides and
        inserts keyframes itself; the host resolves a chunk (trajectory,
        keyframe database, mapping, loop closing, relocalization) after
        it, or after the next one while a mapping job is in flight.

    ``use_fused=False`` (also set as an attribute after construction)
    tracks each initialized frame through the step-by-step host chain
    (``_track``), which ignores ``pipeline`` and ``chunk``, as the
    reference's does.

    ``flush()`` resolves whatever is in flight.  With ``mapping_pipeline``
    (``async_pipeline.AsyncMappingPipeline``) keyframes queue for a worker
    thread that maps them on snapshots, adopted at later frame boundaries;
    without it the local mapper and the loop closer run in line.

    ``metrics["host_syncs"]`` counts the device-to-host reads tracking
    made (each one waits for the device when the tensors are on a GPU).
    The RANSAC samples of relocalization and of the mono two-view
    initialization come from ``generator``, a ``torch.Generator`` on the
    tracker's device seeded 0 as the reference seeds its key, through
    ``_ransac_samples``.  Mono initializes frame by frame; the driver
    chosen takes over from the first frame after initialization.
    """

    def __init__(self, settings: Settings, local_mapper=None, database=None,
                 loop_closer=None, use_fused: bool = True, pipeline: bool = False,
                 chunk: int = 0, mapping_pipeline=None, device="cuda"):
        from .async_pipeline import AsyncMappingPipeline
        from .kf_database import KeyframeDatabase
        from .local_mapping import LocalMapper
        from .loop_closing import LoopCloser

        for name, value, cls in (("local_mapper", local_mapper, LocalMapper),
                                 ("database", database, KeyframeDatabase),
                                 ("loop_closer", loop_closer, LoopCloser),
                                 ("mapping_pipeline", mapping_pipeline, AsyncMappingPipeline)):
            if value is not None and not isinstance(value, cls):
                raise TypeError(f"Tracker({name}=...) takes this package's {cls.__name__}, "
                                f"not {type(value).__name__}")
        self.local_mapper = local_mapper
        self.database = database
        self.loop_closer = loop_closer
        self.settings = settings
        self.device = torch.device(device)
        self.use_fused = use_fused
        tpu = settings.tpu
        # Async mapping: keyframes insert at once and queue here for the
        # worker (the reference's mlNewKeyFrames, LocalMapping.h:≈110); a
        # keyframe is deferred only when the queue is full (Tracking.cc:≈1050),
        # and made anyway once kf_urgent_gap frames passed since the last
        # one, after a wait of at most kf_urgent_wait_s for the job in flight
        # (InterruptBA).
        self.mapping_pipeline = mapping_pipeline
        self._kf_queue: list = []
        self.kf_queue_depth = tpu.kf_queue_depth
        self.kf_urgent_gap = tpu.kf_urgent_gap
        self.kf_urgent_wait_s = tpu.kf_urgent_wait_s
        self._no_submit = False     # a compaction's drain is in progress
        # Chunked driver.
        self.chunk = int(chunk)
        self._chunk_buf = []        # [inputs, ...] awaiting dispatch
        self._pending_chunk = None  # (fid0, buf, ChunkOut) resolved one chunk late
        self._kf_deferred = False   # a chunk wanted a keyframe while the queue was full
        self._resolving = False
        # Pipelined driver.
        self.pipeline = pipeline
        self.pipeline_depth = 1
        self._pending = None        # [(frame_id, TrackOut), ...] oldest first
        self._next_ctx = None       # the context the next dispatch starts from
        self._fused_sensor = None
        self.cam = settings.camera_model()
        orb = settings.orb
        self.extractor = OrbExtractor(orb, tpu, device=self.device)
        self._init_extractor = None  # mono initialization's, twice the budget
        self.K = torch.tensor([[self.cam.fx, 0.0, self.cam.cx], [0.0, self.cam.fy, self.cam.cy],
                               [0.0, 0.0, 1.0]], dtype=torch.float32, device=self.device)
        self.scale_factors = torch.from_numpy(
            pyr_ops.scale_factors(orb.n_levels, orb.scale_factor)
        ).to(self.device)
        self.inv_sigma2 = torch.from_numpy(
            (1.0 / pyr_ops.level_sigma2(orb.n_levels, orb.scale_factor)).astype(np.float32)
        ).to(self.device)
        self.map = ms.make_empty_map(
            tpu.max_keyframes, tpu.max_points, tpu.max_keypoints, device=self.device,
        )
        self.localization_only = False  # Tracking::InformOnlyTracking
        self.state = TrackState.NOT_INITIALIZED
        self.frame_id = 0
        self.last_frame: Optional[Frame] = None
        self.last_T = torch.eye(4, device=self.device)
        self.last_bindings: Optional[torch.Tensor] = None
        self.velocity: Optional[torch.Tensor] = None
        self.ref_kf = 0
        self.last_kf_frame_id = 0
        self.init_ref: Optional[Frame] = None  # mono initialization's first frame
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        # Host copies of the pool state from the last chunk's read, which
        # pool maintenance uses instead of reading the device again.
        self._host_kf_valid = None
        self._host_n_kf = None
        # Post-relocalization keyframe suppression (Tracking.cc:≈990).
        self._no_kf_before = 0
        # Trajectory: (frame_id, T_cr 4x4, ref_kf, is_lost) per frame.
        self.trajectory = []
        self.n_tracked_history = []
        self.metrics = {
            "frames": 0,
            "frames_lost": 0,
            "relocalizations": 0,
            "keyframes_created": 0,
            "last_inliers": 0,
            "track_path": "",  # motion | refkf | vo | reloc | none
            "host_syncs": 0,
        }

    def _host(self, x: torch.Tensor):
        """Read a device tensor on the host (counted)."""
        self.metrics["host_syncs"] += 1
        return x.tolist()

    # -- frame entry points ------------------------------------------------

    def track_mono(self, image, timestamp: float = 0.0):
        """Track one monocular image; returns the current pose
        (world->camera).  Until the map is initialized each image is
        extracted with twice the feature budget (mpIniORBextractor,
        Tracking.cc:≈150)."""
        return self._track_inputs("mono", (image,))

    def _get_init_extractor(self) -> OrbExtractor:
        """The mono initialization's extractor: twice the features and
        keypoint slots, from cells of 16 px, so that the doubled budget
        comes from more cells, not denser picks in each (near-duplicate
        corners die under the 0.9 ratio test).  Made at the first mono
        frame, with the two-view solver's tables."""
        if self._init_extractor is None:
            import dataclasses

            orb, tpu = self.settings.orb, self.settings.tpu
            self._init_extractor = OrbExtractor(
                dataclasses.replace(orb, n_features=2 * orb.n_features),
                dataclasses.replace(tpu, max_keypoints=2 * tpu.max_keypoints),
                cell=16, device=self.device)
            twoview.prepare(self.device)
        return self._init_extractor

    def track_rgbd(self, image, depth_map, timestamp: float = 0.0):
        """Track one RGB-D frame; returns the current pose (world->camera)."""
        return self._track_inputs("rgbd", (image, depth_map))

    def track_stereo(self, image_left, image_right, timestamp: float = 0.0):
        """Track one rectified stereo pair; returns the current pose
        (world->camera)."""
        return self._track_inputs("stereo", (image_left, image_right))

    def _track_inputs(self, sensor: str, inputs):
        inputs = tuple(torch.as_tensor(x, dtype=torch.float32, device=self.device)
                       for x in inputs)
        if self.state == TrackState.NOT_INITIALIZED:
            self._track(self._build_frame(sensor, inputs, init=True), sensor)
        elif self.use_fused:
            return self._track_fused(sensor, inputs)
        else:
            self._fused_sensor = sensor
            self._track(self._build_frame(sensor, inputs), sensor)
        return self.last_T

    def _build_frame(self, sensor: str, inputs, init: bool = False) -> Frame:
        if sensor == "mono":
            ext = self._get_init_extractor() if init else self.extractor
            return build_mono_frame(inputs[0], ext, self.cam)
        if sensor == "stereo":
            return build_stereo_frame(inputs[0], inputs[1], self.extractor, self.cam,
                                      self.scale_factors)
        return build_rgbd_frame(inputs[0], inputs[1], self.extractor, self.cam,
                                self.settings.camera.depth_map_factor)

    def _track(self, frame: Frame, sensor: str):
        """Tracking::Track on the host.  Until the map is initialized, the
        initialization branch: a mono frame that initializes comes back
        downselected to the keyframes' capacity, and until then
        ``last_frame`` is the doubled-budget frame.  After it, with
        ``use_fused`` False, the step-by-step chain (the reference's
        unfused path, ``Tracker._track``, which it keeps as the fused
        chain's cross-check): the same decisions as
        ``track_fused._fused_track``, each read on the host when it is
        taken.  It ignores ``pipeline`` and ``chunk``."""
        if self.state == TrackState.NOT_INITIALIZED:
            if sensor == "mono":
                frame = self._mono_initialize(frame) or frame
            else:
                self._stereo_initialize(frame)
            self._log_pose()
            self._finish_frame(frame)
            return
        mono = sensor == "mono"

        # Motion model with the doubled-window retry under 20 matches
        # (Tracking.cc:≈880).
        ok = False
        vo = None
        if self.velocity is not None:
            T_pred = self.velocity @ self.last_T
            lf = self.last_frame

            def motion(radius):
                T, b, n_in, n_match, n_tot = track_motion_model(
                    self.map, frame, T_pred, lf.xy, self.last_bindings, lf.level, self.cam,
                    self.scale_factors, self.inv_sigma2, radius, T_last=self.last_T,
                    last_angle=lf.angle, baseline=None if mono else self.cam.baseline,
                    last_depth=None if mono else lf.depth, last_desc=lf.desc,
                    last_valid=lf.valid, temp_depth_cap=self._th_depth(),
                    use_temp=self.localization_only and not mono,
                )
                return T, b, *self._host(torch.stack([n_in, n_match, n_tot.to(n_in.dtype)]))

            th = 15.0 if mono else 7.0
            T, b, n_in, n_match, n_tot = motion(th)
            if n_match < 20:
                T, b, n_in, n_match, n_tot = motion(2.0 * th)
            ok = n_in >= 10
            # Localization-only VO candidate (mbVO, Tracking.cc:≈900): enough
            # map and temporary inliers to dead-reckon if the map fails.
            if self.localization_only and n_tot >= 20:
                vo = (T, b, n_tot)
        used_motion = ok
        if not ok:
            T, b, n_in = self._track_ref_kf(frame)
            ok = n_in >= 10
        weak = len(self.n_tracked_history) == 0 or self.n_tracked_history[-1] < 50
        if ok:
            T, b, n_in = self._track_local_map(frame, T, b, 2.0 if weak else 1.0)
            ok = n_in >= 30
        if not ok and used_motion:
            # The motion-model pose failed the local map: one chance from
            # the reference keyframe, gated on the final inlier count.
            T, b, n_in = self._track_ref_kf(frame)
            if n_in >= 6:
                T, b, n_in = self._track_local_map(frame, T, b, 2.0)
                ok = n_in >= 30
        vo_fired = not ok and vo is not None
        if vo_fired:
            T, b, n_in = vo
            ok = used_motion = True

        self.metrics["frames"] += 1
        self.metrics["track_path"] = ("vo" if vo_fired else "motion" if used_motion and ok
                                      else "refkf" if ok else "none")
        created = False
        if ok:
            self.state = TrackState.OK
            T = orthonormalize_se3(T)
            self.velocity = T @ se3_inverse(self.last_T)
            self.last_T = T
            self.n_tracked_history.append(n_in)
            self.metrics["last_inliers"] = n_in
            if self._need_new_keyframe(frame, b, n_in, sensor) and self._kf_gate():
                self._create_keyframe(frame, T, b)
                created = True
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.metrics["frames_lost"] += 1

        if (self.state == TrackState.LOST or vo_fired) and self.database is not None:
            ok_reloc, T_r, b_r, n_r = self._relocalize(frame)
            if ok_reloc:
                b = b_r
                self.state = TrackState.OK
                self.last_T = T_r
                self.velocity = None
                self.n_tracked_history.append(n_r)
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()

        self._log_pose()
        self.metrics["host_syncs"] += 2  # the pose log's reads
        # A keyframe's bindings were stored by _create_keyframe, with its
        # spawned points and scrubbed after mapping.
        self._finish_frame(frame, b if (ok and not created) else None)

    def _track_ref_kf(self, frame: Frame):
        T, b, n_in, _ = track_reference_keyframe(self.map, frame, self.ref_kf, self.last_T,
                                                 self.inv_sigma2, self.cam)
        return T, b, self._host(n_in)

    def _track_local_map(self, frame: Frame, T, b, rmult: float):
        local_ids, local_valid = gather_local_points(self.map, b,
                                                     n_local_kfs=self.settings.tpu.local_window)
        T, b, n_in, self.map = track_local_map(self.map, frame, T, b, local_ids, local_valid,
                                               self.cam, self.scale_factors, self.inv_sigma2,
                                               rmult)
        return T, b, self._host(n_in)

    def _need_new_keyframe(self, frame: Frame, bindings, n_inliers: int, sensor: str) -> bool:
        """Tracking::NeedNewKeyFrame (Tracking.cc:≈980) on the host, as
        ``track_fused._fused_track``'s policy block computes it: (c1a ||
        c1b || c1c) && c2 over the reference keyframe's points with at least
        ``min_obs`` observers (3 above two keyframes, 2 with two, 1 with
        one), close-point starvation for stereo and RGB-D, no keyframe in
        localization-only mode, near a full pool or within 10 frames of a
        relocalization.  The queue conditions are ``_kf_gate``'s.  One read."""
        if self.localization_only or self.frame_id < self._no_kf_before:
            return False
        m = self.map
        obs_counts = ms.point_observation_counts(m)
        ref_pid = m.kf_point[self.ref_kf]
        ref_bound = (ref_pid >= 0) & m.kf_kp_valid[self.ref_kf]
        ref_obs = torch.where(ref_bound, obs_counts[ref_pid.clamp(min=0).long()], 0)
        close = (frame.depth > 0) & (frame.depth < self._th_depth())
        reads = self._host(torch.cat([
            torch.stack([m.n_kf.to(torch.int32), (close & (bindings >= 0)).sum().to(torch.int32),
                         (close & frame.valid).sum().to(torch.int32)]),
            torch.stack([(ref_obs >= k).sum().to(torch.int32) for k in (1, 2, 3)]),
        ]))
        n_kf, n_close_tracked, n_close_total = reads[:3]
        if n_kf >= m.kf_capacity - 1:
            return False
        min_obs = 3 if n_kf > 2 else (2 if n_kf > 1 else 1)
        kf_tracked = reads[2 + min_obs]
        mono = sensor == "mono"
        close_starved = not mono and n_close_tracked < 100 and n_close_total > 70
        frames_since = self.frame_id - self.last_kf_frame_id
        tpu = self.settings.tpu
        c1a = frames_since >= tpu.kf_max_gap
        c1b = frames_since >= tpu.kf_busy_frames
        c1c = not mono and (n_inliers < 0.25 * kf_tracked or close_starved)
        c2 = (n_inliers < (0.9 if mono else 0.75) * kf_tracked or close_starved) and n_inliers > 15
        return (c1a or c1b or c1c) and c2 and frames_since >= 1

    # -- fused per-frame path ------------------------------------------------

    def _make_ctx(self):
        from .track_fused import TrackCtx

        has_vel = self.velocity is not None
        lf = self.last_frame
        return TrackCtx(
            T_last=self.last_T,
            velocity=self.velocity if has_vel else torch.eye(4, device=self.device),
            has_velocity=has_vel,
            last_xy=lf.xy,
            last_level=lf.level,
            last_bindings=self.last_bindings,
            ref_kf=self.ref_kf,
            weak=len(self.n_tracked_history) == 0 or self.n_tracked_history[-1] < 50,
            frames_since_kf=self.frame_id - self.last_kf_frame_id,
            last_depth=lf.depth,
            last_desc=lf.desc,
            last_valid=lf.valid,
            only_tracking=self.localization_only,
            last_angle=lf.angle,
        )

    def _step(self, frame: Frame, ctx):
        """One frame of the Track() chain on the map."""
        from .track_fused import _fused_track

        tpu = self.settings.tpu
        out = _fused_track(
            self.map, frame, ctx, self.cam, self.scale_factors, self.inv_sigma2,
            self._th_depth(), local_window=tpu.local_window, kf_max_gap=tpu.kf_max_gap,
            kf_busy_frames=tpu.kf_busy_frames, sensor=self._fused_sensor,
        )
        self.metrics["host_syncs"] += out.host_syncs
        return out

    def _track_fused(self, sensor: str, inputs):
        from .track_fused import FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH

        self._fused_sensor = sensor
        if self.chunk > 1:
            return self._track_fused_chunked(sensor, inputs)
        if self.pipeline:
            return self._track_fused_pipelined(sensor, inputs)

        self._poll_adopt()
        frame = self._build_frame(sensor, inputs)
        out = self._step(frame, self._make_ctx())
        self.map = out.m
        flags = self._host(out.flags)  # the per-frame decision readback
        ok = bool(flags[FLAG_OK])
        n_in = int(flags[FLAG_N_INLIERS])
        # No keyframe within 10 frames of a relocalization (Tracking.cc:≈990).
        need_kf = bool(flags[FLAG_NEED_KF]) and self.frame_id >= self._no_kf_before
        path = int(flags[FLAG_PATH])

        self.metrics["frames"] += 1
        self.metrics["track_path"] = _PATHS[path]
        created = False
        if ok:
            self.state = TrackState.OK
            self.velocity = out.velocity
            self.last_T = out.T_cw
            self.n_tracked_history.append(n_in)
            self.metrics["last_inliers"] = n_in
            if need_kf and not self.localization_only and self._kf_gate():
                self._create_keyframe(frame, out.T_cw, out.bindings)
                created = True
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.metrics["frames_lost"] += 1

        # Relocalize LOST frames, and visual-odometry frames too (mbVO:
        # the reference prefers a relocalization, Tracking.cc:≈420).
        relocated = False
        if (self.state == TrackState.LOST or path == 3) and self.database is not None:
            ok_reloc, T, _, n_r = self._relocalize(frame)
            if ok_reloc:
                self.state = TrackState.OK
                self.last_T = T
                self.velocity = None
                self.n_tracked_history.append(n_r)
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()
                relocated = True

        if created or relocated:
            self._log_pose()
        else:
            self.trajectory.append(
                (self.frame_id, out.T_cr, self.ref_kf, self.state != TrackState.OK)
            )
        self._finish_frame(frame, out.bindings if (ok and not created and not relocated)
                           else None)
        return self.last_T

    # -- pipelined path (frame k resolved after frame k+1 is tracked) ------

    def _track_fused_pipelined(self, sensor: str, inputs):
        self._poll_adopt()
        frame = self._build_frame(sensor, inputs)
        ctx = self._next_ctx if self._next_ctx is not None else self._make_ctx()
        out = self._step(frame, ctx)
        self.map = out.m
        self._next_ctx = out.next_ctx
        fid = self.frame_id
        self.frame_id += 1
        self.last_frame = out.frame
        if self._pending is None:
            self._pending = []
        self._pending.append((fid, out))
        while len(self._pending) > self.pipeline_depth:
            # Resolve the oldest frame in flight.
            self._resolve_pending(self._pending.pop(0), sensor)
        self.last_T = out.T_cw  # the best current estimate (unresolved)
        return out.T_cw

    def flush(self):
        """Resolve every frame in flight, then drain the mapping worker and
        its queue (call at the end of a sequence or before exporting the
        trajectory)."""
        sensor = self._fused_sensor
        if self._pending_chunk is not None:
            pc, self._pending_chunk = self._pending_chunk, None
            self._resolve_chunk(sensor, *pc)
        if self._chunk_buf:
            # The tail of a chunked run (fewer than C frames buffered) goes
            # through the pipelined single-frame path on the chained ctx.
            buf, self._chunk_buf = self._chunk_buf, []
            for inputs in buf:
                self._track_fused_pipelined(sensor, inputs)
        pending, self._pending = self._pending, None
        for p in pending or []:
            self._resolve_pending(p, sensor)
        if self.mapping_pipeline is not None:
            # The job in flight, then each queued keyframe (every adoption
            # submits the next).
            self._adopt(self.mapping_pipeline.wait())
            while self._kf_queue or not self.mapping_pipeline.accept_keyframes():
                self._submit_next_kf()
                self._adopt(self.mapping_pipeline.wait())

    def _resolve_pending(self, pending, sensor: str):
        from .track_fused import FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH

        fid, out = pending
        flags = self._host(out.flags)
        ok = bool(flags[FLAG_OK])
        n_in = int(flags[FLAG_N_INLIERS])
        # No keyframe within 10 frames of a relocalization (Tracking.cc:≈990).
        need_kf = bool(flags[FLAG_NEED_KF]) and self.frame_id >= self._no_kf_before
        path = int(flags[FLAG_PATH])
        self.metrics["frames"] += 1
        self.metrics["track_path"] = _PATHS[path]

        ref_at_dispatch = out.next_ctx.ref_kf
        if ok:
            self.state = TrackState.OK
            self.last_T = out.T_cw
            self.n_tracked_history.append(n_in)
            self.metrics["last_inliers"] = n_in
            self.trajectory.append((fid, out.T_cr, ref_at_dispatch, False))
            if need_kf and not self.localization_only and not self._kf_gate():
                need_kf = False  # deferred: the mapping queue is full
            if path == 3 and self.database is not None:
                # Visual odometry: try to re-anchor to the map (mbVO's
                # parallel relocalization, Tracking.cc:≈420).
                ok_r, T, _, n_r = self._relocalize(out.frame)
                if ok_r:
                    self.last_T = T
                    self.metrics["relocalizations"] += 1
                    self.metrics["track_path"] = "reloc"
                    if self._next_ctx is not None:
                        # Re-anchor at the relocalized pose but keep the
                        # measured VO velocity: the camera still moves, and
                        # an identity prediction would put the next frame's
                        # temporary-point projections outside the window.
                        self._next_ctx = self._next_ctx._replace(
                            T_last=T, has_velocity=True, velocity=out.velocity,
                            last_bindings=self.last_bindings, ref_kf=self.ref_kf,
                        )
            if need_kf and not self.localization_only:
                self._create_keyframe(out.frame, out.T_cw, out.bindings, frame_id=fid)
                # Keyframe events are the only host writes into the chained
                # context: the new reference keyframe, the gap counter, and
                # the bindings scrubbed against the post-mapping pool.
                if self._next_ctx is not None:
                    self._next_ctx = self._next_ctx._replace(
                        ref_kf=self.ref_kf,
                        frames_since_kf=self.frame_id - self.last_kf_frame_id,
                        last_bindings=self._scrub(self._next_ctx.last_bindings),
                    )
            return

        self.state = TrackState.LOST
        self.metrics["frames_lost"] += 1
        relocated = False
        if self.database is not None:
            ok_r, T, bindings_r, n_r = self._relocalize(out.frame)
            if ok_r:
                self.state = TrackState.OK
                self.last_T = T
                self.n_tracked_history.append(n_r)
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()
                relocated = True
                if self._next_ctx is not None:
                    # Re-anchor the chain at the relocalized pose with its
                    # bindings and identity velocity: the next frame
                    # motion-tracks the matches relocalization verified.
                    self._next_ctx = self._next_ctx._replace(
                        T_last=T, has_velocity=True,
                        velocity=torch.eye(4, dtype=torch.float32, device=self.device),
                        last_bindings=bindings_r, ref_kf=self.ref_kf,
                    )
        if relocated:
            # Log the relocalized pose (relative to the new reference
            # keyframe), not the tracked one.
            self.trajectory.append((fid, self._relative_to_ref(T), self.ref_kf, False))
        else:
            self.trajectory.append((fid, out.T_cr, ref_at_dispatch, True))

    # -- chunked path (C frames per call) -----------------------------------

    def _track_fused_chunked(self, sensor: str, inputs):
        self._chunk_buf.append(tuple(inputs))
        if len(self._chunk_buf) >= self.chunk:
            self._dispatch_chunk(sensor)
        return self.last_T

    def _dispatch_chunk(self, sensor: str):
        from .track_fused import make_fused_chunk_tracker

        # Lag policy: while a mapping job is in flight, the previous chunk is
        # resolved after this one is tracked (keyframes are deferred then
        # anyway); otherwise first, so that a keyframe it holds starts its
        # mapping job now (one more chunk of mapping lag costs drift on
        # fast turns).  flush() resolves the last one.
        mp = self.mapping_pipeline
        self._poll_adopt()
        if self._pending_chunk is not None and (mp is None or mp.accept_keyframes()):
            pc, self._pending_chunk = self._pending_chunk, None
            self._resolve_chunk(sensor, *pc)
            self._poll_adopt()

        buf, self._chunk_buf = self._chunk_buf, []
        fid0 = self.frame_id
        self.frame_id += len(buf)
        self.metrics["chunks"] = self.metrics.get("chunks", 0) + 1
        # With the keyframe queue full the chunk makes no keyframe
        # (SetAcceptKeyFrames(false)), unless the gap is urgent or the last
        # chunk wanted one: then the job in flight is waited for, bounded
        # (InterruptBA); a job that overruns the wait only defers keyframes
        # further, it never stalls the frame cadence.
        allow_kf = not self.localization_only
        if mp is not None and len(self._kf_queue) >= self.kf_queue_depth:
            if self._kf_deferred or fid0 - self.last_kf_frame_id >= self.kf_urgent_gap:
                self._kf_deferred = False  # armed again by the next chunk's need
                res = mp.wait(timeout=self.kf_urgent_wait_s)
                if res is not None:
                    self._adopt(res)
                else:
                    allow_kf = False
            else:
                allow_kf = False
        ctx = self._next_ctx if self._next_ctx is not None else self._make_ctx()
        tpu = self.settings.tpu
        step = make_fused_chunk_tracker(
            lambda inputs: self._build_frame(sensor, inputs), self.cam, self.scale_factors,
            self.inv_sigma2, self._th_depth(), local_window=tpu.local_window,
            kf_max_gap=tpu.kf_max_gap, kf_busy_frames=tpu.kf_busy_frames, sensor=sensor,
        )
        # 2**30 makes no keyframe in this chunk; otherwise the
        # post-relocalization threshold (Tracking.cc:≈990).
        min_kf_fid = (2**30) if not allow_kf else self._no_kf_before
        out = step(*zip(*buf), self.map, ctx, fid0, min_kf_fid)
        self.metrics["host_syncs"] += out.host_syncs
        self.map = out.m
        self._next_ctx = out.next_ctx
        prev, self._pending_chunk = self._pending_chunk, (fid0, buf, out)
        if prev is not None:
            self._resolve_chunk(sensor, *prev)

    def _resolve_chunk(self, sensor: str, fid0: int, buf, out):
        self._resolving = True
        try:
            return self._resolve_chunk_inner(sensor, fid0, buf, out)
        finally:
            self._resolving = False

    def _resolve_chunk_inner(self, sensor: str, fid0: int, buf, out):
        from .kf_database import fetch
        from .track_fused import FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH

        # One read per chunk: flags, relative poses and the pool state.
        flags, T_cr, kf_valid_np, n_kf_np = fetch([out.flags, out.T_cr, out.kf_valid, out.n_kf])
        self.metrics["host_syncs"] += 1
        self._host_kf_valid = kf_valid_np
        self._host_n_kf = int(n_kf_np)
        log_ref, kf_ids = out.log_ref, out.kf_id

        mapped = False
        for j in range(len(buf)):
            fid = fid0 + j
            ok = bool(flags[j, FLAG_OK])
            n_in = int(flags[j, FLAG_N_INLIERS])
            path = int(flags[j, FLAG_PATH])
            kid = int(kf_ids[j])
            self.metrics["frames"] += 1
            self.metrics["track_path"] = _PATHS[path]
            if ok:
                self.state = TrackState.OK
                self.last_T = out.T_cw[j]
                self.n_tracked_history.append(n_in)
                self.metrics["last_inliers"] = n_in
            else:
                self.state = TrackState.LOST
                self.metrics["frames_lost"] += 1
            self.trajectory.append((fid, T_cr[j], int(log_ref[j]), not ok))
            if kid < 0 and bool(flags[j, FLAG_NEED_KF]) and ok:
                # The policy wanted a keyframe but the chunk was gated: give
                # the next dispatch's urgent wait a reason to drain the job.
                self._kf_deferred = True
            if kid >= 0:
                # The chunk inserted the keyframe; the host half: the
                # place-recognition index, local mapping and loop closing
                # (the reference's LocalMapping queue, <= C frames of lag).
                self.metrics["keyframes_created"] += 1
                self._kf_deferred = False
                self.ref_kf = kid
                self.last_kf_frame_id = fid
                if self.database is not None:
                    self.database.add_keyframe(kid, self.map.kf_desc[kid],
                                               self.map.kf_kp_valid[kid])
                if self.mapping_pipeline is not None:
                    self._kf_queue.append(kid)
                    self._submit_next_kf()
                elif self.local_mapper is not None:
                    self.map = self.local_mapper.process_keyframe(self.map, kid)
                    mapped = True
                if self.mapping_pipeline is None and self.loop_closer is not None:
                    self._close_loops(kid)

        if mapped:
            # Mapping may have culled points whose slots are reused later:
            # scrub the chained bindings.
            self._next_ctx = self._next_ctx._replace(
                last_bindings=self._scrub(self._next_ctx.last_bindings))
            self._reanchor_culled_refs()
            self._maybe_compact()

        last_vo = int(flags[-1, FLAG_PATH]) == 3
        ok_col = flags[:, FLAG_OK].astype(bool)
        if not ok_col.all() and not ok_col[int(np.argmax(~ok_col)):].any():
            # Lost inside the chunk and never recovered in it: relocalize at
            # the losing frame and requeue the rest of the chunk, so those
            # frames are tracked again from the relocalized state.
            j_r = int(np.argmax(~ok_col))
        elif self.state == TrackState.LOST or last_vo:
            # Lost at the chunk's end (maybe after a recovery in it), or
            # visual odometry: relocalize on the last frame.
            j_r = len(buf) - 1
        else:
            j_r = -1
        if j_r >= 0 and self.database is not None:
            # The frame is built again from its inputs.  As the reference
            # relocalizes every frame until it succeeds (Tracking.cc:≈1290),
            # walk forward through the lost frames until one relocalizes.
            ok_r = False
            while j_r < len(buf):
                frame = self._build_frame(sensor, buf[j_r])
                ok_r, T, bindings_r, n_r = self._relocalize(frame)
                if ok_r or ok_col[j_r:].any():
                    break
                j_r += 1
            if ok_r:
                # A next chunk may be in flight, tracked from the lost
                # context.  If it made no keyframe (the common case: a
                # keyframe needs an OK frame), it is dropped and its frames
                # requeued after this chunk's tail; if it made one, it
                # recovered by itself and is kept, and nothing is rewound.
                extra = []
                pend_recovered = False
                if self._pending_chunk is not None:
                    _, pbuf, pout = self._pending_chunk
                    if (pout.kf_id >= 0).any():
                        pend_recovered = True
                    else:
                        self._pending_chunk = None
                        extra = list(pbuf)
                        self.frame_id -= len(pbuf)
                n_requeue = (len(buf) - 1 - j_r) if not pend_recovered else 0
                if n_requeue > 0:
                    # Rewind the lost tail: its frames are tracked again
                    # from the relocalized ctx with the next dispatch.  Their
                    # first pass's visibility statistics stay counted (a
                    # double count of few points, as in the reference).
                    del self.trajectory[-n_requeue:]
                    self.frame_id -= n_requeue
                    self.metrics["frames"] -= n_requeue
                    self.metrics["frames_lost"] -= int((~ok_col[j_r + 1:]).sum())
                    self._chunk_buf = list(buf[j_r + 1:]) + extra + self._chunk_buf
                elif extra:
                    self._chunk_buf = extra + self._chunk_buf
                self.state = TrackState.OK
                self.last_T = T
                self.n_tracked_history.append(n_r)
                self.metrics["relocalizations"] += 1
                self.metrics["track_path"] = "reloc"
                self._mark_reloc()
                self.trajectory[-1] = (self.trajectory[-1][0], self._relative_to_ref(T),
                                       self.ref_kf, False)
                # Identity-velocity continuation from the relocalization's
                # bindings, unless the chunk in flight recovered by itself
                # (its chained context is live).
                if not pend_recovered:
                    self._next_ctx = self._next_ctx._replace(
                        T_last=T, has_velocity=True,
                        velocity=torch.eye(4, dtype=torch.float32, device=self.device),
                        last_bindings=bindings_r, last_xy=frame.xy, last_level=frame.level,
                        last_depth=frame.depth, last_desc=frame.desc, last_valid=frame.valid,
                        last_angle=frame.angle, ref_kf=self.ref_kf,
                    )

    # -- relocalization ------------------------------------------------------

    def _ransac_samples(self, valid: torch.Tensor, iters: int, k: int) -> torch.Tensor:
        """(iters, k) RANSAC sample indices from the tracker's generator."""
        return pnp.draw_samples(valid, iters, k, self.generator)

    def _mark_reloc(self):
        """No keyframe insertion for 10 frames after a relocalization on a
        map of more than 10 keyframes (Tracking.cc:≈990: right after it
        the pose is anchored to old keyframes, and inserting at once would
        duplicate them).  The chunked path uses the keyframe count of its
        last read."""
        n_kf = self._host_n_kf if self._host_n_kf is not None else self._host(self.map.n_kf)
        if n_kf > 10:
            self._no_kf_before = self.frame_id + 10

    def _relocalize(self, frame: Frame):
        """Tracking::Relocalization (Tracking.cc:≈1310): BoW candidates ->
        matching + P3P RANSAC + pose polish per candidate -> local-map
        top-up; accepted at 30 local inliers.  A candidate whose first pass
        fails with at least 8 matches is tried again with a looser ratio
        (0.9), no node gate and 8192 hypotheses, at most 3 times a call (the
        analog of the reference's widened SearchByProjection retry,
        ≈1370).  Reads the device once for the candidates and once per
        attempt: LOST frames only."""
        db = self.database
        syncs0 = db.host_syncs
        cands = db.detect_relocalization_candidates(self.map, frame.desc, frame.valid)
        self.metrics["host_syncs"] += db.host_syncs - syncs0
        frame_nodes = db.frame_nodes(frame.desc, frame.valid) if len(cands) else None
        retries_left = 3
        for c in cands.tolist():
            T, bindings, n_in, n_match, pnp_ok = relocalize_candidate(
                self.map, frame, c, self.inv_sigma2, self.cam, self._ransac_samples,
                kf_nodes=db.nodes_for(c), frame_nodes=frame_nodes,
            )
            ok_h, n_in_h, n_match_h = self._host(torch.stack([pnp_ok.to(n_in.dtype), n_in,
                                                              n_match.to(n_in.dtype)]))
            if (not ok_h or n_in_h < 10) and n_match_h >= 8 and retries_left > 0:
                retries_left -= 1
                T, bindings, n_in, n_match, pnp_ok = relocalize_candidate(
                    self.map, frame, c, self.inv_sigma2, self.cam, self._ransac_samples,
                    ratio=0.9, pnp_iters=8192,
                )
                ok_h, n_in_h = self._host(torch.stack([pnp_ok.to(n_in.dtype), n_in]))
            if not ok_h or n_in_h < 10:
                continue
            local_ids, local_valid = gather_local_points(
                self.map, bindings, n_local_kfs=self.settings.tpu.local_window)
            T, bindings, n_in, self.map = track_local_map(
                self.map, frame, T, bindings, local_ids, local_valid,
                self.cam, self.scale_factors, self.inv_sigma2,
            )
            n_in_h = self._host(n_in)
            if n_in_h >= 30:
                self.ref_kf = c
                self.last_bindings = bindings
                return True, T, bindings, n_in_h
        return False, None, None, 0

    # -- initialization and keyframes ----------------------------------------

    @staticmethod
    def _downselect_frame(frame: Frame, bindings: torch.Tensor, n_out: int):
        """The ``n_out`` best slots of a doubled-budget initialization frame:
        bound (triangulated) keypoints first, then by response, in a stable
        float64 order on the host (equal keys keep their slot order), as
        the reference does.  One read, at initialization only."""
        bound, valid, resp = (t.cpu().numpy() for t in (bindings >= 0, frame.valid,
                                                        frame.response))
        resp = resp.astype(np.float64)
        rmax = float(resp.max()) + 1.0
        key = bound.astype(np.float64) * (2.0 * rmax) + np.where(valid, resp, -rmax)
        sel = torch.from_numpy(np.argsort(-key, kind="stable")[:n_out]).to(bindings.device)
        return Frame(*(a[sel] for a in frame)), bindings[sel]

    def _mono_initialize(self, frame: Frame) -> Optional[Frame]:
        """MonocularInitialization + CreateInitialMapMonocular
        (Tracking.cc:≈560-740).  The first frame with more than
        ``min_init_matches`` features becomes the reference; a later one is
        matched to it (a new reference when too few matches) and the two
        views reconstructed.  On success the points are scaled to median
        depth 1, both frames are downselected to the keyframes' capacity and
        inserted as keyframes 0 (identity) and 1, both enter the keyframe
        database, and the local mapper refines the initial map; the current
        frame is returned downselected.  Reads: the feature count, the
        match count and the outcome per attempt, and the keyframe ids and
        the downselection on success."""
        min_m = self.settings.tpu.min_init_matches
        n_valid = self._host(frame.valid.sum())
        if self.init_ref is None or n_valid <= min_m:
            if n_valid > min_m:
                self.init_ref = frame
            return None
        mres = matcher.search_for_initialization(self.init_ref.features, frame.features)
        if self._host(mres.ok.sum()) < min_m:
            self.init_ref = frame  # the reference's re-seeding
            return None
        iters = 256
        res = twoview.initialize_two_view(
            self.init_ref.xy, frame.xy[mres.idx], mres.ok, self.K,
            samples=self._ransac_samples(mres.ok, iters, 8), iters=iters)
        if not self._host(res.success):
            return None

        # Scale to median scene depth 1 (CreateInitialMapMonocular,
        # Tracking.cc:≈640).
        good = res.good
        scale = median_depth_scale(res.points, good)
        pts = res.points * scale
        T21 = torch.cat([torch.cat([res.T21[:3, :3], res.T21[:3, 3:] * scale], 1),
                         res.T21[3:]], 0)

        # Keyframe 0 at the identity with the reference frame, keyframe 1 at
        # T21 with the current one.
        m, pids = add_points(self.map, pts, self.init_ref.desc, good, 0, reverse=True)
        bind0 = torch.where(good, pids, NO_POINT)
        bind1 = init_bindings(frame.xy.shape[0], mres.idx, mres.ok & good, pids)
        N = self.settings.tpu.max_keypoints
        ref_n, bind0_n = self._downselect_frame(self.init_ref, bind0, N)
        cur_n, bind1_n = self._downselect_frame(frame, bind1, N)
        self.metrics["host_syncs"] += 2
        m, kf0 = insert_keyframe(m, ref_n, torch.eye(4, device=self.device),
                                 self.frame_id - 1, bind0_n, -1)
        m, kf1 = insert_keyframe(m, cur_n, T21, self.frame_id, bind1_n, 0)
        self.map = ms.update_point_stats(m, self.scale_factors)
        kf0, kf1 = self._host(torch.stack([kf0, kf1]))
        if self.database is not None:
            self.database.add_keyframe(kf0, ref_n.desc, ref_n.valid)
            self.database.add_keyframe(kf1, cur_n.desc, cur_n.valid)
        self.ref_kf = kf1
        self.last_T = T21
        self.last_bindings = bind1_n
        self.velocity = None
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.map = self.local_mapper.on_initial_map(self.map)
        return cur_n

    def _stereo_initialize(self, frame: Frame):
        # StereoInitialization's N>500 gate (Tracking.cc:≈500), scaled to
        # half the capacity for capacities below 1000.
        cap = int(frame.valid.shape[0])
        gate = 500 if cap >= 1000 else max(20, cap // 2)
        n_depth, n_valid = self._host(
            torch.stack([((frame.depth > 0) & frame.valid).sum(), frame.valid.sum()])
        )
        if n_depth < gate and n_valid < gate:
            return
        T0 = torch.eye(4, device=self.device)
        pos_w, ok = unproject_frame_depth(frame, T0, self.cam)
        m, pids = add_points(self.map, pos_w, frame.desc, ok, 0, reverse=True)
        bind = torch.where(ok, pids, NO_POINT)
        m, kf0 = insert_keyframe(m, frame, T0, self.frame_id, bind, -1)
        self.map = ms.update_point_stats(m, self.scale_factors)
        self.ref_kf = self._host(kf0)
        if self.database is not None:
            self.database.add_keyframe(self.ref_kf, frame.desc, frame.valid)
        self.last_T = T0
        self.last_bindings = bind
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id

    def _th_depth(self) -> float:
        c = self.settings.camera
        return c.th_depth * c.bf / c.fx if c.bf > 0 else 1e9


    def _create_keyframe(self, frame: Frame, T, bindings, frame_id: Optional[int] = None):
        """Insert the frame (``frame_id``, default the current one) as a
        keyframe, spawning close-depth points for its unbound keypoints
        (Tracking.cc:≈1060; not for mono), and add it to the keyframe database.  With a
        mapping pipeline the keyframe is queued for the worker and tracking
        goes on with its map; otherwise the local mapper and the loop
        closer run on it now, in that order.  Mapping and the loop
        correction's fuse may retire points whose slots are reused later,
        so the held bindings are scrubbed against the pool; with a local
        mapper, trajectory entries of culled keyframes are re-anchored;
        the pool is compacted when it nears capacity."""
        fid = self.frame_id if frame_id is None else frame_id
        m = self.map
        if self._fused_sensor != "mono":
            pos_w, ok = unproject_frame_depth(frame, T, self.cam)
            ok = ok & (bindings < 0) & (frame.depth < self._th_depth())
            m, pids = add_points(m, pos_w, frame.desc, ok, m.n_kf, reverse=True)
            bindings = torch.where(ok & (pids >= 0), pids, bindings)
        m, kf_id = insert_keyframe(m, frame, T, fid, bindings, self.ref_kf)
        self.map = ms.update_point_stats(m, self.scale_factors)
        self.metrics["keyframes_created"] += 1
        self.ref_kf = self._host(kf_id)
        self.last_kf_frame_id = fid
        self.last_bindings = bindings
        if self.database is not None:
            self.database.add_keyframe(self.ref_kf, frame.desc, frame.valid)
        if self.mapping_pipeline is not None:
            # The reference's LocalMapping queue: tracking keeps its map,
            # which holds the new keyframe; the worker maps a snapshot.
            self._kf_queue.append(self.ref_kf)
            self._submit_next_kf()
            return
        if self.local_mapper is None and self.loop_closer is None:
            return
        if self.local_mapper is not None:
            self.map = self.local_mapper.process_keyframe(self.map, self.ref_kf)
        if self.loop_closer is not None:
            self._close_loops(self.ref_kf)
        self.last_bindings = self._scrub(bindings)
        pool = self._host(torch.cat([self.map.kf_valid.to(torch.int32), self.map.n_kf.view(1)]))
        kf_valid = np.array(pool[:-1], dtype=bool)
        if self.local_mapper is not None:
            self._reanchor_culled_refs(kf_valid)
        self._maybe_compact(pool[-1])

    def _close_loops(self, kf_id: int):
        """The loop closer on keyframe ``kf_id``, in line."""
        lc = self.loop_closer
        syncs0 = lc.host_syncs
        self.map = lc.process_keyframe(self.map, kf_id)
        self.metrics["host_syncs"] += lc.host_syncs - syncs0

    def _scrub(self, bindings: torch.Tensor) -> torch.Tensor:
        """``bindings`` with every point the pool no longer holds unbound."""
        return torch.where((bindings >= 0) & self.map.pt_valid[bindings.clamp(min=0).long()],
                           bindings, NO_POINT)

    # -- async mapping: the keyframe queue and adoption ----------------------

    def _kf_gate(self) -> bool:
        """May a keyframe be made now?  Yes while the keyframe queue has
        room; at the urgent gap, after adopting the job in flight with a
        bounded wait (InterruptBA), if that made room.  A job that overruns
        the wait only defers the keyframe (SetAcceptKeyFrames(false))."""
        mp = self.mapping_pipeline
        if mp is None or len(self._kf_queue) < self.kf_queue_depth:
            return True
        if self.frame_id - self.last_kf_frame_id >= self.kf_urgent_gap:
            res = mp.wait(timeout=self.kf_urgent_wait_s)
            if res is not None:
                self._adopt(res)
            if len(self._kf_queue) < self.kf_queue_depth:
                return True
        return False

    def _poll_adopt(self):
        if self.mapping_pipeline is not None:
            self._adopt(self.mapping_pipeline.poll())

    def _adopt(self, result):
        """Adopt a finished mapping job: merge what tracking changed since
        its snapshot (``async_pipeline.adopt_mapped_state``), move the
        tracker's poses through the job keyframe's pose delta (the
        reference's UpdateLastFrame refresh, Tracking.cc:≈810; the velocity
        is invariant to it) and scrub the held bindings against the new
        pool.  Adoption reads the device only when no pool state came with
        the job (the loop closer's detection read) or from the last chunk."""
        if result is None:
            return
        from .async_pipeline import adopt_mapped_state

        mapped, snapshot, job_kf, pool_state = result
        new_map = adopt_mapped_state(mapped, snapshot, self.map, job_kf)
        R = torch.where(new_map.kf_valid[job_kf],
                        se3_inverse(snapshot.kf_pose_cw[job_kf]) @ new_map.kf_pose_cw[job_kf],
                        torch.eye(4, dtype=torch.float32, device=self.device))
        self.map = new_map
        self.last_T = self.last_T @ R
        if self.last_bindings is not None:
            self.last_bindings = self._scrub(self.last_bindings)
        if self._next_ctx is not None:
            self._next_ctx = self._next_ctx._replace(
                last_bindings=self._scrub(self._next_ctx.last_bindings),
                T_last=self._next_ctx.T_last @ R,
            )
        if pool_state is not None:
            kf_valid, n_kf = pool_state
        elif self._host_kf_valid is not None:
            # The last chunk's copy, at most a chunk old: keyframe slots are
            # reused only by compaction, which drains and reads again.
            kf_valid, n_kf = self._host_kf_valid, self._host_n_kf
        else:
            pool = self._host(torch.cat([self.map.kf_valid.to(torch.int32),
                                         self.map.n_kf.view(1)]))
            kf_valid, n_kf = np.array(pool[:-1], dtype=bool), pool[-1]
        self._reanchor_culled_refs(kf_valid=np.asarray(kf_valid, dtype=bool))
        self._maybe_compact(n_kf=int(n_kf))
        self._submit_next_kf()

    def _submit_next_kf(self):
        """Hand the oldest queued keyframe to the mapping worker (the
        LocalMapping thread popping mlNewKeyFrames)."""
        mp = self.mapping_pipeline
        if self._no_submit:
            return  # a compaction's drain: the ids are about to be remapped
        if mp is not None and self._kf_queue and mp.accept_keyframes():
            mp.submit(self.map, self._kf_queue.pop(0))

    # -- keyframe-pool maintenance -------------------------------------------

    def _reanchor_culled_refs(self, kf_valid: Optional[np.ndarray] = None):
        """Re-anchor trajectory entries whose reference keyframe was culled
        to its nearest valid ancestor, while the culled pose is still that
        of the live map (the reference replays bad keyframes through their
        spanning-tree parents at save time, System.cc:≈270).  ``kf_valid``
        is the host copy of ``map.kf_valid`` when the caller has one."""
        if kf_valid is None:
            kf_valid = np.array(self._host(self.map.kf_valid), dtype=bool)
        refs = np.array([e[2] for e in self.trajectory], np.int64)
        if refs.size == 0:
            return
        bad = np.unique(refs[(refs >= 0) & ~kf_valid[np.maximum(refs, 0)]])
        if bad.size == 0:
            return
        poses = self.map.kf_pose_cw.cpu().numpy()
        parent = self.map.kf_parent.cpu().numpy()
        self.metrics["host_syncs"] += 2
        anc = {}
        for r in bad.tolist():
            a = r
            for _ in range(64):
                a = int(parent[a]) if a >= 0 else -1
                if a < 0 or kf_valid[a]:
                    break
            if a < 0 or not kf_valid[a]:
                a = 0  # the root keyframe is never culled
            # T_c<-anc = T_c<-r @ T_r<-w @ T_w<-anc
            anc[r] = (a, poses[r] @ np.linalg.inv(poses[a]))
        self.trajectory = [
            (fid, _host_pose(T_cr) @ anc[ref][1], anc[ref][0], lost)
            if ref in anc else (fid, T_cr, ref, lost)
            for fid, T_cr, ref, lost in self.trajectory
        ]

    def _maybe_compact(self, n_kf: Optional[int] = None):
        """Compact the keyframe pool when it is within 4 slots of capacity
        and something was culled; every keyframe id the tracker holds
        (trajectory, queue, chained context) is remapped, the keyframe
        database's and the loop closer's too.  A chunk in flight is
        resolved first (its outputs use the old ids), and a mapping job in
        flight is adopted first without submitting the next (its snapshot
        uses them).  ``n_kf`` is the host copy of ``map.n_kf`` when the
        caller has one."""
        cap = self.map.kf_capacity
        if n_kf is None:
            n_kf = self._host(self.map.n_kf)
        if n_kf < cap - 4:
            return
        if self._pending_chunk is not None:
            # While a chunk is being resolved (re-entered through _adopt),
            # defer: resolving the newer chunk first would scramble the
            # trajectory, and the 4-slot margin covers one more chunk.
            if self._resolving:
                return
            pc, self._pending_chunk = self._pending_chunk, None
            self._resolve_chunk(self._fused_sensor, *pc)
            return self._maybe_compact()
        mp = self.mapping_pipeline
        if mp is not None and not mp.accept_keyframes():
            self._no_submit = True
            try:
                self._adopt(mp.wait())
            finally:
                self._no_submit = False
        self._reanchor_culled_refs()
        m2, kf_map = ms.compact_map(self.map)
        if int(m2.n_kf) >= self._host(self.map.n_kf):
            self._submit_next_kf()  # keep the worker fed
            return  # nothing reclaimed: the pool is full
        self.map = m2

        def r(k):
            return int(kf_map[k]) if k >= 0 else -1

        self.ref_kf = max(r(self.ref_kf), 0)
        # Queued keyframes are valid rows and survive; drop any culled.
        self._kf_queue = [r(k) for k in self._kf_queue if r(k) >= 0]
        self.metrics["compactions"] = self.metrics.get("compactions", 0) + 1
        self.trajectory = [
            (fid, T_cr, max(r(ref), 0), lost) for fid, T_cr, ref, lost in self.trajectory
        ]
        if self._next_ctx is not None:
            self._next_ctx = self._next_ctx._replace(ref_kf=self.ref_kf)
        if self.database is not None:
            self.database.remap(kf_map)
        if self.loop_closer is not None:
            self.loop_closer.remap(kf_map)
        self._submit_next_kf()  # restart the worker on the new ids

    # -- bookkeeping -------------------------------------------------------

    def _relative_to_ref(self, T: torch.Tensor) -> np.ndarray:
        """T (world->camera) relative to the reference keyframe, on the host."""
        T_rw = self.map.kf_pose_cw[self.ref_kf].cpu().numpy()
        return T.cpu().numpy() @ np.linalg.inv(T_rw)

    def _log_pose(self):
        # The pose relative to the reference keyframe (mlRelativeFramePoses,
        # Tracking.cc:≈480), replayed against keyframe poses at export.
        self.trajectory.append((self.frame_id, self._relative_to_ref(self.last_T), self.ref_kf,
                                self.state != TrackState.OK))

    def _finish_frame(self, frame: Frame, bindings=None):
        self.last_frame = frame
        if bindings is not None:
            self.last_bindings = bindings
        elif self.last_bindings is None:
            self.last_bindings = torch.full(
                (frame.xy.shape[0],), NO_POINT, dtype=torch.int32, device=self.device
            )
        self.frame_id += 1

    # -- outputs -----------------------------------------------------------

    def poses_wc(self) -> np.ndarray:
        """(F, 4, 4) camera-to-world trajectory, replayed against the
        current keyframe poses (System::SaveTrajectory*'s Tcr * Trw), after
        ``flush()``."""
        self.flush()
        kf_poses = self.map.kf_pose_cw.cpu().numpy()
        return np.stack([np.linalg.inv(_host_pose(T_cr) @ kf_poses[ref])
                         for _, T_cr, ref, _ in self.trajectory])


def _host_pose(T) -> np.ndarray:
    """A trajectory entry's pose (a device tensor or an array) as numpy."""
    return T.cpu().numpy() if torch.is_tensor(T) else np.asarray(T)
