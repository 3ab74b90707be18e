"""Tracking: the per-frame front end (stereo and RGB-D).

Port of ``orbslam2_tpu/models/tracking.py`` for the stereo and RGB-D slices
(``Tracking``, src/Tracking.cc).  The device functions keep the reference's
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
first keyframe from stereo or sensor depth (StereoInitialization, ≈500);
every later frame goes through ``track_fused._fused_track``; a
``LocalMapper`` given to the tracker maps each new keyframe synchronously,
and a ``KeyframeDatabase`` takes every keyframe and serves the
relocalization of LOST frames (and of visual-odometry frames in
localization-only mode).  Loop closing and the chunked/pipelined trackers
are not ported yet.

Repeated scatter targets are resolved as the reference's CPU run resolves
them (the highest source row wins), through ``map_state.scatter_last``.
Every ``top_k`` is a stable descending sort (lower index first on ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Settings
from ..ops import matcher, pnp
from ..ops import pyramid as pyr_ops
from ..ops.extractor import OrbExtractor
from ..ops.hamming import TH_HIGH, TH_LOW, match_descriptors, rotation_consistency
from ..ops.select import topk_stable
from ..solvers.lie import se3_apply, se3_inverse
from ..solvers.pose_opt import PoseObs, pose_optimization
from ..utils.camera import CameraModel, in_image
from . import map_state as ms
from .frame import Frame, build_rgbd_frame, build_stereo_frame

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
    baseline: float,
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
    computes exactly the map-only search.

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

    ``metrics["host_syncs"]`` counts the device-to-host reads tracking
    made (each one waits for the device when the tensors are on a GPU).
    The relocalization's RANSAC samples come from ``generator``, a
    ``torch.Generator`` on the tracker's device seeded 0 as the reference
    seeds its key, through ``_ransac_samples``.
    """

    def __init__(self, settings: Settings, local_mapper=None, database=None,
                 loop_closer=None, device="cuda"):
        if loop_closer is not None:
            raise NotImplementedError(
                "Tracker(loop_closer=...) is not ported yet (ROADMAP Queue 1 item 15)")
        from .kf_database import KeyframeDatabase
        from .local_mapping import LocalMapper

        for name, value, cls in (("local_mapper", local_mapper, LocalMapper),
                                 ("database", database, KeyframeDatabase)):
            if value is not None and not isinstance(value, cls):
                raise TypeError(f"Tracker({name}=...) takes this package's {cls.__name__}, "
                                f"not {type(value).__name__}")
        self.local_mapper = local_mapper
        self.database = database
        self.settings = settings
        self.device = torch.device(device)
        self.cam = settings.camera_model()
        orb = settings.orb
        self.extractor = OrbExtractor(orb, settings.tpu, device=self.device)
        self.scale_factors = torch.from_numpy(
            pyr_ops.scale_factors(orb.n_levels, orb.scale_factor)
        ).to(self.device)
        self.inv_sigma2 = torch.from_numpy(
            (1.0 / pyr_ops.level_sigma2(orb.n_levels, orb.scale_factor)).astype(np.float32)
        ).to(self.device)
        self.map = ms.make_empty_map(
            settings.tpu.max_keyframes, settings.tpu.max_points,
            settings.tpu.max_keypoints, device=self.device,
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
        self.generator = torch.Generator(device=self.device).manual_seed(0)
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

    # -- frame entry point -------------------------------------------------

    def track_rgbd(self, image, depth_map, timestamp: float = 0.0):
        """Track one RGB-D frame; returns the current pose (world->camera)."""
        frame = build_rgbd_frame(
            torch.as_tensor(image, dtype=torch.float32, device=self.device),
            torch.as_tensor(depth_map, dtype=torch.float32, device=self.device),
            self.extractor, self.cam, self.settings.camera.depth_map_factor,
        )
        return self._track_frame(frame)

    def track_stereo(self, image_left, image_right, timestamp: float = 0.0):
        """Track one rectified stereo pair; returns the current pose
        (world->camera)."""
        return self._track_frame(build_stereo_frame(
            image_left, image_right, self.extractor, self.cam, self.scale_factors))

    def _track_frame(self, frame: Frame):
        if self.state == TrackState.NOT_INITIALIZED:
            self._track(frame)
        else:
            self._track_fused(frame)
        return self.last_T

    def _track(self, frame: Frame):
        """Initialization branch of Tracking::Track (the only one reached:
        initialized frames take the fused path)."""
        self._stereo_initialize(frame)
        self._log_pose()
        self._finish_frame(frame)

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

    def _track_fused(self, frame: Frame):
        from .track_fused import (
            FLAG_N_INLIERS, FLAG_NEED_KF, FLAG_OK, FLAG_PATH, _fused_track,
        )

        tpu = self.settings.tpu
        out = _fused_track(
            self.map, frame, self._make_ctx(), self.cam, self.scale_factors,
            self.inv_sigma2, self._th_depth(),
            local_window=tpu.local_window, kf_max_gap=tpu.kf_max_gap,
            kf_busy_frames=tpu.kf_busy_frames,
        )
        self.metrics["host_syncs"] += out.host_syncs
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
            if need_kf and not self.localization_only:
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

    # -- relocalization ------------------------------------------------------

    def _ransac_samples(self, valid: torch.Tensor, iters: int, k: int) -> torch.Tensor:
        """(iters, k) RANSAC sample indices from the tracker's generator."""
        return pnp.draw_samples(valid, iters, k, self.generator)

    def _mark_reloc(self):
        """No keyframe insertion for 10 frames after a relocalization on a
        map of more than 10 keyframes (Tracking.cc:≈990: right after it
        the pose is anchored to old keyframes, and inserting at once would
        duplicate them)."""
        if self._host(self.map.n_kf) > 10:
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

    def _create_keyframe(self, frame: Frame, T, bindings):
        """Insert the frame as a keyframe, spawning close-depth points for
        its unbound keypoints (Tracking.cc:≈1060), add it to the keyframe
        database, then run the local
        mapper on it synchronously.  Mapping may cull points whose slots
        are reused later, so the held bindings are scrubbed against the
        pool; trajectory entries of culled keyframes are re-anchored and
        the pool compacted when it nears capacity."""
        m = self.map
        pos_w, ok = unproject_frame_depth(frame, T, self.cam)
        ok = ok & (bindings < 0) & (frame.depth < self._th_depth())
        m, pids = add_points(m, pos_w, frame.desc, ok, m.n_kf, reverse=True)
        bindings = torch.where(ok & (pids >= 0), pids, bindings)
        m, kf_id = insert_keyframe(m, frame, T, self.frame_id, bindings, self.ref_kf)
        self.map = ms.update_point_stats(m, self.scale_factors)
        self.metrics["keyframes_created"] += 1
        self.ref_kf = self._host(kf_id)
        self.last_kf_frame_id = self.frame_id
        self.last_bindings = bindings
        if self.database is not None:
            self.database.add_keyframe(self.ref_kf, frame.desc, frame.valid)
        if self.local_mapper is None:
            return
        self.map = self.local_mapper.process_keyframe(self.map, self.ref_kf)
        self.last_bindings = torch.where(
            self.map.pt_valid[torch.clamp(bindings, min=0).long()] & (bindings >= 0),
            bindings, NO_POINT,
        )
        pool = self._host(torch.cat([self.map.kf_valid.to(torch.int32), self.map.n_kf.view(1)]))
        kf_valid = np.array(pool[:-1], dtype=bool)
        self._reanchor_culled_refs(kf_valid)
        self._maybe_compact(pool[-1])

    # -- keyframe-pool maintenance -------------------------------------------

    def _reanchor_culled_refs(self, kf_valid: np.ndarray):
        """Re-anchor trajectory entries whose reference keyframe was culled
        to its nearest valid ancestor, while the culled pose is still that
        of the live map (the reference replays bad keyframes through their
        spanning-tree parents at save time, System.cc:≈270).  ``kf_valid``
        is the host copy of ``map.kf_valid``."""
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

    def _maybe_compact(self, n_kf: int):
        """Compact the keyframe pool when it is within 4 slots of capacity
        and something was culled; every keyframe id the tracker holds is
        remapped, the keyframe database's rows too.  The trajectory must
        already be re-anchored against the pool.  (The reference's
        pending-chunk and async branches belong to the chunked tracker and
        the async pipeline, not ported yet.)"""
        if n_kf < self.map.kf_capacity - 4:
            return
        m2, kf_map = ms.compact_map(self.map)
        if int(m2.n_kf) >= n_kf:
            return  # nothing reclaimed: the pool is full
        self.map = m2

        def r(k):
            return int(kf_map[k]) if k >= 0 else -1

        self.ref_kf = max(r(self.ref_kf), 0)
        self.metrics["compactions"] = self.metrics.get("compactions", 0) + 1
        self.trajectory = [
            (fid, T_cr, max(r(ref), 0), lost) for fid, T_cr, ref, lost in self.trajectory
        ]
        if self.database is not None:
            self.database.remap(kf_map)

    # -- bookkeeping -------------------------------------------------------

    def _log_pose(self):
        # The pose relative to the reference keyframe (mlRelativeFramePoses,
        # Tracking.cc:≈480), replayed against keyframe poses at export.
        T_rw = self.map.kf_pose_cw[self.ref_kf].cpu().numpy()
        T_cr = self.last_T.cpu().numpy() @ np.linalg.inv(T_rw)
        self.trajectory.append(
            (self.frame_id, T_cr, self.ref_kf, self.state != TrackState.OK)
        )

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
        current keyframe poses (System::SaveTrajectory*'s Tcr * Trw)."""
        kf_poses = self.map.kf_pose_cw.cpu().numpy()
        return np.stack([np.linalg.inv(_host_pose(T_cr) @ kf_poses[ref])
                         for _, T_cr, ref, _ in self.trajectory])


def _host_pose(T) -> np.ndarray:
    """A trajectory entry's pose (a device tensor or an array) as numpy."""
    return T.cpu().numpy() if torch.is_tensor(T) else np.asarray(T)
