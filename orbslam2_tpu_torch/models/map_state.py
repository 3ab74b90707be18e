"""The map as fixed-capacity struct-of-arrays state.

Port of the part of ``orbslam2_tpu/models/map_state.py`` that RGB-D tracking
uses (``Map``/``KeyFrame``/``MapPoint``, src/Map.cc, src/KeyFrame.cc,
src/MapPoint.cc): pools with validity masks, observations stored forward
(keyframe slot -> point id).

Updates are functional, as in the reference: a function returns a new
``MapState`` and leaves its input unchanged, so the tracker can discard a
tentative update (the ref-KF rescue does).

Scatters with an out-of-range target use an explicit sentinel row that is
sliced off, where the reference relies on ``mode="drop"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NO_POINT = -1


class MapState(NamedTuple):
    # --- keyframes (capacity K, feature capacity N) ---
    kf_pose_cw: torch.Tensor   # (K, 4, 4) world->camera
    kf_xy: torch.Tensor        # (K, N, 2) undistorted level-0 keypoint coords
    kf_level: torch.Tensor     # (K, N) octave
    kf_angle: torch.Tensor     # (K, N)
    kf_desc: torch.Tensor      # (K, N, 8) int32 (uint32 bits)
    kf_ur: torch.Tensor        # (K, N) stereo right-u; <0 = mono
    kf_kp_valid: torch.Tensor  # (K, N) bool
    kf_point: torch.Tensor     # (K, N) int32 map-point id per slot; -1 = none
    kf_valid: torch.Tensor     # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) source frame index
    kf_parent: torch.Tensor    # (K,) spanning-tree parent (-1 root)
    # --- map points (capacity P) ---
    pt_pos: torch.Tensor       # (P, 3)
    pt_normal: torch.Tensor    # (P, 3) mean viewing direction
    pt_desc: torch.Tensor      # (P, 8) int32 representative descriptor
    pt_min_dist: torch.Tensor  # (P,) scale-invariance band
    pt_max_dist: torch.Tensor  # (P,)
    pt_ref_kf: torch.Tensor    # (P,) reference keyframe id
    pt_first_kf: torch.Tensor  # (P,) keyframe id at creation
    pt_valid: torch.Tensor     # (P,) bool
    pt_visible: torch.Tensor   # (P,) int32 tracking statistics
    pt_found: torch.Tensor     # (P,) int32
    # --- counters (0-d int32 device tensors) ---
    n_kf: torch.Tensor         # next keyframe slot
    n_pt: torch.Tensor         # live point count

    @property
    def kf_capacity(self) -> int:
        return self.kf_pose_cw.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def feat_capacity(self) -> int:
        return self.kf_xy.shape[1]


def make_empty_map(kf_capacity: int, pt_capacity: int, feat_capacity: int,
                   device="cpu") -> MapState:
    K, P, N = kf_capacity, pt_capacity, feat_capacity
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=device)
    return MapState(
        kf_pose_cw=torch.eye(4, dtype=f32, **kw).repeat(K, 1, 1),
        kf_xy=torch.zeros((K, N, 2), dtype=f32, **kw),
        kf_level=torch.zeros((K, N), dtype=i32, **kw),
        kf_angle=torch.zeros((K, N), dtype=f32, **kw),
        kf_desc=torch.zeros((K, N, 8), dtype=i32, **kw),
        kf_ur=torch.full((K, N), -1.0, dtype=f32, **kw),
        kf_kp_valid=torch.zeros((K, N), dtype=torch.bool, **kw),
        kf_point=torch.full((K, N), NO_POINT, dtype=i32, **kw),
        kf_valid=torch.zeros((K,), dtype=torch.bool, **kw),
        kf_frame_id=torch.zeros((K,), dtype=i32, **kw),
        kf_parent=torch.full((K,), -1, dtype=i32, **kw),
        pt_pos=torch.zeros((P, 3), dtype=f32, **kw),
        pt_normal=torch.zeros((P, 3), dtype=f32, **kw),
        pt_desc=torch.zeros((P, 8), dtype=i32, **kw),
        pt_min_dist=torch.zeros((P,), dtype=f32, **kw),
        pt_max_dist=torch.full((P,), 1e9, dtype=f32, **kw),
        pt_ref_kf=torch.zeros((P,), dtype=i32, **kw),
        pt_first_kf=torch.zeros((P,), dtype=i32, **kw),
        pt_valid=torch.zeros((P,), dtype=torch.bool, **kw),
        pt_visible=torch.ones((P,), dtype=i32, **kw),
        pt_found=torch.ones((P,), dtype=i32, **kw),
        n_kf=torch.zeros((), dtype=i32, **kw),
        n_pt=torch.zeros((), dtype=i32, **kw),
    )


def scatter_max(size: int, index: torch.Tensor, src, fill=0) -> torch.Tensor:
    """``full(size, fill).at[index].max(src, mode="drop")`` along dim 0:
    targets outside [0, size) go to a sentinel row that is dropped.  ``src``
    is a scalar or a tensor shaped ``index.shape + trailing``."""
    flat = index.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < size), flat, size)
    if torch.is_tensor(src):
        src = src.reshape(flat.shape + src.shape[index.dim():])
    else:
        src = torch.full(flat.shape, src, dtype=torch.int32, device=flat.device)
    out = torch.full((size + 1,) + src.shape[1:], fill, dtype=src.dtype, device=src.device)
    idx = flat.view((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    return out.scatter_reduce(0, idx, src, reduce="amax", include_self=True)[:size]


def scatter_last(base: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base.at[index].set(values, mode="drop")`` with the reference's
    resolution of repeated targets: the highest source row wins (JAX's CPU
    scatter applies updates in row order, last writer wins).  Done as an
    ``amax`` over row ids then a gather, so it is deterministic on CUDA,
    where ``index_put_`` leaves the winner of a duplicate unspecified."""
    n = base.shape[0]
    index = index.long()
    rows = torch.arange(index.shape[0], device=index.device)
    winner = scatter_max(n, index, rows, fill=-1)
    has = winner >= 0
    picked = values[winner.clamp(min=0)]
    return torch.where(has.view((-1,) + (1,) * (base.dim() - 1)), picked, base)


def update_point_stats(m: MapState, scale_factors: torch.Tensor) -> MapState:
    """Recompute representative descriptors, normals and scale bands for
    all valid points from the forward index (MapPoint::UpdateNormalAndDepth,
    MapPoint.cc:≈320; the descriptor is the reference-keyframe
    observation's, as in the reference package)."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    dev = m.pt_pos.device

    ok = (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pts_safe = torch.where(ok, m.kf_point, 0).long()
    flat_pts = pts_safe.reshape(-1)
    okf = ok.reshape(-1)

    Rt = m.kf_pose_cw[:, :3, :3].transpose(1, 2)
    cam_centers = -(Rt @ m.kf_pose_cw[:, :3, 3:4])[..., 0]  # (K, 3)
    kf_ids = torch.arange(K, device=dev)[:, None].expand(K, N).reshape(-1)
    vec = m.pt_pos[flat_pts] - cam_centers[kf_ids]
    vec = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-9)
    normal_sum = torch.zeros((P, 3), dtype=torch.float32, device=dev).index_add(
        0, flat_pts, vec * okf[:, None]
    )
    n_obs = torch.zeros((P,), dtype=torch.float32, device=dev).index_add(
        0, flat_pts, okf.to(torch.float32)
    )
    normal = normal_sum / torch.clamp(n_obs[:, None], min=1.0)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)

    ref_kf = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
    dist_ref = torch.linalg.norm(m.pt_pos - cam_centers[ref_kf], dim=-1)
    # The observation (k, n) of point p in its reference keyframe, by one
    # scatter over the forward index.
    kf_ids2 = torch.arange(K, device=dev)[:, None].expand(K, N)
    sel = ok & (kf_ids2 == m.pt_ref_kf[pts_safe])
    sel_idx = torch.where(sel, pts_safe, P)
    has_slot = scatter_max(P, sel_idx, 1) > 0
    octave = scatter_max(P, sel_idx, m.kf_level)
    L = scale_factors.shape[0]
    scale = scale_factors[torch.clamp(octave, 0, L - 1).long()]
    max_dist = dist_ref * scale
    min_dist = max_dist / scale_factors[L - 1]
    # Word-wise max over the selected observations, as the reference's
    # uint32 ``.max``: compared as unsigned (int64), then reinterpreted.
    desc_u = m.kf_desc.to(torch.int64) & 0xFFFFFFFF
    desc = scatter_max(P, sel_idx, desc_u)
    desc = torch.where(desc >= 2**31, desc - 2**32, desc).to(torch.int32)

    upd = m.pt_valid & has_slot
    return m._replace(
        pt_normal=torch.where(upd[:, None], normal, m.pt_normal),
        pt_max_dist=torch.where(upd, max_dist, m.pt_max_dist),
        pt_min_dist=torch.where(upd, min_dist, m.pt_min_dist),
        pt_desc=torch.where(upd[:, None], desc, m.pt_desc),
    )


def predict_scale(
    dist: torch.Tensor, max_dist: torch.Tensor, scale_factors: torch.Tensor,
) -> torch.Tensor:
    """MapPoint::PredictScale (MapPoint.cc:≈400): the count of pyramid
    levels whose scale is below max_dist/dist, clipped to the pyramid."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    lvl = (scale_factors[None, :] < ratio[..., None]).sum(-1)
    return torch.clamp(lvl, 0, scale_factors.shape[0] - 1)
