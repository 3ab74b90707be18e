"""The map as fixed-capacity struct-of-arrays state.

Port of the part of ``orbslam2_tpu/models/map_state.py`` that RGB-D tracking
and local mapping use (``Map``/``KeyFrame``/``MapPoint``, src/Map.cc, src/KeyFrame.cc,
src/MapPoint.cc): pools with validity masks, observations stored forward
(keyframe slot -> point id).

Updates are functional, as in the reference: a function returns a new
``MapState`` and leaves its input unchanged, so the tracker can discard a
tentative update (the ref-KF rescue does).

Scatters with an out-of-range target use an explicit sentinel row that is
sliced off, where the reference relies on ``mode="drop"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.hamming import bit_signs
from ..ops.select import topk_stable

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
                   device) -> MapState:
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

    # The reference's "camera centres" are -R t (its einsum contracts R^T
    # over its first index), not the centre -R^T t; kept for parity (ROADMAP
    # Queue 3).  They agree for the identity pose of the first keyframe.
    cam_centers = -(m.kf_pose_cw[:, :3, :3] @ m.kf_pose_cw[:, :3, 3:4])[..., 0]  # (K, 3)
    kf_ids = torch.arange(K, device=dev)[:, None].expand(K, N).reshape(-1)
    vec = m.pt_pos[flat_pts] - cam_centers[kf_ids]
    vec = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-9)
    normal_sum = segment_sum(P, torch.where(okf, flat_pts, P), vec)
    # Whole numbers in float32: exact in any order.
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


def scatter_min(size: int, index: torch.Tensor, src: torch.Tensor, fill) -> torch.Tensor:
    """``full(size, fill).at[index].min(src, mode="drop")`` along dim 0."""
    return -scatter_max(size, index, -src, fill=-fill)


def scatter_add(size: int, index: torch.Tensor, src) -> torch.Tensor:
    """``zeros(size).at[index].add(src, mode="drop")`` along dim 0: targets
    outside [0, size) go to a sentinel row that is dropped."""
    flat = index.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < size), flat, size)
    if not torch.is_tensor(src):
        src = torch.full(flat.shape, src, dtype=torch.int32, device=flat.device)
    src = src.reshape(flat.shape + src.shape[index.dim():])
    out = torch.zeros((size + 1,) + src.shape[1:], dtype=src.dtype, device=src.device)
    return out.index_add(0, flat, src)[:size]


class SegmentPlan(NamedTuple):
    """Where each entry of a segment sum goes: built once by
    ``segment_plan`` (one host read), applied by ``segment_sum`` to any
    number of ``src`` arrays over the same index."""
    size: int
    seg: torch.Tensor    # (n,) sorted targets, ``size`` for dropped entries
    order: torch.Tensor  # (n,) the stable sort's permutation
    pos: torch.Tensor    # (n,) each entry's slot within its segment
    width: int           # the largest segment


def segment_plan(size: int, index: torch.Tensor) -> SegmentPlan:
    """The plan of ``segment_sum(size, index, ...)``: a stable sort of the
    targets keeps the entries of each target in their order.  Sizing the
    buffer by the largest segment costs one host read."""
    flat = index.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < size), flat, size)
    seg, order = torch.sort(flat, stable=True)
    first = torch.searchsorted(seg, torch.arange(size + 1, device=seg.device))
    pos = torch.arange(seg.shape[0], device=seg.device) - first[seg]
    pos = torch.where(seg < size, pos, 0)  # dropped entries share one slot of the sentinel row
    width = int(pos.max()) + 1 if seg.numel() else 1
    return SegmentPlan(size, seg, order, pos, width)


def segment_sum(size: int, index: torch.Tensor, src: torch.Tensor,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """``zeros(size).at[index].add(src, mode="drop")`` along dim 0 for a
    float ``src`` (one row per entry of the 1-d ``index``), summed in a
    fixed order with no atomics: a float ``index_add`` runs through atomics
    on the card and its sums change from run to run.  Each entry is written
    to its own slot of a zero (size + 1, width, ...) buffer (unique
    targets, so any write order gives the same buffer), which is summed
    over its slots.  Without ``plan`` (``segment_plan(size, index)``) the
    call makes its own, with one host read: callers that sum over the same
    index many times pass the plan."""
    if plan is None:
        plan = segment_plan(size, index)
    seg, pos = plan.seg, plan.pos
    buf = torch.zeros((size + 1, plan.width) + src.shape[1:], dtype=src.dtype, device=src.device)
    buf[seg, pos] = torch.where((seg < size).view((-1,) + (1,) * (src.dim() - 1)),
                                src[plan.order], 0)
    return buf[:size].sum(1)


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------


def _valid_obs(m: MapState):
    """(K, N) validity + point ids of the forward observation index."""
    pts = m.kf_point
    ok = (pts >= 0) & m.kf_kp_valid & m.kf_valid[:, None] & (pts < m.pt_capacity)
    ok = ok & m.pt_valid[torch.where(ok, pts, 0).long()]
    return ok, pts


def observation_matrix(m: MapState) -> torch.Tensor:
    """B (P, K) float32: B[p, k] = 1 iff point p is bound to a valid
    keypoint of valid keyframe k.  Built with an integer ``amax`` scatter
    (the reference adds floats and clamps to 1), so no float atomics.
    O(P*K) memory: loop-rate consumers only."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    ok, pts = _valid_obs(m)
    kf_ids = torch.arange(K, device=pts.device)[:, None]
    flat = torch.where(ok, pts.long() * K + kf_ids, P * K)
    return (scatter_max(P * K, flat, 1) > 0).view(P, K).to(torch.float32)


def covisibility(m: MapState, chunk: int = 16384) -> torch.Tensor:
    """(K, K) int32 covisibility weights (shared-point counts, diagonal
    zeroed): W = sum over point chunks of B_c^T B_c, B_c (chunk, K) built
    from the forward index.  Whole numbers below 2^24 in float32, so the
    products are exact in any order (TF32 stays off)."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    CH = min(chunk, P)
    ok, pts = _valid_obs(m)
    kf_ids = torch.arange(K, device=pts.device)[:, None].expand(K, N)
    pts_flat = torch.where(ok, pts.long(), P)
    W = torch.zeros((K, K), dtype=torch.float32, device=pts.device)
    for start in range(0, P, CH):
        local = pts_flat - start
        in_ch = (local >= 0) & (local < CH)
        flat = torch.where(in_ch, local * K + kf_ids, CH * K)
        B = (scatter_max(CH * K, flat, 1) > 0).view(CH, K).to(torch.float32)
        W = W + B.T @ B
    W = W * (1.0 - torch.eye(K, dtype=torch.float32, device=W.device))
    return W.to(torch.int32)


def points_seen_by(m: MapState, kf_mask: torch.Tensor) -> torch.Tensor:
    """(P,) bool: points observed by any keyframe in ``kf_mask`` (K,)."""
    ok, pts = _valid_obs(m)
    ok = ok & kf_mask[:, None]
    return scatter_max(m.pt_capacity, torch.where(ok, pts, m.pt_capacity), 1) > 0


def covisible_rows(m: MapState, kf_ids: torch.Tensor) -> torch.Tensor:
    """(S, K) int32: shared-point counts of each of ``kf_ids`` (S,) vs every
    keyframe — rows of the covisibility matrix (KeyFrame::
    GetCovisiblesByWeight), each keyframe's own entry zeroed."""
    P = m.pt_capacity
    kf = kf_ids.long()
    S = kf.shape[0]
    row_pts = m.kf_point[kf].long()
    ok_row = ((row_pts >= 0) & m.kf_kp_valid[kf] & m.kf_valid[kf][:, None]
              & m.pt_valid[row_pts.clamp(min=0)])
    # One membership row per keyframe, flattened: row s at s * P.
    base = (torch.arange(S, device=kf.device) * P)[:, None]
    member = scatter_max(S * P, torch.where(ok_row, row_pts + base, S * P), 1) > 0
    ok, pts = _valid_obs(m)
    hit = member.view(S, P)[:, torch.where(ok, pts, 0).long()] & ok
    return hit.sum(-1).to(torch.int32).scatter(1, kf[:, None], 0)


def covisible_row(m: MapState, kf_id) -> torch.Tensor:
    """(K,) int32: ``covisible_rows`` of the one keyframe ``kf_id``."""
    kf = torch.as_tensor(kf_id, device=m.kf_point.device).long().view(1)
    return covisible_rows(m, kf)[0]


def point_observation_counts(m: MapState) -> torch.Tensor:
    """(P,) int32 number of keyframes observing each point."""
    ok, pts = _valid_obs(m)
    return scatter_add(m.pt_capacity, torch.where(ok, pts, m.pt_capacity), 1)


def best_covisible(m: MapState, kf_id, n_best: int = 10):
    """Ids + weights of the top-n covisible keyframes of ``kf_id``
    (KeyFrame::GetBestCovisibilityKeyFrames, src/KeyFrame.cc:≈185); ties go
    to the lower id."""
    w, ids = topk_stable(covisible_row(m, kf_id), n_best)
    return ids.to(torch.int32), w


def compute_distinctive_descriptors(
    m: MapState,
    max_obs: int = 16,
    touched_kfs: Optional[torch.Tensor] = None,
    subset_cap: int = 4096,
) -> MapState:
    """MapPoint::ComputeDistinctiveDescriptors (MapPoint.cc:≈260): for each
    point, the observation descriptor with the least median Hamming distance
    to the point's other observations.  The per-point observation lists
    come from a stable sort of the forward index by point id; exact for
    points with at most ``max_obs`` observers (beyond that the first
    ``max_obs`` vote).

    ``touched_kfs`` (T,): only points observed by those keyframes are
    recomputed, at most ``subset_cap`` of them."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    dev = m.kf_point.device
    ok = (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    flat_pid = torch.where(ok, m.kf_point, P).reshape(-1).long()

    if touched_kfs is not None:
        kf_mask = scatter_max(K, touched_kfs, 1) > 0
        member = points_seen_by(m, kf_mask)
        P_eff = min(subset_cap, P)
        _, sel = topk_stable(member.to(torch.float32), P_eff)
        sel_ok = member[sel]
        g2l = torch.full((P + 1,), P_eff, dtype=torch.int64, device=dev)
        g2l[sel] = torch.arange(P_eff, device=dev)
        flat_pid = g2l[torch.clamp(flat_pid, max=P)]
    else:
        P_eff = P
    desc_flat = m.kf_desc.reshape(-1, 8)

    order = torch.argsort(flat_pid, stable=True)  # the sentinel sorts last
    sorted_pid = flat_pid[order]
    sorted_desc = desc_flat[order]
    pids = torch.arange(P_eff, device=dev)
    base = torch.searchsorted(sorted_pid, pids, right=False)
    end = torch.searchsorted(sorted_pid, pids, right=True)
    idx = base[:, None] + torch.arange(max_obs, device=dev)[None, :]
    valid = idx < end[:, None]
    table = sorted_desc[torch.clamp(idx, max=sorted_pid.shape[0] - 1)]  # (P', M, 8)

    # Pairwise Hamming distances as one batched product of the +-1 bit
    # vectors (exact, as in ops/hamming.py's plain matrix).
    signs = bit_signs(table.reshape(-1, 8)).view(P_eff, max_obs, 256)
    d = ((256.0 - signs @ signs.transpose(1, 2)) * 0.5).to(torch.int32)
    BIG = 1 << 12
    pair_ok = valid[:, :, None] & valid[:, None, :]
    d = torch.where(pair_ok, d, BIG)

    # Median of each candidate's row (self-distance 0 included, median
    # index (n-1)/2 rounded down, as the reference).
    cnt = valid.sum(1)
    d_sorted = torch.sort(d, dim=2).values
    med_idx = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, max_obs - 1)
    median = d_sorted.gather(2, med_idx[:, None, None].expand(P_eff, max_obs, 1))[..., 0]
    median = torch.where(valid, median, BIG)
    best = torch.argmin(median, dim=1)  # the first minimum
    best_desc = table.gather(1, best[:, None, None].expand(P_eff, 1, 8))[:, 0, :]

    if touched_kfs is not None:
        upd = m.pt_valid[sel] & (cnt > 0) & sel_ok
        pt_desc = m.pt_desc.clone()
        pt_desc[sel] = torch.where(upd[:, None], best_desc, m.pt_desc[sel])
        return m._replace(pt_desc=pt_desc)
    upd = m.pt_valid & (cnt > 0)
    return m._replace(pt_desc=torch.where(upd[:, None], best_desc, m.pt_desc))


def dedup_binding_rows(kf_point: torch.Tensor) -> torch.Tensor:
    """Unbind repeated point bindings within each keyframe row, keeping the
    lowest slot — the EraseMapPointMatch branch of MapPoint::Replace
    (MapPoint.cc:≈180)."""
    sv, order = torch.sort(kf_point, dim=1, stable=True)
    dup_sorted = torch.zeros_like(sv, dtype=torch.bool)
    dup_sorted[:, 1:] = (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)
    return torch.where(dup, NO_POINT, kf_point)


def apply_point_replacements(
    m: MapState,
    old_pt: torch.Tensor,   # (M,) point ids to retire
    new_pt: torch.Tensor,   # (M,) surviving point ids
    do: torch.Tensor,       # (M,) bool
) -> MapState:
    """Batched ``MapPoint::Replace`` (src/MapPoint.cc:≈180): rebind every
    observation of each retired point to its survivor, merge the found /
    visible statistics, invalidate the retired point and unbind duplicate
    bindings of the survivor.  A survivor that is itself retired elsewhere
    drops that replacement; a point retired twice merges its statistics
    once (its first slot wins)."""
    P = m.pt_capacity
    M = old_pt.shape[0]
    dev = old_pt.device
    do = do & (old_pt >= 0) & (new_pt >= 0) & (old_pt != new_pt)
    old_safe = torch.clamp(old_pt, 0, P - 1).long()
    new_safe = torch.clamp(new_pt, 0, P - 1).long()
    being_replaced = scatter_max(P, torch.where(do, old_pt, P), 1) > 0
    do = do & ~being_replaced[new_safe]
    slot_ids = torch.arange(M, device=dev)
    first_slot = scatter_min(P, torch.where(do, old_pt, P), slot_ids, fill=M)
    is_first = do & (first_slot[old_safe] == slot_ids)

    old_idx = torch.where(is_first, old_pt, P)
    repl = scatter_last(
        torch.arange(P, dtype=m.kf_point.dtype, device=dev), old_idx,
        torch.where(is_first, new_pt, 0).to(m.kf_point.dtype),
    )
    kf_point = torch.where(
        m.kf_point >= 0, repl[torch.clamp(m.kf_point, 0, P - 1).long()], m.kf_point
    )
    kf_point = dedup_binding_rows(kf_point)

    new_idx = torch.where(is_first, new_pt, P)
    zero = torch.zeros_like(m.pt_visible[old_safe])
    pt_visible = m.pt_visible + scatter_add(
        P, new_idx, torch.where(is_first, m.pt_visible[old_safe], zero))
    pt_found = m.pt_found + scatter_add(
        P, new_idx, torch.where(is_first, m.pt_found[old_safe], zero))
    pt_valid = m.pt_valid & ~(scatter_max(P, old_idx, 1) > 0)
    return m._replace(kf_point=kf_point, pt_valid=pt_valid,
                      pt_visible=pt_visible, pt_found=pt_found)


def compact_map(m: MapState):
    """Host-side keyframe-pool compaction: valid keyframes slide down to
    dense slots 0..K'-1 in id order, parents and point reference keyframes
    are remapped (a culled parent resolves to its nearest valid ancestor),
    freed pose slots become the identity.  Point slots stay in place.

    Returns (m2, kf_new_from_old): (K,) int64 numpy, -1 where the old id was
    culled."""
    K = m.kf_capacity
    dev = m.kf_pose_cw.device
    kf_valid = m.kf_valid.cpu().numpy().copy()
    n_kf = int(m.n_kf)
    kf_valid[n_kf:] = False
    old_ids = np.nonzero(kf_valid)[0]
    kf_map = np.full(K, -1, np.int64)
    kf_map[old_ids] = np.arange(len(old_ids))

    def take_kf(arr, fill=0):
        a = arr.cpu().numpy()
        out = np.full_like(a, fill)
        out[: len(old_ids)] = a[old_ids]
        return torch.from_numpy(out).to(dev)

    parent = m.kf_parent.cpu().numpy().astype(np.int64)
    resolved = parent.copy()
    for _ in range(8):
        bad = (resolved >= 0) & (kf_map[np.maximum(resolved, 0)] < 0)
        if not bad.any():
            break
        resolved[bad] = parent[np.maximum(resolved[bad], 0)]
    new_parent = np.where(resolved >= 0, kf_map[np.maximum(resolved, 0)], -1)[old_ids]
    new_parent_full = np.full(K, -1, np.int64)
    new_parent_full[: len(old_ids)] = new_parent

    ref = kf_map[np.clip(m.pt_ref_kf.cpu().numpy(), 0, K - 1)]
    first = kf_map[np.clip(m.pt_first_kf.cpu().numpy(), 0, K - 1)]
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[: len(old_ids)] = m.kf_pose_cw.cpu().numpy()[old_ids]

    def i32(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    m2 = m._replace(
        kf_pose_cw=torch.from_numpy(poses).to(dev),
        kf_xy=take_kf(m.kf_xy),
        kf_level=take_kf(m.kf_level),
        kf_angle=take_kf(m.kf_angle),
        kf_desc=take_kf(m.kf_desc),
        kf_ur=take_kf(m.kf_ur, fill=-1),
        kf_kp_valid=take_kf(m.kf_kp_valid, fill=False),
        kf_point=take_kf(m.kf_point, fill=NO_POINT),
        kf_valid=take_kf(m.kf_valid, fill=False),
        kf_frame_id=take_kf(m.kf_frame_id),
        kf_parent=i32(new_parent_full),
        pt_ref_kf=i32(np.maximum(ref, 0)),
        pt_first_kf=i32(np.maximum(first, 0)),
        n_kf=torch.tensor(len(old_ids), dtype=torch.int32, device=dev),
    )
    return m2, kf_map
