"""Local mapping: per-keyframe map maintenance, run after each keyframe
insertion, in line or in the async pipeline's worker thread
(``models/async_pipeline.py``).

Port of ``orbslam2_tpu/models/local_mapping.py`` (the LocalMapping thread,
src/LocalMapping.cc):

  MapPointCulling        (LocalMapping.cc:≈140)  cull_map_points
  CreateNewMapPoints     (≈190)  triangulate_new_points
  SearchInNeighbors      (≈370)  fuse_neighborhood
  LocalBundleAdjustment  (Optimizer.cc:≈460)  solvers/local_ba (K4, K5)
  KeyFrameCulling        (≈500)  cull_keyframes

Each stage takes a ``MapState`` and returns a new one.  The reference batches
the neighbours of triangulation and the fuse directions with ``vmap``; here
they are Python loops whose matches are all taken against the same map
before any binding, as the reference's batch is.  Repeated scatter targets
resolve as in the reference (``map_state.scatter_last``), rankings put the
lower index first on ties (``ops.select.topk_stable``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..config import Settings
from ..ops import matcher
from ..ops import pyramid as pyr_ops
from ..ops import twoview
from ..ops.extractor import Features
from ..ops.hamming import TH_LOW, match_descriptors
from ..ops.select import topk_stable
from ..solvers.lie import hat, se3_apply, se3_inverse
from ..solvers.local_ba import local_bundle_adjustment
from ..utils.camera import CameraModel, in_image
from . import map_state as ms
from .tracking import add_points

NO_POINT = ms.NO_POINT
# Each stage of ``LocalMapper.process_keyframe`` runs in a profiler range
# named STAGE_PREFIX + the stage's function name.
STAGE_PREFIX = "mapping."


def _bucket(cap: int, n: int, lo: int = 8) -> int:
    """Two-level window size: ``lo`` while the map has at most ``lo``
    keyframes, ``cap`` after."""
    lo = min(lo, cap)
    return lo if n <= lo else cap


def _kf(kf_id, device) -> torch.Tensor:
    return torch.as_tensor(kf_id, device=device).long()


def _set_row(arr: torch.Tensor, k: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    return arr.index_put((k.view(1),), row[None])


def cull_map_points(m: ms.MapState) -> ms.MapState:
    """MapPointCulling with the probation window: points at most 3
    keyframes old are culled when their found ratio is below 0.25, or when
    from age 2 on fewer than 2 keyframes observe them.  When more than 90%
    of the pool would stay valid, the weakest survivors (observation count,
    then found ratio; points younger than 3 keyframes protected) go down to
    the budget.  Bindings to culled points are scrubbed."""
    found_ratio = m.pt_found.to(torch.float32) / torch.clamp(
        m.pt_visible.to(torch.float32), min=1.0)
    n_obs = ms.point_observation_counts(m)
    age = m.n_kf - m.pt_first_kf
    bad = (age <= 3) & ((found_ratio < 0.25) | ((age >= 2) & (n_obs < 2)))
    keep = m.pt_valid & ~bad

    P = m.pt_capacity
    budget = int(0.90 * P)
    value = (torch.clamp(n_obs, max=16).to(torch.float32) + found_ratio
             + torch.where(age < 3, 100.0, 0.0))
    _, top_ids = topk_stable(torch.where(keep, value, -float("inf")), budget)
    in_budget = torch.zeros(P, dtype=torch.bool, device=keep.device).index_fill(0, top_ids, True)
    keep = torch.where(keep.sum() > budget, keep & in_budget, keep)
    still = keep[torch.clamp(m.kf_point, min=0).long()] & (m.kf_point >= 0)
    return m._replace(pt_valid=keep, kf_point=torch.where(still, m.kf_point, NO_POINT))


def _intrinsic_matrix(cam: CameraModel, device) -> torch.Tensor:
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def _features(m: ms.MapState, kf: torch.Tensor, valid: torch.Tensor) -> Features:
    return Features(
        xy=m.kf_xy[kf], level=m.kf_level[kf], angle=m.kf_angle[kf],
        response=torch.ones_like(m.kf_angle[kf]), desc=m.kf_desc[kf], valid=valid,
    )


def triangulate_new_points(
    m: ms.MapState,
    kf_id,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    sigma2: torch.Tensor,
    n_neighbors: int = 4,
) -> ms.MapState:
    """CreateNewMapPoints: for each of the ``n_neighbors`` best covisible
    keyframes (weight >= 10), match the unbound keypoints of both along
    epipolar lines, triangulate, keep points in front of both cameras with
    reprojection chi2 <= 5.991 sigma^2 in both and enough parallax, then
    bind them neighbour by neighbour (an earlier neighbour wins a slot)."""
    dev = m.kf_point.device
    kf = _kf(kf_id, dev)
    neighbor_ids, weights = ms.best_covisible(m, kf, n_neighbors)
    f1 = _features(m, kf, m.kf_kp_valid[kf] & (m.kf_point[kf] < 0))
    T1 = m.kf_pose_cw[kf]
    K = _intrinsic_matrix(cam, dev)
    Kinv = torch.linalg.inv(K)
    P1 = K @ T1[:3, :4]
    O1 = -T1[:3, :3].T @ T1[:3, 3]
    L = sigma2.shape[0]

    def reproj_err(pc, xy):
        z = torch.clamp(pc[:, 2], min=1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        return (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2

    def match_neighbor(kf2, w):
        ok_neighbor = (w >= 10) & m.kf_valid[kf2] & (kf2 != kf)
        f2 = _features(m, kf2, m.kf_kp_valid[kf2] & (m.kf_point[kf2] < 0) & ok_neighbor)
        T2 = m.kf_pose_cw[kf2]
        T21 = T2 @ se3_inverse(T1)
        R21, t21 = T21[:3, :3], T21[:3, 3]
        F21 = Kinv.T @ (hat(t21) @ R21) @ Kinv  # x2^T F21 x1 = 0
        # search_for_triangulation takes F12 with line2 = x1 @ F12: F21^T.
        mres = matcher.search_for_triangulation(f1, f2, F21.T, sigma2)
        good_pair = mres.ok & (torch.linalg.norm(t21) > 1e-3)

        xy2 = f2.xy[mres.idx]
        X = twoview.triangulate_linear(P1, K @ T2[:3, :4], f1.xy, xy2)
        pc1 = se3_apply(T1, X)
        pc2 = se3_apply(T2, X)
        z_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)
        s2a = sigma2[torch.clamp(f1.level, 0, L - 1).long()]
        s2b = sigma2[torch.clamp(f2.level[mres.idx], 0, L - 1).long()]
        e1_ok = reproj_err(pc1, f1.xy) <= 5.991 * s2a
        e2_ok = reproj_err(pc2, xy2) <= 5.991 * s2b
        O2 = -T2[:3, :3].T @ T2[:3, 3]
        r1, r2 = X - O1, X - O2
        cos_par = (r1 * r2).sum(-1) / torch.clamp(
            torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-9)
        good = good_pair & z_ok & e1_ok & e2_ok & (cos_par < 0.9998)
        return X, mres.idx, good

    found = [match_neighbor(neighbor_ids[i].long(), weights[i]) for i in range(n_neighbors)]
    for i, (X, idx2, good) in enumerate(found):
        m, _ = _add_and_bind(m, X, f1, idx2, good, kf, neighbor_ids[i].long())
    return m


def _add_and_bind(m, X, f1, idx2, good, kf1, kf2):
    """Append triangulated points and bind them in both keyframes."""
    good = good & (m.kf_point[kf1] < 0)  # slots bound by an earlier neighbour
    m, pids = add_points(m, X, f1.desc, good, kf1)
    ok = good & (pids >= 0)
    kf_point = _set_row(m.kf_point, kf1, torch.where(ok, pids, m.kf_point[kf1]))
    # Slot idx2[i] of kf2 -> pids[i]; rows that did not match write
    # NO_POINT into slot 0, as in the reference.
    row2 = kf_point[kf2]
    incoming = ms.scatter_last(torch.full_like(row2, NO_POINT), torch.where(ok, idx2, 0),
                               torch.where(ok, pids, NO_POINT))
    row2 = torch.where((row2 < 0) & (incoming >= 0), incoming, row2)
    return m._replace(kf_point=_set_row(kf_point, kf2, row2)), pids


def cull_keyframes(
    m: ms.MapState,
    current_kf,
    n_levels: int = 8,
    bf: float = 0.0,
    th_depth: float = 0.0,
) -> ms.MapState:
    """KeyFrameCulling: mark invalid the keyframes (not 0, 1 or the current
    one) more than 90% of whose observations are redundant.  An observation
    of point p at octave l is redundant when at least 3 other keyframes
    observe p at octave <= l + 1.  With a baseline (bf > 0) only the
    keyframe's own close observations (depth < th_depth) are counted.
    Children of culled keyframes are re-parented up the tree."""
    pts = m.kf_point
    ok = (pts >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    ok_counted = ok
    if bf > 0.0 and th_depth > 0.0:
        # depth = bf / (u - ur); close <=> disparity > bf / th_depth.
        disp = m.kf_xy[..., 0] - m.kf_ur
        ok_counted = ok & (m.kf_ur >= 0) & (disp > bf / th_depth)
    pid = torch.where(ok, pts, 0).long()
    P = m.pt_capacity
    lvl = torch.clamp(m.kf_level, 0, n_levels - 1).long()
    flat = torch.where(ok, pid * n_levels + lvl, P * n_levels)
    cnt = ms.scatter_add(P * n_levels, flat, 1).view(P, n_levels)
    cum = torch.cumsum(cnt, dim=1)  # observers at octave <= l
    band = torch.clamp(lvl + 1, max=n_levels - 1)
    # -1: the observation itself is within its own band.
    redundant = ok_counted & (cum[pid, band] - 1 >= 3)
    n_pts = ok_counted.sum(1)
    n_red = redundant.sum(1)
    kf_ids = torch.arange(m.kf_capacity, device=pts.device)
    cullable = (
        m.kf_valid & (kf_ids >= 2) & (kf_ids != _kf(current_kf, pts.device))
        & (kf_ids < m.n_kf)
        & (n_red.to(torch.float32) > 0.9 * n_pts.to(torch.float32)) & (n_pts > 0)
    )
    kf_valid = m.kf_valid & ~cullable
    parent = m.kf_parent
    for _ in range(4):  # chains of culled ancestors are short
        up = torch.clamp(parent, min=0).long()
        parent = torch.where(((parent >= 0) & kf_valid[up]) | (parent < 0), parent, parent[up])
    return m._replace(kf_valid=kf_valid, kf_parent=parent)


def _fuse_match(
    m: ms.MapState,
    kf_a,
    kf_b,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    inv_sigma2_lut: torch.Tensor,
    enabled=None,
):
    """Match stage of one Fuse direction (ORBmatcher::Fuse, ≈950): project
    kf_a's bound points into kf_b (frustum, distance band and 60-degree
    viewing gates), match in a 3-sigma window within one octave at TH_LOW,
    then a chi2 gate at the matched keypoint's octave.  ``enabled`` False
    disables the whole direction.  Returns (pid (N,), idx (N,), ok (N,))."""
    pts_a = m.kf_point[kf_a]
    src_ok = (pts_a >= 0) & m.kf_kp_valid[kf_a] & m.kf_valid[kf_a] & m.kf_valid[kf_b]
    if enabled is not None:
        src_ok = src_ok & enabled
    pid = torch.where(pts_a >= 0, pts_a, 0)
    pl = pid.long()
    src_ok = src_ok & m.pt_valid[pl]

    T = m.kf_pose_cw[kf_b]
    pos = m.pt_pos[pl]
    p_c = se3_apply(T, pos)
    z = torch.clamp(p_c[:, 2], min=1e-6)
    uv = torch.stack([cam.fx * p_c[:, 0] / z + cam.cx, cam.fy * p_c[:, 1] / z + cam.cy], -1)
    O_w = -T[:3, :3].T @ T[:3, 3]
    dist = torch.linalg.norm(pos - O_w, dim=-1)
    normal = m.pt_normal[pl]
    # Points whose normal is not computed yet (zero) pass the view gate.
    view_cos = torch.where(
        torch.linalg.norm(normal, dim=-1) < 1e-6, 1.0,
        ((pos - O_w) * normal).sum(-1) / torch.clamp(dist, min=1e-9),
    )
    vis = (
        src_ok & (p_c[:, 2] > 0.1) & in_image(cam, uv)
        & (dist >= 0.8 * m.pt_min_dist[pl]) & (dist <= 1.2 * m.pt_max_dist[pl])
        & (view_cos > 0.5)
    )
    pred_level = ms.predict_scale(dist, m.pt_max_dist[pl], scale_factors)
    xy_b = m.kf_xy[kf_b]
    d2 = ((uv[:, None, :] - xy_b[None, :, :]) ** 2).sum(-1)
    rr = (3.0 * scale_factors[pred_level]) ** 2
    lvl_ok = (m.kf_level[kf_b][None, :] - pred_level[:, None]).abs() <= 1
    mres = match_descriptors(
        m.pt_desc[pl], vis, m.kf_desc[kf_b], m.kf_kp_valid[kf_b],
        pair_mask=(d2 <= rr[:, None]) & lvl_ok, max_dist=TH_LOW, ratio=1.0,
    )
    idx = torch.where(mres.ok, mres.idx, 0)
    err2 = ((uv - xy_b[idx]) ** 2).sum(-1)
    lvl_b = torch.clamp(m.kf_level[kf_b][idx], 0, inv_sigma2_lut.shape[0] - 1).long()
    ok = mres.ok & (err2 * inv_sigma2_lut[lvl_b] <= 5.991)
    return pid, mres.idx, ok


def _survivors(n_obs, row, incoming, P):
    """MapPoint::Replace keeps the better-observed point (the incoming one
    on a tie): returns (dup, old, new)."""
    dup = (row >= 0) & (incoming >= 0) & (row != incoming)
    a_survives = (n_obs[torch.clamp(incoming, 0, P - 1).long()]
                  >= n_obs[torch.clamp(row, 0, P - 1).long()])
    old = torch.where(a_survives, row, incoming)
    new = torch.where(a_survives, incoming, row)
    return dup, torch.where(dup, old, -1), new


def _replacement_map(P, dup, old_do, new, device) -> torch.Tensor:
    """(P,) point id -> survivor, identity where untouched."""
    return ms.scatter_last(torch.arange(P, dtype=torch.int32, device=device),
                           torch.where(dup, old_do, P),
                           torch.where(dup, new, 0).to(torch.int32))


def _fuse_apply(m: ms.MapState, kf_b, pid, idx, ok):
    """Binding / Replace stage of one Fuse direction (MapPoint::Replace,
    ≈180): a match on an unbound keypoint adds an observation; a match on a
    keypoint bound to another point merges the two.  Returns (m, repl),
    ``repl`` (P,) mapping each point to its survivor."""
    P = m.pt_capacity
    ok = ok & m.pt_valid[torch.clamp(pid, 0, P - 1).long()]
    row = m.kf_point[kf_b]
    incoming = ms.scatter_last(torch.full_like(row, NO_POINT), torch.where(ok, idx, 0),
                               torch.where(ok, pid, NO_POINT))
    dup, old_do, new = _survivors(ms.point_observation_counts(m), row, incoming, P)
    m = ms.apply_point_replacements(m, old_do, new, dup)
    repl = _replacement_map(P, dup, old_do, new, row.device)
    row2 = m.kf_point[kf_b]
    row_new = torch.where((row2 < 0) & (incoming >= 0), incoming, row2)
    return m._replace(kf_point=_set_row(m.kf_point, _kf(kf_b, row.device), row_new)), repl


def fuse_with_neighbor(
    m: ms.MapState,
    kf_a,
    kf_b,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    inv_sigma2_lut: torch.Tensor,
) -> ms.MapState:
    """One direction of SearchInNeighbors (LocalMapping.cc:≈370)."""
    pid, idx, ok = _fuse_match(m, kf_a, kf_b, cam, scale_factors, inv_sigma2_lut)
    return _fuse_apply(m, kf_b, pid, idx, ok)[0]


def fuse_neighborhood(
    m: ms.MapState,
    pairs_a: torch.Tensor,   # (D,) source keyframes
    pairs_b: torch.Tensor,   # (D,) target keyframes
    cam: CameraModel,
    scale_factors: torch.Tensor,
    inv_sigma2_lut: torch.Tensor,
    pair_valid: torch.Tensor = None,
) -> ms.MapState:
    """SearchInNeighbors over D directions: every direction is matched
    against the pre-fuse map, then the bindings apply in pair order.  Each
    direction composes the (P,) replacement map ``cur`` (later directions
    see earlier merges through it), moves observation counts incrementally
    and rewrites its one target row; one ``apply_point_replacements`` at the
    end rebinds every merge to its terminal survivor."""
    if pair_valid is None:
        pair_valid = torch.ones(pairs_a.shape[0], dtype=torch.bool, device=pairs_a.device)
    D = pairs_a.shape[0]
    matches = [
        _fuse_match(m, pairs_a[d].long(), pairs_b[d].long(), cam, scale_factors,
                    inv_sigma2_lut, enabled=pair_valid[d])
        for d in range(D)
    ]
    P = m.pt_capacity
    dev = m.kf_point.device
    n_obs = ms.point_observation_counts(m)
    cur = torch.arange(P, dtype=torch.int32, device=dev)
    kf_point = m.kf_point
    merges_old, merges_new, merges_do = [], [], []
    for d, (pid, idx, ok) in enumerate(matches):
        kf_b = pairs_b[d].long()
        pid_raw = torch.clamp(pid, 0, P - 1).long()
        ok = ok & m.pt_valid[pid_raw]
        row = kf_point[kf_b]
        row = torch.where(row >= 0, cur[torch.clamp(row, 0, P - 1).long()], row)
        incoming = ms.scatter_last(torch.full_like(row, NO_POINT), torch.where(ok, idx, 0),
                                   torch.where(ok, cur[pid_raw], NO_POINT))
        dup, old_do, new = _survivors(n_obs, row, incoming, P)
        merges_old.append(old_do)
        merges_new.append(new)
        merges_do.append(dup)
        repl_d = _replacement_map(P, dup, old_do, new, dev)
        cur = repl_d[cur.long()]
        old_safe = torch.clamp(old_do, 0, P - 1)
        moved = torch.where(dup, n_obs[old_safe.long()], 0)
        n_obs = n_obs.index_add(0, torch.clamp(new, 0, P - 1).long(), moved)
        n_obs = n_obs.index_add(0, old_safe.long(), -moved)
        row2 = torch.where(row >= 0, repl_d[torch.clamp(row, 0, P - 1).long()], row)
        incoming2 = torch.where(incoming >= 0, repl_d[torch.clamp(incoming, 0, P - 1).long()],
                                incoming)
        newly = (row2 < 0) & (incoming2 >= 0)
        n_obs = n_obs + ms.scatter_add(P, torch.where(newly, incoming2, P), 1)
        kf_point = _set_row(kf_point, kf_b, torch.where(newly, incoming2, row2))
    m = m._replace(kf_point=kf_point)
    mo = torch.cat(merges_old)
    mn = torch.cat(merges_new)
    md = torch.cat(merges_do)
    # Chained merges (old1 -> s, then s -> s2) go to the terminal survivor.
    mn_t = torch.where(md, cur[torch.clamp(mn, 0, P - 1).long()], mn)
    return ms.apply_point_replacements(m, mo, mn_t, md)


class LocalMapper:
    """Host-side runner of the per-keyframe mapping sequence.  It holds no
    tensors of its own: its tables go to the device of the map it is given.
    """

    def __init__(self, settings: Settings, enable_ba: bool = True,
                 enable_kf_culling: bool = True, enable_fuse: bool = True,
                 sensor: str = "mono", n_fuse_neighbors: int = None, mesh=None):
        from ..parallel.mesh import check_mesh

        # A mesh of several ranks shards local BA's cameras over them
        # (parallel/dist_ba.py); a mesh of one is ignored, as the
        # reference ignores it.
        self.mesh = check_mesh(mesh, "LocalMapper")
        self.settings = settings
        tpu = settings.tpu
        # Window caps, clamped to the keyframe pool (a covisibility ranking
        # cannot return more ids than there are keyframes).
        K = tpu.max_keyframes
        self.n_fuse_neighbors = min(
            n_fuse_neighbors if n_fuse_neighbors is not None else tpu.fuse_first_neighbors,
            max(1, K - 1),
        )
        self.n_fuse_second = min(tpu.fuse_second_neighbors, max(0, K - 1 - self.n_fuse_neighbors))
        self.ba_n_local = min(tpu.ba_local_window, max(2, K // 2))
        self.ba_n_fixed = min(tpu.ba_fixed_window, max(0, K - self.ba_n_local))
        self.cam = settings.camera_model()
        orb = settings.orb
        self._scale_factors = np.asarray(
            pyr_ops.scale_factors(orb.n_levels, orb.scale_factor), np.float32)
        self._sigma2 = np.asarray(pyr_ops.level_sigma2(orb.n_levels, orb.scale_factor), np.float32)
        self._tables = {}
        self.enable_ba = enable_ba
        self.enable_kf_culling = enable_kf_culling
        self.enable_fuse = enable_fuse
        # Triangulation neighbours: 20 mono, 10 stereo/RGB-D (≈190).
        self.n_tri_neighbors = min(
            tpu.tri_neighbors_mono if sensor == "mono" else tpu.tri_neighbors_stereo,
            max(1, K - 1),
        )
        # KeyFrameCulling's close-point gate applies when a baseline exists.
        self._bf = float(settings.camera.bf) if sensor != "mono" else 0.0
        self._cull_th_depth = float(settings.camera.th_depth)

    def tables(self, device):
        """(scale_factors, sigma2, inv_sigma2) float32 on ``device``."""
        key = str(device)
        if key not in self._tables:
            sf = torch.from_numpy(self._scale_factors).to(device)
            s2 = torch.from_numpy(self._sigma2).to(device)
            self._tables[key] = (sf, s2, torch.from_numpy(1.0 / self._sigma2).to(device))
        return self._tables[key]

    def _local_ba(self, m: ms.MapState, kf_id, n_now: int) -> ms.MapState:
        n_local = _bucket(self.ba_n_local, n_now)
        n_fixed = min(self.ba_n_fixed, n_local)
        # Landmark cap: each free camera adds at most a frame of features,
        # heavily shared within the window.
        pt_cap = min(8192, max(2, n_local // 2) * m.feat_capacity)
        return local_bundle_adjustment(
            m, kf_id, self.cam, self.tables(m.pt_pos.device)[2],
            n_local=n_local, n_fixed=n_fixed, pt_cap=pt_cap, mesh=self.mesh,
        )

    def fuse_pairs(self, m: ms.MapState, kf: torch.Tensor, small: bool):
        """SearchInNeighbors' directions for keyframe ``kf``: its first-order
        covisible neighbours plus, on a grown map, the keyframes most
        covisible with that ring, each fused both ways.  Zero-covisibility
        targets are disabled, never fused.  Returns (pairs_a, pairs_b,
        pair_valid, targets)."""
        nn = min(8, self.n_fuse_neighbors) if small else self.n_fuse_neighbors
        nn2 = 0 if small else self.n_fuse_second
        neighbor_ids, weights = ms.best_covisible(m, kf, nn)
        targets = neighbor_ids[:nn].long()
        target_ok = weights[:nn] > 0
        if nn2 > 0:
            ring = targets
            ring_pts = m.kf_point[ring]
            ring_ok = (ring_pts >= 0) & m.kf_kp_valid[ring] & m.kf_valid[ring][:, None]
            member = ms.scatter_max(m.pt_capacity,
                                    torch.where(ring_ok, ring_pts, m.pt_capacity), 1) > 0
            obs_ok = (m.kf_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
            votes2 = (member[torch.where(obs_ok, m.kf_point, 0).long()] & obs_ok).sum(1)
            in_ring = torch.zeros(m.kf_capacity, dtype=torch.bool, device=kf.device)
            in_ring = in_ring.index_fill(0, ring, True).index_fill(0, kf.view(1), True)
            v2, second = topk_stable(torch.where(in_ring, -1.0, votes2.to(torch.float32)), nn2)
            targets = torch.cat([ring, second])
            target_ok = torch.cat([target_ok, v2 > 0])
        pairs_a = torch.stack([kf.expand_as(targets), targets], 1).reshape(-1)
        pairs_b = torch.stack([targets, kf.expand_as(targets)], 1).reshape(-1)
        return pairs_a, pairs_b, torch.repeat_interleave(target_ok, 2), targets

    def on_initial_map(self, m: ms.MapState) -> ms.MapState:
        """The mono map bootstrap's refinement (the reference runs a global
        BA here): local BA around keyframe 1 at the two-keyframe bucket,
        then the point statistics."""
        if self.enable_ba:
            sf = self.tables(m.pt_pos.device)[0]
            m = self._local_ba(m, _kf(1, m.pt_pos.device), n_now=2)
            m = ms.update_point_stats(m, sf)
        return m

    def process_keyframe(self, m, kf_id: int, abort=None, n_now: int = None):
        """The mapping sequence for keyframe ``kf_id`` (an int): cull
        points, triangulate, fuse, refresh point statistics, local BA,
        distinctive descriptors of the touched points, cull keyframes.
        Every window is sized from ``n_now`` (default kf_id + 1), the
        keyframes in use: the small bucket up to 8 keyframes.

        ``abort``, a ``threading.Event`` (the InterruptBA analog,
        LocalMapping.cc mbAbortBA): once it is set, local BA and every
        stage after it are skipped; the structural stages (culling,
        triangulation, fuse, point statistics) always complete.

        ``m`` may be a map sharded over a mesh (``parallel/distributed.
        shard_map_state``): it is gathered whole on entry, mapped as an
        unsharded map is, and this rank's block is returned."""
        from ..parallel.distributed import ShardedMap, gather_map_state, shard_map_state

        if isinstance(m, ShardedMap):
            out = self.process_keyframe(gather_map_state(m), kf_id, abort=abort, n_now=n_now)
            return shard_map_state(out, m.mesh)

        def aborted():
            return abort is not None and abort.is_set()

        dev = m.pt_pos.device
        sf, sigma2, inv_sigma2 = self.tables(dev)
        kf = _kf(kf_id, dev)
        if n_now is None:
            n_now = int(kf_id) + 1
        small = n_now <= 8
        nn_tri = min(8, self.n_tri_neighbors) if small else self.n_tri_neighbors
        with record_function(STAGE_PREFIX + "cull_map_points"):
            m = cull_map_points(m)
        with record_function(STAGE_PREFIX + "triangulate_new_points"):
            tri_ids, _ = ms.best_covisible(m, kf, nn_tri)
            m = triangulate_new_points(m, kf, self.cam, sf, sigma2, n_neighbors=nn_tri)
        touched = [kf.view(1).to(torch.int32), tri_ids]
        if self.enable_fuse:
            with record_function(STAGE_PREFIX + "fuse_neighborhood"):
                pairs_a, pairs_b, pair_valid, targets = self.fuse_pairs(m, kf, small)
                touched.append(targets.to(torch.int32))
                m = fuse_neighborhood(m, pairs_a, pairs_b, self.cam, sf, inv_sigma2,
                                      pair_valid=pair_valid)
        with record_function(STAGE_PREFIX + "update_point_stats"):
            m = ms.update_point_stats(m, sf)
        if self.enable_ba and not aborted():
            with record_function(STAGE_PREFIX + "local_bundle_adjustment"):
                m = self._local_ba(m, kf, n_now)
                # Outlier unbinding changes the observation sets of points
                # seen anywhere in the BA window: refresh those descriptors.
                row = ms.covisible_row(m, kf)
                _, ba_window = topk_stable(
                    row, min(self.ba_n_local + self.ba_n_fixed, row.shape[0]))
                touched.append(ba_window.to(torch.int32))
        if aborted():
            return m
        with record_function(STAGE_PREFIX + "compute_distinctive_descriptors"):
            m = ms.compute_distinctive_descriptors(m, touched_kfs=torch.cat(touched))
        if self.enable_kf_culling:
            with record_function(STAGE_PREFIX + "cull_keyframes"):
                m = cull_keyframes(m, kf, n_levels=self.settings.orb.n_levels,
                                   bf=self._bf, th_depth=self._cull_th_depth)
        return m
