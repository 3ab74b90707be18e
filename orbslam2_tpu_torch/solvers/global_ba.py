"""Global bundle adjustment: the joint Schur solve and the alternation.

Port of ``orbslam2_tpu/solvers/global_ba.py`` (``Optimizer::
GlobalBundleAdjustemnt``, src/Optimizer.cc:≈60, as run by
LoopClosing::RunGlobalBundleAdjustment, ≈530):

  run_joint_global_ba       one LM problem over every valid keyframe and
                            point: the map is compacted on the host, padded
                            to a power of two, and solved by local BA's
                            Schur engine (``local_ba.schur_ba_core``, so K4
                            and K5 at C = ``_next_pow2(n_kf)`` cameras);
  global_bundle_adjustment  the fallback beyond the joint solver's camera
                            cap: resection (every keyframe pose by a
                            batched 6x6 step) alternating with intersection
                            (every point by a 3x3 step over its
                            observations, summed in a fixed order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models import map_state as ms
from ..models.kf_database import fetch
from ..utils.camera import CameraModel
from .ba_kernels import CHI2_MONO, CHI2_STEREO
from .lie import hat, inv3x3, orthonormalize_se3, se3_exp
from .local_ba import pad_cameras, schur_ba_core


def global_bundle_adjustment(
    m: ms.MapState,
    cam: CameraModel,
    inv_sigma2_lut: torch.Tensor,
    rounds: int = 6,
    unbind_outliers: bool = True,
) -> ms.MapState:
    """Alternating global refinement of all valid keyframes and points;
    keyframe 0 is the gauge.  Each half-step is kept only if it lowers the
    robust cost.  With ``unbind_outliers``, observations that end above
    their chi2 threshold (or were pruned) are unbound, but only when the
    solve lowered the cost."""
    K, N = m.kf_point.shape
    P = m.pt_capacity
    dev = m.pt_pos.device

    uv = m.kf_xy
    ur = m.kf_ur
    inv_s2 = inv_sigma2_lut[torch.clamp(m.kf_level, 0, inv_sigma2_lut.shape[0] - 1).long()]
    pid_raw = m.kf_point
    obs_ok = (pid_raw >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pid = torch.where(obs_ok, pid_raw, 0).long()
    obs_ok = obs_ok & m.pt_valid[pid]
    has_ur = ur >= 0
    chi2_th = torch.where(has_ur, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    kf_free = m.kf_valid & (torch.arange(K, device=dev) > 0)
    # The intersection's sums over each point's observations: one plan.
    flat = torch.where(obs_ok, pid, P).reshape(-1)
    plan = ms.segment_plan(P, flat)

    def residual_all(poses, pts):
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        pc = torch.einsum("kij,knj->kni", R, pts[pid]) + t[:, None, :]
        z = torch.clamp(pc[..., 2], min=1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        r = torch.stack([u - uv[..., 0], v - uv[..., 1],
                         torch.where(has_ur, (u - cam.bf / z) - ur, 0.0)], -1)
        return r, pc

    def chi2_all(poses, pts):
        r, pc = residual_all(poses, pts)
        c = (r * r).sum(-1) * inv_s2
        return torch.where(pc[..., 2] <= 1e-6, 1e9, c)

    def j_proj(pc):
        z = torch.clamp(pc[..., 2], min=1e-6)
        zi = 1.0 / z
        zi2 = zi * zi
        x, y = pc[..., 0], pc[..., 1]
        zeros = torch.zeros_like(x)
        J = torch.stack([
            torch.stack([cam.fx * zi, zeros, -cam.fx * x * zi2], -1),
            torch.stack([zeros, cam.fy * zi, -cam.fy * y * zi2], -1),
            torch.stack([cam.fx * zi, zeros, (-cam.fx * x + cam.bf) * zi2], -1),
        ], dim=-2)
        return torch.cat([J[..., :2, :], torch.where(has_ur[..., None, None], J[..., 2:, :], 0.0)],
                         dim=-2)

    def resection(poses, pts, w_obs):
        """Batched per-keyframe pose GN step (all keyframes at once)."""
        r, pc = residual_all(poses, pts)
        I3 = torch.eye(3, dtype=pc.dtype, device=dev).expand(pc.shape + (3,))
        J = j_proj(pc) @ torch.cat([I3, -hat(pc)], -1)              # (K, N, 3, 6)
        H = torch.einsum("knij,kn,knil->kjl", J, w_obs, J)            # (K, 6, 6)
        b = torch.einsum("knij,kn,kni->kj", J, w_obs, r)
        damp = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
        A = H + 1e-3 * damp + 1e-6 * torch.eye(6, dtype=H.dtype, device=dev)[None]
        delta = -torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
        poses_new = se3_exp(delta) @ poses
        return torch.where(kf_free[:, None, None], poses_new, poses)

    def intersection(poses, pts, w_obs):
        """Batched per-point 3x3 GN step over each point's observations."""
        r, pc = residual_all(poses, pts)
        Jp = j_proj(pc) @ poses[:, None, :3, :3]                       # (K, N, 3, 3)
        Hc = torch.einsum("knij,kn,knil->knjl", Jp, w_obs, Jp).reshape(-1, 3, 3)
        bc = torch.einsum("knij,kn,kni->knj", Jp, w_obs, r).reshape(-1, 3)
        H = ms.segment_sum(P, flat, Hc, plan)
        b = ms.segment_sum(P, flat, bc, plan)
        tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
        ok = m.pt_valid & (tr > 1e-9)
        eye3 = torch.eye(3, dtype=H.dtype, device=dev)
        Hd = H + (1e-3 * torch.clamp(tr, min=1e-6) / 3.0)[:, None, None] * eye3
        delta = -(inv3x3(Hd + 1e-9 * eye3) @ b[..., None])[..., 0]
        return torch.where(ok[:, None], pts + delta, pts)

    poses = m.kf_pose_cw
    pts = m.pt_pos
    obs_mask = obs_ok

    def capped(c, mask):
        return torch.where(mask, torch.minimum(c, chi2_th), 0.0).sum()

    err_initial = capped(chi2_all(poses, pts), obs_ok)
    for k in range(rounds):
        # Huber IRLS weights on the current residuals (robust first half).
        c = chi2_all(poses, pts)
        wh = torch.clamp(torch.sqrt(chi2_th) / torch.sqrt(torch.clamp(c, min=1e-12)), max=1.0)
        if k >= rounds // 2:
            obs_mask = obs_mask & (c <= chi2_th)
            wh = torch.ones_like(wh)
        w_obs = inv_s2 * obs_mask.to(torch.float32) * wh
        # Keep a half-step only if it lowers the robust cost.
        err0 = capped(c, obs_mask)
        poses_new = resection(poses, pts, w_obs)
        poses = torch.where(capped(chi2_all(poses_new, pts), obs_mask) < err0, poses_new, poses)
        err1 = capped(chi2_all(poses, pts), obs_mask)
        pts_new = intersection(poses, pts, w_obs)
        pts = torch.where(capped(chi2_all(poses, pts_new), obs_mask) < err1, pts_new, pts)

    kf_point = m.kf_point
    if unbind_outliers:
        # Only when the solve improved the map, measured over the same mask
        # as err_initial (a pruned observation keeps its capped chi2).
        c = chi2_all(poses, pts)
        improved = capped(c, obs_ok) < err_initial
        bad = obs_ok & ((c > chi2_th) | ~obs_mask)
        kf_point = torch.where(bad & improved, ms.NO_POINT, kf_point)
    return m._replace(kf_pose_cw=poses, pt_pos=pts, kf_point=kf_point)


def _next_pow2(n: int, lo: int = 16) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def run_joint_global_ba(
    m: ms.MapState,
    cam: CameraModel,
    inv_sigma2_lut: torch.Tensor,
    phase_iters: Tuple[int, int] = (5, 10),
    max_cams: int = 512,
    initial_prune: float = 0.0,
    unbind_outliers: bool = True,
    mesh=None,
) -> ms.MapState:
    """Joint Schur GBA over every valid keyframe and point: one host read
    of the pools' validity, then the valid keyframes and points are
    gathered into dense prefixes padded to powers of two (C >= 16 cameras,
    >= 256 points), the observation index remapped, ``schur_ba_core`` run
    with every camera free but the lowest-id keyframe (the reference fixes
    KF0, Optimizer.cc:≈100), and the poses and points scattered back.
    Returns ``m`` itself when the map has fewer than 2 keyframes, no point,
    or more than ``max_cams`` keyframes.

    ``unbind_outliers`` persists the solver's chi2 pruning by unbinding the
    pruned observations.  With ``mesh`` the solve is sharded over the
    cameras (``schur_ba_core``), C padded to a multiple of the mesh size."""
    kv, pv = fetch([m.kf_valid, m.pt_valid])
    kf_ids = np.nonzero(kv)[0]
    pt_ids = np.nonzero(pv)[0]
    if len(kf_ids) < 2 or len(pt_ids) == 0 or len(kf_ids) > max_cams:
        return m
    dev = m.pt_pos.device
    n_k, n_p = len(kf_ids), len(pt_ids)
    C = pad_cameras(_next_pow2(n_k), mesh)
    Pa = _next_pow2(n_p, lo=256)

    kf_pad = np.zeros(C, np.int64)
    kf_pad[:n_k] = kf_ids
    kf_pad = torch.from_numpy(kf_pad).to(dev)
    pt_ids_t = torch.from_numpy(pt_ids.astype(np.int64)).to(dev)
    used = torch.arange(C, device=dev) < n_k
    is_fixed = torch.arange(C, device=dev) == 0  # kf_ids is sorted ascending

    # Compact point index: pool id -> [0, Pa) slot.
    pt_slot = torch.full((m.pt_capacity,), -1, dtype=torch.int64, device=dev)
    pt_slot[pt_ids_t] = torch.arange(n_p, device=dev)
    pid_raw = m.kf_point[kf_pad].long()                                 # (C, N)
    obs_ok = (pid_raw >= 0) & m.kf_kp_valid[kf_pad] & used[:, None]
    slot = torch.where(obs_ok, pt_slot[pid_raw.clamp(min=0)], -1)
    obs_ok = obs_ok & (slot >= 0)
    pid = torch.where(obs_ok, slot.clamp(min=0), 0)

    lvl = torch.clamp(m.kf_level[kf_pad], 0, inv_sigma2_lut.shape[0] - 1).long()
    inv_s2 = inv_sigma2_lut[lvl]
    ur = torch.where(used[:, None], m.kf_ur[kf_pad], -1.0)
    pts0 = torch.zeros((Pa, 3), dtype=torch.float32, device=dev)
    pts0[:n_p] = m.pt_pos[pt_ids_t]
    poses, pts, obs_mask, _ = schur_ba_core(
        m.kf_pose_cw[kf_pad], pts0, m.kf_xy[kf_pad], ur, inv_s2, pid, obs_ok,
        is_fixed, used, cam, phase_iters=phase_iters, initial_prune=initial_prune, mesh=mesh,
    )

    kf_ids_t = kf_pad[:n_k]
    kf_pose = ms.scatter_last(m.kf_pose_cw, kf_ids_t, orthonormalize_se3(poses[:n_k]))
    pt_pos = ms.scatter_last(m.pt_pos, pt_ids_t, pts[:n_p])
    kf_point = m.kf_point
    if unbind_outliers:
        pruned = obs_ok & ~obs_mask                                     # (C, N)
        rows = torch.where(pruned[:n_k], ms.NO_POINT, m.kf_point[kf_ids_t])
        kf_point = ms.scatter_last(kf_point, kf_ids_t, rows)
    return m._replace(kf_pose_cw=kf_pose, pt_pos=pt_pos, kf_point=kf_point)
