"""Local bundle adjustment with the landmark Schur complement.

Port of ``orbslam2_tpu/solvers/local_ba.py`` (``Optimizer::
LocalBundleAdjustment``, src/Optimizer.cc:≈460, and g2o's BlockSolver_6_3):

  * the window is the current keyframe + its top covisible keyframes, the
    next covisible ring held fixed, all as fixed-size gathers;
  * every LM step builds its blocks with K4 (``ba_kernels.
    ba_normal_equations``) and scores candidates with K5 (``ba_chi2``): the
    CUDA kernels on the card, their plain versions on the CPU, followed on
    both by the same gather tail (``_point_blocks``: the 3x3 landmark
    blocks, their right-hand sides and the 6x3 cross blocks gathered through
    the inverse observation index, the landmark sums taken over the camera
    axis in a fixed order, with no atomics);
  * landmark blocks are inverted in closed form, the reduced camera system
    S = H_cc - H_cp H_pp^-1 H_pc is dense (6C, 6C) and solved by Cholesky;
  * the reference's 5 robust + 10 plain iterations with chi2 outlier
    pruning between (Optimizer.cc:≈560); the accept test and the damping
    schedule stay on the device (``torch.where``), so the 15 iterations read
    nothing back to the host.

The multi-device form (``axis_name``/``n_shards`` in the reference) is
ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models import map_state as ms
from ..ops.select import topk_stable
from ..utils.camera import CameraModel
from .ba_kernels import CHI2_MONO, CHI2_STEREO, ba_chi2, ba_normal_equations
from .lie import hat, inv3x3, orthonormalize_se3, se3_exp

# H_pp entries in the order of the pack's rows 0-5 (00, 01, 02, 11, 12, 22),
# read back into a full symmetric 3x3.
_HPP_FULL = (0, 1, 2, 1, 3, 4, 2, 4, 5)


def _gather_problem(m: ms.MapState, kf_id, n_local: int, n_fixed: int):
    """Camera set = [kf_id, top local covisible..., fixed ring...].  Ties in
    the covisibility ranking go to the lower id, so a young map pads the
    window with zero-weight ids in id order (``kf_id`` itself among them).

    Returns (cam_ids (C,), is_fixed (C,), used (C,))."""
    row = ms.covisible_row(m, kf_id)
    _, order = topk_stable(row, n_local + n_fixed - 1)
    kf = torch.as_tensor(kf_id, device=row.device).long().view(1)
    cam_ids = torch.cat([kf, order])
    ar = torch.arange(cam_ids.shape[0], device=row.device)
    used = m.kf_valid[cam_ids] & ((ar == 0) | (row[cam_ids] > 0))
    # Gauge: the lowest keyframe id in the used set is held fixed.
    gauge = torch.argmin(torch.where(used, cam_ids, 2**30))
    is_fixed = (ar >= n_local) | (ar == gauge)
    return cam_ids, is_fixed, used


def _residuals(poses, pts, uv, ur, pid, cam: CameraModel):
    """Residuals and Jacobians over (C, N) observations, the einsum
    formulation that K4 packs: returns r (C, N, 3), J_cam (C, N, 3, 6),
    J_pt (C, N, 3, 3), behind (C, N)."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    pc = torch.einsum("cij,cnj->cni", R, pts[pid.long()]) + t[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    zi2 = zi * zi
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    has_ur = ur >= 0
    r = torch.stack(
        [u - uv[..., 0], v - uv[..., 1], torch.where(has_ur, (u - cam.bf * zi) - ur, 0.0)], -1
    )
    zeros = torch.zeros_like(x)
    J_proj = torch.stack(
        [
            torch.stack([cam.fx * zi, zeros, -cam.fx * x * zi2], -1),
            torch.stack([zeros, cam.fy * zi, -cam.fy * y * zi2], -1),
            torch.where(
                has_ur[..., None],
                torch.stack([cam.fx * zi, zeros, (-cam.fx * x + cam.bf) * zi2], -1), 0.0,
            ),
        ],
        dim=-2,
    )
    I3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape + (3,))
    J_cam = J_proj @ torch.cat([I3, -hat(pc)], dim=-1)
    J_pt = J_proj @ R[:, None, :, :]
    return r, J_cam, J_pt, z <= 1e-6


def _inverse_slots(pid: torch.Tensor, obs_ok: torch.Tensor, P: int):
    """Inverse observation index: inv_slot[c, p] = the first keypoint slot
    of point p in camera c (N where unobserved).  Returns (inv_slot (C, P),
    obs_ok without the observations that are not that first slot), so that
    every (camera, point) pair has one observation."""
    C, N = pid.shape
    dev = pid.device
    cam_iota = torch.arange(C, device=dev)[:, None].expand(C, N)
    obs_iota = torch.arange(N, device=dev)[None, :].expand(C, N)
    flat = cam_iota * (P + 1) + torch.where(obs_ok, pid, P)
    inv_slot = ms.scatter_min(
        C * (P + 1), flat, torch.where(obs_ok, obs_iota, N), fill=N
    ).view(C, P + 1)[:, :P]
    return inv_slot, obs_ok & (inv_slot.gather(1, pid) == obs_iota)


def _point_blocks(pack: torch.Tensor, inv_slot: torch.Tensor, free_f: torch.Tensor):
    """The landmark side of K4's pack (C, 32, N), P-minor through the
    inverse index: returns (H_pp (P, 3, 3), b_p (P, 3), Gp (C, 6, 3, P)).

    H_pp and b_p sum each point's rows 0-8 over the cameras with ``sum``, a
    reduction in a fixed order for a given shape (a float scatter-add runs
    through atomics on the card, in an order that changes from run to run).
    The gather reads one slot per (camera, point) pair, the first one, and
    skips the others: the later duplicates and the slots outside obs_ok.
    Those are outside the solve's obs_mask, so K4 gives them weight w = 0,
    and their rows, each w times a finite Jacobian product (z is clamped at
    1e-6 before 1/z), are zero: what a scatter-add over every slot would
    have added for them.  Cross blocks of fixed cameras (``free_f`` 0) are
    zero."""
    C = pack.shape[0]
    P = inv_slot.shape[1]
    rows = pack[:, :27, :]
    rows = torch.cat([rows, torch.zeros_like(rows[:, :, :1])], dim=2)  # slot N: unobserved
    per_cam = rows.gather(2, inv_slot[:, None, :].expand(C, 27, P))    # (C, 27, P)
    sums = per_cam[:, :9].sum(0)                                         # (9, P)
    H_pp = torch.stack([sums[i] for i in _HPP_FULL], dim=1).view(P, 3, 3)
    b_p = sums[6:9].T
    Gp = (per_cam[:, 9:27] * free_f[:, None, None]).view(C, 6, 3, P)
    return H_pp, b_p, Gp


def _blockdiag(blocks: torch.Tensor) -> torch.Tensor:
    """(C, 6, 6) -> (6C, 6C) block diagonal."""
    C = blocks.shape[0]
    out = torch.zeros((C, 6, C, 6), dtype=blocks.dtype, device=blocks.device)
    idx = torch.arange(C, device=blocks.device)
    out[idx, :, idx, :] = blocks
    return out.reshape(C * 6, C * 6)


def schur_ba_core(
    poses0: torch.Tensor,      # (C, 4, 4)
    pts0: torch.Tensor,        # (P, 3) the points pid indexes
    uv: torch.Tensor,          # (C, N, 2)
    ur: torch.Tensor,          # (C, N) (-1 = mono observation)
    inv_s2: torch.Tensor,      # (C, N)
    pid: torch.Tensor,         # (C, N) into pts0, in range
    obs_ok: torch.Tensor,      # (C, N)
    is_fixed: torch.Tensor,    # (C,)
    used: torch.Tensor,        # (C,)
    cam: CameraModel,
    phase_iters: Tuple[int, ...] = (5, 10),
    initial_prune: float = 0.0,
):
    """The Schur-complement LM engine: 5 robust + 10 plain iterations with
    chi2 pruning after each phase.  ``initial_prune`` > 0 first masks
    observations whose chi2 at the initial geometry exceeds
    ``initial_prune`` times their threshold.

    One K4 launch per iteration and one K5 launch per candidate, per
    phase's incumbent cost and per pruning: 15 and 19 with the default
    schedule.

    Returns (poses (C, 4, 4), pts (P, 3), obs_mask (C, N) inliers,
    pt_in (P,) participating points)."""
    C, N = pid.shape
    P = pts0.shape[0]
    dev = pts0.device
    pid = pid.long()
    has_ur = ur >= 0
    chi2_th = torch.where(has_ur, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    uvT = uv.transpose(1, 2).contiguous()  # (C, 2, N), loop-invariant

    # Points observed by at least one used camera.
    pt_in = ms.scatter_max(P, pid, obs_ok.to(torch.int32)) > 0

    def X_of(pts):
        return pts[pid].transpose(1, 2)  # (C, 3, N)

    def chi2_obs(poses, pts, mask):
        return ba_chi2(poses, X_of(pts), uvT, ur, inv_s2, mask, cam)[0]

    def cost(poses, pts, mask):
        # The masked total, 1e9 sentinels included.
        return ba_chi2(poses, X_of(pts), uvT, ur, inv_s2, mask, cam)[1].sum()

    # One observation per (camera, point) pair: the dropped duplicates
    # leave the returned inlier mask.
    inv_slot, obs_ok = _inverse_slots(pid, obs_ok, P)

    free_f = (~is_fixed).to(torch.float32)
    free6 = torch.repeat_interleave((~is_fixed) & used, 6)
    fix_diag = torch.diag(torch.where(free6, 0.0, 1.0))

    def blocks(poses, pts, obs_mask, robust):
        H_cc, b_c, pack, _ = ba_normal_equations(
            poses, X_of(pts), uvT, ur, inv_s2, obs_mask, cam, robust)
        # Fixed cameras contribute nothing camera-side (H_cc, b_c, G) and
        # keep their point-side contributions.
        H_cc = H_cc * free_f[:, None, None]
        b_c = b_c * free_f[:, None]
        return (H_cc, b_c, *_point_blocks(pack, inv_slot, free_f))

    def lm_step(poses, pts, obs_mask, lam, robust):
        H_cc, b_c, H_pp, b_p, Gp = blocks(poses, pts, obs_mask, robust)
        tr = H_pp.diagonal(dim1=-2, dim2=-1).sum(-1)
        H_pp_d = H_pp + (lam * eye3)[None] * torch.clamp(tr / 3.0, min=1e-6)[:, None, None]
        active = pt_in & (tr > 1e-9)
        Hpp_inv = torch.where(active[:, None, None], inv3x3(H_pp_d + 1e-9 * eye3), 0.0)

        # Reduced camera system, matmul form over the P-minor cross blocks.
        A = torch.einsum("cijp,pjk->cikp", Gp, Hpp_inv)
        S = _blockdiag(H_cc) - torch.einsum("cikp,dlkp->cidl", A, Gp).reshape(C * 6, C * 6)
        rhs = (b_c - torch.einsum("cikp,pk->ci", A, b_p)).reshape(-1)
        # LM damping on cameras; identity rows for fixed and unused ones.
        S = S + torch.diag(lam * torch.clamp(torch.diagonal(S), min=1e-6))
        S = torch.where(free6[:, None] & free6[None, :], S, 0.0) + fix_diag
        rhs = torch.where(free6, rhs, 0.0)
        # cholesky_ex: no info check, which would read back to the host.
        L = torch.linalg.cholesky_ex(S)[0]
        delta_c = -torch.cholesky_solve(rhs[:, None], L)[:, 0].view(C, 6)
        # Back-substitute the points: delta_p = -Hpp_inv (b_p + G^T delta_c).
        Gt_dc = torch.einsum("cijp,ci->pj", Gp, delta_c)
        delta_p = -torch.einsum("pij,pj->pi", Hpp_inv, b_p + Gt_dc)
        delta_p = torch.where(active[:, None], delta_p, 0.0)
        poses_new = se3_exp(delta_c) @ poses
        poses_new = torch.where(is_fixed[:, None, None], poses, poses_new)
        return poses_new, pts + delta_p

    poses, pts, obs_mask = poses0, pts0, obs_ok
    if initial_prune > 0.0:
        obs_mask = obs_mask & (chi2_obs(poses, pts, obs_mask) <= initial_prune * chi2_th)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    robust_of = (True, False) if len(phase_iters) > 1 else (True,)
    for iters, robust in zip(phase_iters, robust_of):
        err_cur = cost(poses, pts, obs_mask)
        for _ in range(iters):
            poses_new, pts_new = lm_step(poses, pts, obs_mask, lam, robust)
            err_new = cost(poses_new, pts_new, obs_mask)
            accept = err_new < err_cur
            poses = torch.where(accept, poses_new, poses)
            pts = torch.where(accept, pts_new, pts)
            err_cur = torch.where(accept, err_new, err_cur)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e2)
        obs_mask = obs_mask & (chi2_obs(poses, pts, obs_mask) <= chi2_th)
    return poses, pts, obs_mask, pt_in


def local_bundle_adjustment(
    m: ms.MapState,
    kf_id,
    cam: CameraModel,
    inv_sigma2_lut: torch.Tensor,
    n_local: int = 8,
    n_fixed: int = 8,
    phase_iters: Tuple[int, ...] = (5, 10),
    pt_cap: int = 4096,
) -> ms.MapState:
    """Local BA around ``kf_id``: poses of the free window keyframes and
    the window's points are optimized, outlier observations unbound.

    The landmark axis is compacted to the ``pt_cap`` points with the most
    in-window observations (ties to the lower id); points beyond the cap
    keep their positions and their observations leave the solve.

    The write-back follows the reference scatter for scatter: where the
    camera set lists ``kf_id`` a second time (a young map's padding), that
    later, unused copy writes the keyframe's old row and pose back."""
    cam_ids, is_fixed, used = _gather_problem(m, kf_id, n_local, n_fixed)

    poses0 = m.kf_pose_cw[cam_ids]
    uv = m.kf_xy[cam_ids]
    ur = torch.where(used[:, None], m.kf_ur[cam_ids], -1.0)
    lvl = m.kf_level[cam_ids]
    pid_raw = m.kf_point[cam_ids]
    obs_ok = (pid_raw >= 0) & m.kf_kp_valid[cam_ids] & used[:, None]
    pid = torch.where(obs_ok, pid_raw, 0).long()
    obs_ok = obs_ok & m.pt_valid[pid]
    inv_s2 = inv_sigma2_lut[torch.clamp(lvl, 0, inv_sigma2_lut.shape[0] - 1).long()]

    P = m.pt_capacity
    pt_cap = min(pt_cap, P)
    obs_cnt = ms.scatter_add(P, pid, obs_ok.to(torch.int32))
    _, sel = topk_stable(obs_cnt, pt_cap)
    sel_in = obs_cnt[sel] > 0
    g2l = torch.full((P,), pt_cap, dtype=torch.int64, device=pid.device)
    g2l[sel] = torch.arange(pt_cap, device=pid.device)
    pid_l = g2l[pid]
    obs_ok_l = obs_ok & (pid_l < pt_cap)
    pid_l = torch.where(obs_ok_l, pid_l, 0)

    poses, pts_l, obs_mask, pt_in_l = schur_ba_core(
        poses0, m.pt_pos[sel], uv, ur, inv_s2, pid_l, obs_ok_l, is_fixed, used, cam,
        phase_iters,
    )

    rows = m.kf_point[cam_ids]
    new_rows = torch.where(obs_ok_l & ~obs_mask, ms.NO_POINT, rows)
    kf_point = ms.scatter_last(m.kf_point, cam_ids, torch.where(used[:, None], new_rows, rows))
    kf_pose = ms.scatter_last(
        m.kf_pose_cw, cam_ids,
        torch.where(used[:, None, None], orthonormalize_se3(poses), poses0),
    )
    pt_pos = m.pt_pos.clone()
    pt_pos[sel] = torch.where((pt_in_l & sel_in)[:, None], pts_l, m.pt_pos[sel])
    return m._replace(kf_pose_cw=kf_pose, kf_point=kf_point, pt_pos=pt_pos)
