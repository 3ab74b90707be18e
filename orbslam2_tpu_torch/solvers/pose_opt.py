"""Motion-only bundle adjustment (pose optimization).

Port of ``orbslam2_tpu/solvers/pose_opt.py`` (``Optimizer::PoseOptimization``,
src/Optimizer.cc:≈240): 4 rounds x 10 LM iterations over all observations at
once, Huber on rounds 1-2, chi2 outlier re-flagging between rounds.  The
loops read nothing back to the host: accept/reject is a ``torch.where``.

Chi-square gates (kept verbatim): 5.991 (mono, 2-DoF), 7.815 (stereo,
3-DoF); Huber deltas are their square roots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.camera import CameraModel
from .lie import hat, se3_exp

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    """Observations of known 3-D points from one frame:
    points_w (N, 3), uv (N, 2) undistorted pixels, ur (N,) right-image u
    (< 0 where mono-only), inv_sigma2 (N,), valid (N,) bool."""

    points_w: torch.Tensor
    uv: torch.Tensor
    ur: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor      # (4, 4) optimized pose
    inlier: torch.Tensor    # (N,) final inlier mask
    n_inliers: torch.Tensor
    chi2: torch.Tensor      # (N,) final per-obs chi2


def _residual_jacobian(T_cw: torch.Tensor, obs: PoseObs, cam: CameraModel):
    """Residual (N, 3) and Jacobian (N, 3, 6) w.r.t. a left-multiplied se3
    increment [rho, phi]; the third row is the stereo u_r residual."""
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    pc = obs.points_w @ R.T + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    zi2 = zi * zi

    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    ur = u - cam.bf * zi
    r = torch.stack([u - obs.uv[:, 0], v - obs.uv[:, 1], ur - obs.ur], dim=-1)

    zeros = torch.zeros_like(x)
    J_proj = torch.stack(
        [
            torch.stack([cam.fx * zi, zeros, -cam.fx * x * zi2], -1),
            torch.stack([zeros, cam.fy * zi, -cam.fy * y * zi2], -1),
            torch.stack([cam.fx * zi, zeros, (-cam.fx * x + cam.bf) * zi2], -1),
        ],
        dim=-2,
    )
    I3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    J_pt = torch.cat([I3, -hat(pc)], dim=-1)
    J = J_proj @ J_pt
    return r, J, z <= 1e-6


def reprojection_chi2(T_cw: torch.Tensor, obs: PoseObs, cam: CameraModel):
    """Per-observation chi2 (2-DoF mono, 3-DoF stereo; 1e9 behind the
    camera) and the stereo mask."""
    r, _, behind = _residual_jacobian(T_cw, obs, cam)
    has_ur = obs.ur >= 0.0
    r = torch.cat([r[:, :2], torch.where(has_ur, r[:, 2], 0.0)[:, None]], dim=1)
    chi2 = (r * r).sum(-1) * obs.inv_sigma2
    chi2 = torch.where(behind, torch.full_like(chi2, 1e9), chi2)
    return chi2, has_ur


def pose_optimization(
    T_cw_init: torch.Tensor,
    obs: PoseObs,
    cam: CameraModel,
    rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """The 4x10 LM schedule with chi2 re-flagging between rounds."""
    has_ur = obs.ur >= 0.0
    chi2_th = torch.where(has_ur, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    delta_h = torch.sqrt(chi2_th)
    eye6 = torch.eye(6, dtype=torch.float32, device=T_cw_init.device)

    def masked(r, J):
        r = torch.cat([r[:, :2], torch.where(has_ur, r[:, 2], 0.0)[:, None]], dim=1)
        if J is not None:
            J = torch.cat([J[:, :2], torch.where(has_ur[:, None], J[:, 2], 0.0)[:, None]], dim=1)
        return r, J

    T = T_cw_init
    inlier = obs.valid
    for k in range(rounds):
        robust = k < 2  # rounds 1-2 Huber, 3-4 plain (the reference's schedule)
        lam = torch.tensor(1e-3, dtype=torch.float32, device=T.device)
        for _ in range(iters_per_round):
            r, J, behind = _residual_jacobian(T, obs, cam)
            r, J = masked(r, J)
            w_info = obs.inv_sigma2 * inlier.to(torch.float32) * (~behind).to(torch.float32)
            if robust:
                rn = torch.sqrt((r * r).sum(-1) * obs.inv_sigma2 + 1e-12)
                w = w_info * torch.clamp(delta_h / torch.clamp(rn, min=1e-12), max=1.0)
            else:
                w = w_info
            H = torch.einsum("nij,n,nik->jk", J, w, J)
            b = torch.einsum("nij,n,ni->j", J, w, r)
            err = (w * (r * r).sum(-1)).sum()

            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            # solve_ex: no singularity check, which would read back to the host.
            delta = -torch.linalg.solve_ex(Hd, b)[0]
            T_new = se3_exp(delta) @ T

            r2, _, _ = _residual_jacobian(T_new, obs, cam)
            r2, _ = masked(r2, None)
            if robust:
                rn2 = torch.sqrt((r2 * r2).sum(-1) * obs.inv_sigma2 + 1e-12)
                w2 = w_info * torch.clamp(delta_h / torch.clamp(rn2, min=1e-12), max=1.0)
            else:
                w2 = w_info
            err_new = (w2 * (r2 * r2).sum(-1)).sum()

            accept = err_new < err
            T = torch.where(accept, T_new, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        chi2, _ = reprojection_chi2(T, obs, cam)
        inlier = obs.valid & (chi2 <= chi2_th)

    chi2, _ = reprojection_chi2(T, obs, cam)
    return PoseOptResult(T_cw=T, inlier=inlier, n_inliers=inlier.sum(), chi2=chi2)
