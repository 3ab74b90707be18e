"""Sim3 refinement between two keyframes (loop-closure alignment).

Port of ``orbslam2_tpu/solvers/sim3_opt.py`` (``Optimizer::OptimizeSim3``,
src/Optimizer.cc:≈1080): one Sim3 vertex, bidirectional projection
residuals (EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ), Huber, the
reference's 5 iterations -> cut chi2 > 10 -> 10 more schedule.

Jacobians come from forward-mode differentiation on the 7-dim tangent
(``lie.jacfwd_batched``, the reference's ``jax.jacfwd``); the 7x7 step is
``torch.linalg.solve_ex``, and the accept test and the damping stay on the
device, so nothing is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.camera import CameraModel
from .lie import jacfwd_batched, sim3_apply, sim3_exp, sim3_inverse_mat

CHI2_TH = 10.0  # the reference's th2 for OptimizeSim3


def _project(cam: CameraModel, p: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1)


def scale_keep(fix_scale: bool, device) -> torch.Tensor:
    """(7,) factors that freeze the scale component of a sim(3) tangent
    when ``fix_scale`` (the reference's ``xi.at[6].multiply(1 - fix)``)."""
    keep = torch.ones(7, dtype=torch.float32, device=device)
    if fix_scale:
        keep[6] = 0.0
    return keep


def lm_solve7(J: torch.Tensor, r: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """-(J^T J + lam I)^-1 J^T r for one 7-dim vertex."""
    H = J.T @ J + lam * torch.eye(7, dtype=J.dtype, device=J.device)
    return -torch.linalg.solve_ex(H, (J.T @ r)[:, None])[0][:, 0]


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor       # packed 4x4 (sR | t)
    inliers: torch.Tensor   # (M,) bool
    n_inliers: torch.Tensor  # 0-d int


def optimize_sim3(
    S12_init: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraModel,
    fix_scale: bool = False,
    phases: Tuple[int, int] = (5, 10),
) -> Sim3OptResult:
    """Refine S12 (camera1 <- camera2, packed sR|t).  p1/p2: (M, 3) matched
    points in each camera frame; uv1/uv2: their observed keypoints in each
    image."""
    dev = p1.device
    keep = scale_keep(fix_scale, dev)
    zero7 = torch.zeros(7, dtype=torch.float32, device=dev)

    def residuals(xi, base_S12):
        # xi (..., 7) -> residuals (..., M, 2) in image 1 and image 2.
        S = (sim3_exp(xi * keep) @ base_S12)[..., None, :, :]
        r1 = _project(cam, sim3_apply(S, p2)) - uv1
        r2 = _project(cam, sim3_apply(sim3_inverse_mat(S), p1)) - uv2
        return r1, r2

    def chi2_of(S):
        r1, r2 = residuals(zero7, S)
        return (r1 * r1).sum(-1) * inv_sigma2_1, (r2 * r2).sum(-1) * inv_sigma2_2

    def gn_iters(S, mask, n_iters, robust):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        w1 = torch.sqrt(inv_sigma2_1 * mask)
        w2 = torch.sqrt(inv_sigma2_2 * mask)

        def err_at(Sx):
            r1, r2 = residuals(zero7, Sx)
            return ((r1 * r1).sum(-1) * inv_sigma2_1 * mask
                    + (r2 * r2).sum(-1) * inv_sigma2_2 * mask).sum()

        for _ in range(n_iters):
            def flat_res(xi):
                r1, r2 = residuals(xi, S)
                r = torch.cat([r1 * w1[:, None], r2 * w2[:, None]], -2)
                return r.reshape(r.shape[:-2] + (-1,))

            r0, J = jacfwd_batched(flat_res, (zero7,), 0)  # (4M,), (4M, 7)
            if robust:
                # Huber IRLS on per-point residual norms.
                rn = torch.sqrt((r0.view(-1, 2) ** 2).sum(-1) + 1e-12)
                wh = torch.sqrt(torch.clamp(CHI2_TH ** 0.5 / torch.clamp(rn, min=1e-12),
                                            max=1.0))
                r0 = (r0.view(-1, 2) * wh[:, None]).reshape(-1)
                J = (J.view(-1, 2, 7) * wh[:, None, None]).reshape(-1, 7)
            dx = lm_solve7(J, r0, lam)
            S_new = sim3_exp(dx * keep) @ S
            accept = err_at(S_new) < err_at(S)
            S = torch.where(accept, S_new, S)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e3)
        return S

    mask = valid.to(torch.float32)
    S = gn_iters(S12_init, mask, phases[0], robust=True)
    c1, c2 = chi2_of(S)
    inlier = valid & (c1 < CHI2_TH) & (c2 < CHI2_TH)
    S = gn_iters(S, inlier.to(torch.float32), phases[1], robust=False)
    c1, c2 = chi2_of(S)
    inlier = valid & (c1 < CHI2_TH) & (c2 < CHI2_TH)
    return Sim3OptResult(S12=S, inliers=inlier, n_inliers=inlier.sum())
