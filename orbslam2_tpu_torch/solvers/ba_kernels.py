"""K4 and K5: reprojection residuals and normal-equation blocks of one
bundle-adjustment LM step.

Port of ``orbslam2_tpu/solvers/ba_kernels.py``.  ``ba_normal_equations``
(K4) and ``ba_chi2`` (K5) launch the CUDA kernels of ``csrc/ba_kernels.cu``
for CUDA tensors and take ``_ba_normal_equations_plain`` /
``_ba_chi2_plain`` for CPU tensors.  The layout is the reference's: X and uv
N-minor, (C, 3, N) and (C, 2, N), and the packed per-observation output
(C, 32, N) with rows

  0-5    H_pp upper triangle (00, 01, 02, 11, 12, 22)
  6-8    b_p
  9-26   G (6x3 row-major)
  27     chi2 (1e9 where the point is behind the camera)
  28     the weight used
  29-31  zero

Convention (``local_ba._residuals``): residual = predicted - observed,
camera Jacobian J_proj [I3 | -hat(pc)] (translation first), point Jacobian
J_proj R.  The intrinsics are the camera model's floats.
"""

from __future__ import annotations

import torch

from ..utils.camera import CameraModel

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
N_OBS_ROWS = 32


def _intrinsics(cam: CameraModel):
    return (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)


def _project(poses, X, uv, ur, inv_s2, cam: CameraModel):
    """The shared prologue over (C, N): camera-frame point, residual rows,
    chi2 and its sentinel."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]

    def row(i):
        return (R[:, i, 0, None] * X[:, 0] + R[:, i, 1, None] * X[:, 1]
                + R[:, i, 2, None] * X[:, 2] + t[:, i, None])

    x, y, z = row(0), row(1), row(2)
    behind = z <= 1e-6
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    has_ur = ur >= 0.0
    ru = u - uv[:, 0]
    rv = v - uv[:, 1]
    rw = torch.where(has_ur, (u - cam.bf * zi) - ur, 0.0)
    chi2 = (ru * ru + rv * rv + rw * rw) * inv_s2
    chi2_out = torch.where(behind, torch.full_like(chi2, 1e9), chi2)
    return R, x, y, z, zi, behind, has_ur, ru, rv, rw, chi2, chi2_out


def _ba_normal_equations_plain(poses, X, uv, ur, inv_s2, mask, cam: CameraModel,
                               robust: bool):
    R, x, y, z, zi, behind, has_ur, ru, rv, rw, chi2, chi2_out = _project(
        poses, X, uv, ur, inv_s2, cam)
    m = mask.to(torch.float32)
    zi2 = zi * zi
    w = inv_s2 * m * (~behind).to(torch.float32)
    if robust:
        delta = torch.sqrt(torch.where(has_ur, CHI2_STEREO, CHI2_MONO).to(torch.float32))
        rn = torch.sqrt(chi2 + 1e-12)
        w = w * torch.clamp(delta / torch.clamp(rn, min=1e-12), max=1.0)

    fx, fy, bf = cam.fx, cam.fy, cam.bf
    a0 = fx * zi
    a2 = -fx * x * zi2
    b1 = fy * zi
    b2 = -fy * y * zi2
    hw = has_ur.to(torch.float32)
    c0 = a0 * hw
    c2 = (-fx * x + bf) * zi2 * hw
    zero = torch.zeros_like(x)
    Ju = (a0, zero, a2, a2 * y, a0 * z - a2 * x, -a0 * y)
    Jv = (zero, b1, b2, -b1 * z + b2 * y, -b2 * x, b1 * x)
    Jw = (c0, zero, c2, c2 * y, c0 * z - c2 * x, -c0 * y)

    def rr(i, k):
        return R[:, i, k, None]

    Pu = [a0 * rr(0, k) + a2 * rr(2, k) for k in range(3)]
    Pv = [b1 * rr(1, k) + b2 * rr(2, k) for k in range(3)]
    Pw = [c0 * rr(0, k) + c2 * rr(2, k) for k in range(3)]

    rows = [w * (Pu[i] * Pu[j] + Pv[i] * Pv[j] + Pw[i] * Pw[j])
            for i in range(3) for j in range(i, 3)]
    rows += [w * (Pu[i] * ru + Pv[i] * rv + Pw[i] * rw) for i in range(3)]
    rows += [w * (Ju[i] * Pu[j] + Jv[i] * Pv[j] + Jw[i] * Pw[j])
             for i in range(6) for j in range(3)]
    rows += [chi2_out, w] + [zero] * (N_OBS_ROWS - 29)
    pack = torch.stack(rows, dim=1)

    C = X.shape[0]
    H = torch.empty((C, 6, 6), dtype=torch.float32, device=X.device)
    for i in range(6):
        for j in range(i, 6):
            H[:, i, j] = H[:, j, i] = (w * (Ju[i] * Ju[j] + Jv[i] * Jv[j] + Jw[i] * Jw[j])).sum(-1)
    b = torch.stack([(w * (Ju[i] * ru + Jv[i] * rv + Jw[i] * rw)).sum(-1) for i in range(6)], -1)
    return H, b, pack, (m * chi2_out).sum(-1)


def _ba_chi2_plain(poses, X, uv, ur, inv_s2, mask, cam: CameraModel):
    chi2_out = _project(poses, X, uv, ur, inv_s2, cam)[-1]
    return chi2_out, (mask.to(torch.float32) * chi2_out).sum(-1)


def ba_normal_equations(poses, X, uv, ur, inv_s2, mask, cam: CameraModel, robust: bool,
                        split=None):
    """Returns (H_cc (C, 6, 6), b_c (C, 6), pack (C, 32, N), chi2_sum (C,)).
    The chi2 sum is over ``mask`` and includes the 1e9 sentinels.  Each
    camera's row comes from that camera alone; on the card its sums run
    over ``split`` blocks (default ``kernels.ba_split(C, N)``), so a block
    of the cameras given the whole problem's split has the whole problem's
    bits."""
    if X.device.type == "cpu":
        return _ba_normal_equations_plain(poses, X, uv, ur, inv_s2, mask, cam, robust)
    from ..kernels import ba_normal_equations_cuda

    return ba_normal_equations_cuda(
        poses.contiguous(), X.contiguous(), uv.contiguous(), ur.contiguous(),
        inv_s2.contiguous(), mask.contiguous(), _intrinsics(cam), robust, split=split,
    )


def ba_chi2(poses, X, uv, ur, inv_s2, mask, cam: CameraModel, split=None):
    """Returns (chi2 (C, N) with the 1e9 sentinels, chi2_sum (C,)): the
    objective of ``ba_normal_equations`` without the blocks (``split`` as
    there)."""
    if X.device.type == "cpu":
        return _ba_chi2_plain(poses, X, uv, ur, inv_s2, mask, cam)
    from ..kernels import ba_chi2_cuda

    return ba_chi2_cuda(
        poses.contiguous(), X.contiguous(), uv.contiguous(), ur.contiguous(),
        inv_s2.contiguous(), mask.contiguous(), _intrinsics(cam), split=split,
    )
