"""Closed-form absolute orientation (Horn 1987) and the Sim(3) RANSAC.

Port of ``orbslam2_tpu/ops/sim3_solve.py`` (``Sim3Solver``,
src/Sim3Solver.cc).  P3P relocalization calls ``horn_sim3`` to align each
minimal triangle; loop closing calls ``sim3_ransac``, every hypothesis one
row of a batch.  Batched over leading dimensions.

The quaternion is the eigenvector of a symmetric 4x4 matrix's largest
eigenvalue.  The reference takes it from ``eigh``; here Jacobi
rotations (``top_eigenvector_sym4``) find it with a fixed count of
elementwise steps and batched 4x4 products, the same on the CPU and the
card: cuSOLVER's batched ``syev`` refused the relocalization's batches of
8192 matrices on an H100 (``CUSOLVER_STATUS_INVALID_VALUE`` from
``cusolverDnXsyevBatched_bufferSize``), and every ``eigh`` call reads its
status back to the host.  A non-finite matrix gives a NaN vector and no
error, as the reference's ``eigh`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.camera import CameraModel


# The six off-diagonal pairs in three rounds of two disjoint pairs (the
# parallel ordering): both rotations of a round go into one J.
_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))


def top_eigenvector_sym4(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of symmetric (..., 4, 4)
    matrices (the first on ties): ``sweeps`` Jacobi sweeps, each zeroing
    the six off-diagonal pairs in three rounds of two disjoint pairs, with
    the rotation of Numerical Recipes (11.1.8-11.1.10), A <- J^T A J and
    V <- V J.  The off-diagonal mass falls quadratically; 8 sweeps reach
    float32's last bit on 4x4 matrices.  A round is one gather, ~16
    elementwise operations on both pairs at once, one ``stack`` for J and
    three batched products."""
    V = torch.eye(4, dtype=A.dtype, device=A.device).expand(A.shape)
    zeros = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    # Per round, the flat positions of (pp, pp', qq, qq', pq, p'q').
    flat_idx = torch.tensor([[5 * p1, 5 * p2, 5 * q1, 5 * q2, 4 * p1 + q1, 4 * p2 + q2]
                           for (p1, q1), (p2, q2) in _ROUNDS], device=A.device)
    for _ in range(sweeps):
        for r, ((p1, q1), (p2, q2)) in enumerate(_ROUNDS):
            g = A.flatten(-2).index_select(-1, flat_idx[r])
            app, aqq, apq = g[..., 0:2], g[..., 2:4], g[..., 4:6]
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            t = torch.copysign(1.0 / (theta.abs() + torch.hypot(theta, torch.ones_like(theta))),
                               theta)
            t = torch.where(zero, 0.0, t)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            cs = torch.stack([c, s, -s], -1).unbind(-1)
            entries = [[zeros] * 4 for _ in range(4)]
            for i, (p, q) in enumerate(((p1, q1), (p2, q2))):
                ci, si, ni = cs[0][..., i], cs[1][..., i], cs[2][..., i]
                entries[p][p], entries[q][q], entries[p][q], entries[q][p] = ci, ci, si, ni
            J = torch.stack([e for row in entries for e in row], -1).unflatten(-1, (4, 4))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    best = torch.argmax(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    return V.gather(-1, best[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def horn_sim3(
    p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Similarity from paired points (..., M, 3) x (..., M, 3): returns
    (R12 (..., 3, 3), t12 (..., 3), s12 (...,)) with p1 ~ s R p2 + t
    (camera-1 <- camera-2).  The quaternion's sign does not matter (R is
    quadratic in it)."""
    c1 = p1.mean(-2)
    c2 = p2.mean(-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = q1.transpose(-1, -2) @ q2  # (..., 3, 3)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = top_eigenvector_sym4(N)  # quaternion (w, x, y, z)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # With M = q1^T q2 the quaternion maps p1 -> p2; the transpose maps
    # p2 -> p1.
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2).transpose(-1, -2)
    if fix_scale:
        s = torch.ones_like(w)
    else:
        rot_q2 = q2 @ R.transpose(-1, -2)
        s = (q1 * rot_q2).sum((-2, -1)) / torch.clamp((rot_q2 * rot_q2).sum((-2, -1)), min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return R, t, s


class Sim3Result(NamedTuple):
    R12: torch.Tensor      # (3, 3)
    t12: torch.Tensor      # (3,)
    s12: torch.Tensor      # 0-d
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor  # 0-d int
    ok: torch.Tensor       # 0-d bool


def sim3_ransac(
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    max_err1: torch.Tensor,
    max_err2: torch.Tensor,
    cam: CameraModel,
    samples: Optional[torch.Tensor] = None,
    iters: int = 128,
    fix_scale: bool = False,
    min_inliers: int = 20,
    generator: Optional[torch.Generator] = None,
) -> Sim3Result:
    """RANSAC Horn alignment of matched points p1/p2 (M, 3), in camera-1
    and camera-2 frames; ``max_err*`` (M,) are squared-pixel thresholds
    (9.21 / 7.78 x sigma2 of the octave, the reference's values).

    ``samples`` (iters, 3) are the minimal samples' indices; without them
    they are drawn uniformly over the valid pairs from ``generator``
    (``ops/pnp.draw_samples``).  Each hypothesis projects each cloud into
    the other camera; the one with the most inliers wins (the first on
    ties, as ``jnp.argmax``)."""
    if samples is None:
        from .pnp import draw_samples

        samples = draw_samples(valid, iters, 3, generator)
    Rs, ts, ss = horn_sim3(p1[samples], p2[samples], fix_scale)  # (I, ...)

    def project(p):
        z = torch.clamp(p[..., 2], min=1e-6)
        return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1)

    uv1_obs = project(p1)
    uv2_obs = project(p2)
    p2_in_1 = ss[:, None, None] * (p2[None] @ Rs.transpose(-1, -2)) + ts[:, None, :]
    sinv = 1.0 / torch.clamp(ss, min=1e-9)
    p1_in_2 = sinv[:, None, None] * ((p1[None] - ts[:, None, :]) @ Rs)
    e1 = ((project(p2_in_1) - uv1_obs) ** 2).sum(-1)
    e2 = ((project(p1_in_2) - uv2_obs) ** 2).sum(-1)
    inls = valid & (e1 < max_err1) & (e2 < max_err2)
    n_in = inls.sum(-1)
    best = torch.argmax(n_in)
    return Sim3Result(R12=Rs[best], t12=ts[best], s12=ss[best], inliers=inls[best],
                      n_inliers=n_in[best], ok=n_in[best] >= min_inliers)
