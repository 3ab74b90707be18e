"""Perspective-n-Point RANSAC for relocalization.

Port of ``orbslam2_tpu/ops/pnp.py`` (the role of the reference's
``PnPsolver``, src/PnPsolver.cc): every hypothesis of a RANSAC run is one
row of a batch.  ``p3p_ransac`` (Grunert P3P on three points, the fourth
picks among the quartic's roots) is the relocalization's solver;
``pnp_ransac`` is the 6-point DLT variant.  Both score each hypothesis by
reprojection chi2 (PnPsolver::CheckInliers) and return the hypothesis with
the most inliers (the first on ties); the caller polishes it with the
pose optimizer.

RANSAC samples: torch cannot reproduce ``jax.random.choice``, so both
functions take the (iters, 4) or (iters, 6) sample indices as ``samples``;
without them they draw from a ``torch.Generator`` on the inputs' device
(``draw_samples``: uniform over the valid correspondences, with
replacement).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..solvers.lie import rt_to_mat
from ..utils.camera import CameraModel
from .sim3_solve import horn_sim3


class PnPResult(NamedTuple):
    T_cw: torch.Tensor       # (4, 4)
    inliers: torch.Tensor    # (M,) bool
    n_inliers: torch.Tensor  # 0-d int
    ok: torch.Tensor         # 0-d bool


def draw_samples(valid: torch.Tensor, iters: int, k: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(iters, k) int64 indices of ``valid`` entries drawn uniformly with
    replacement (the counterpart of ``jax.random.choice(..., p=valid /
    sum)``), on ``valid``'s device and without a host read.  Each draw is an
    integer rank r < n_valid mapped to the (r+1)-th valid index.  With no
    valid entry every index is 0, where the reference samples index 0 too
    and its result is ``ok=False``."""
    M = valid.shape[0]
    cdf = torch.cumsum(valid.to(torch.int32), 0)
    total = cdf[-1]
    u = torch.rand((iters, k), generator=generator, device=valid.device)
    rank = torch.minimum((u * total).to(torch.int32), torch.clamp(total - 1, min=0))
    idx = torch.searchsorted(cdf, rank, right=True)
    return torch.where(total > 0, idx.clamp(max=M - 1), 0)


def _normalized(uv: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    return torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1)


def _score(Ts, uv, points_w, valid, inv_sigma2, cam, chi2_th):
    """Inlier masks (I, M) and counts (I,) of hypotheses Ts (I, 4, 4)."""
    pc = points_w[None] @ Ts[:, :3, :3].transpose(-1, -2) + Ts[:, None, :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
    inl = valid & (chi2 < chi2_th) & (pc[..., 2] > 0.01)
    return inl, inl.sum(-1)


def _best(Ts, inls, n_in, min_inliers) -> PnPResult:
    best = torch.argmax(n_in)  # the first maximum, as jnp.argmax
    return PnPResult(T_cw=Ts[best], inliers=inls[best], n_inliers=n_in[best],
                     ok=n_in[best] >= min_inliers)


def _dlt_pose(xn: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """6+ point DLT, batched: normalized image coords (..., M, 2) + world
    points (..., M, 3) -> T_cw (..., 4, 4), the rotation re-orthogonalized
    by SVD (Procrustes)."""
    u, v = xn[..., 0:1], xn[..., 1:2]
    Xh = torch.cat([X, torch.ones_like(u)], -1)  # (..., M, 4)
    z4 = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z4, -u * Xh], -1)  # (..., M, 12)
    r2 = torch.cat([z4, Xh, -v * Xh], -1)
    A = torch.cat([r1, r2], -2)  # (..., 2M, 12)
    # A non-finite sample cannot be decomposed (the reference's SVD returns
    # NaN): it gets zeros, and its hypothesis scores no inlier.
    A = torch.where(torch.isfinite(A).all(-1).all(-1)[..., None, None], A, 0.0)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    Pm = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 4))
    # Scale (rows of R near unit norm) and sign (points in front).
    scale = (torch.linalg.det(Pm[..., :3]).abs() + 1e-12) ** (1.0 / 3.0)
    Pm = Pm / torch.where(scale < 1e-9, 1e-9, scale)[..., None, None]
    depths = (X * Pm[..., None, 2, :3]).sum(-1) + Pm[..., 2:3, 3]
    Pm = torch.where((depths.mean(-1) < 0)[..., None, None], -Pm, Pm)
    U, _, Vt = torch.linalg.svd(Pm[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    return rt_to_mat(U @ D @ Vt, Pm[..., 3])


def _quartic_roots_dk(coeffs: torch.Tensor, iters: int = 48) -> torch.Tensor:
    """Durand-Kerner all-roots iteration for a batch of quartics:
    coeffs (..., 5) [c4, c3, c2, c1, c0] -> (..., 4) complex64 roots.  The
    starting roots (0.4 + 0.9j)^k are built in double precision and
    rounded once."""
    c4 = coeffs[..., 0:1]
    monic = coeffs / torch.where(c4.abs() < 1e-12, 1e-12, c4)
    c3, c2, c1, c0 = (monic[..., i:i + 1] for i in range(1, 5))
    start = torch.tensor([(0.4 + 0.9j) ** k for k in range(4)], dtype=torch.complex128)
    z = start.to(torch.complex64).to(coeffs.device).expand(coeffs.shape[:-1] + (4,))
    eye = torch.eye(4, dtype=torch.complex64, device=coeffs.device)
    tiny = torch.tensor(1e-12, dtype=torch.complex64, device=coeffs.device)
    for _ in range(iters):
        p = (((z + c3) * z + c2) * z + c1) * z + c0
        denom = (z[..., :, None] - z[..., None, :] + eye).prod(-1)
        z = z - p / torch.where(denom.abs() < 1e-12, tiny, denom)
    return z


_NODES = (-2.0, -1.0, 0.0, 1.0, 2.0)


def _p3p_poses(xn: torch.Tensor, X: torch.Tensor):
    """Grunert P3P, batched: normalized image coords (..., 4, 2) + world
    points (..., 4, 3).  Points 0-2 form the triangle; point 3 picks among
    the up to 4 solutions.  The quartic in v = s3 / s1 is evaluated at 5
    nodes and its coefficients recovered by a 5x5 Vandermonde solve.

    Returns (Ts (..., 4, 4, 4), valid (..., 4), err3 (..., 4): the 4th
    point's reprojection error under each solution)."""
    f = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)  # bearings
    j1, j2, j3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(-1)[..., None]
    b2 = ((P1 - P3) ** 2).sum(-1)[..., None]
    c2 = ((P1 - P2) ** 2).sum(-1)[..., None]
    cos_a = (j2 * j3).sum(-1)[..., None]
    cos_b = (j1 * j3).sum(-1)[..., None]
    cos_g = (j1 * j2).sum(-1)[..., None]
    b2s = torch.clamp(b2, min=1e-12)
    q = (a2 - c2) / b2s
    r_c = c2 / b2s

    def elim(v):
        # D(v) u = N(v) eliminates u; g(v) = D^2 + N^2 - 2 N D cos_g
        # - r(v) D^2 = 0 is Grunert's quartic, r(v) = (c^2/b^2)(1 + v^2 -
        # 2 v cos_b).
        D = 2.0 * (cos_g - v * cos_a)
        N = q * (1.0 + v * v - 2.0 * v * cos_b) + 1.0 - v * v
        return D, N

    nodes = torch.tensor(_NODES, device=xn.device)
    D, N = elim(nodes)
    r = r_c * (1.0 + nodes * nodes - 2.0 * nodes * cos_b)
    gv = D * D + N * N - 2.0 * N * D * cos_g - r * D * D  # (..., 5)
    # The Vandermonde matrix is factored once and its LU broadcast over the
    # batch: the same pivoted LU solve as ``jnp.linalg.solve``, without a
    # batched factorization and its error check.
    V = torch.tensor([[x ** p for p in range(4, -1, -1)] for x in _NODES], device=xn.device)
    LU, piv, _ = torch.linalg.lu_factor_ex(V)
    coeffs = torch.linalg.lu_solve(LU, piv, gv[..., None])[..., 0]  # c4..c0

    roots = _quartic_roots_dk(coeffs)
    v = roots.real
    real_ok = roots.imag.abs() < 1e-3 * (1.0 + v.abs())
    D, N = elim(v)
    u = N / torch.where(D.abs() < 1e-9, 1e-9, D)
    s1 = torch.sqrt(torch.clamp(b2 / torch.clamp(1.0 + v * v - 2.0 * v * cos_b, min=1e-12),
                                min=0.0))
    s2 = u * s1
    s3 = v * s1
    # Triangle consistency (side a) and positive depths.
    eq_a = s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * cos_a
    ok = (real_ok & (s1 > 1e-6) & (s2 > 1e-6) & (s3 > 1e-6)
          & ((eq_a - a2).abs() < 1e-2 * (1.0 + a2)))

    Xc = torch.stack([s1[..., None] * j1[..., None, :],
                      (u * s1)[..., None] * j2[..., None, :],
                      (v * s1)[..., None] * j3[..., None, :]], -2)  # (..., 4, 3, 3)
    R, t, _ = horn_sim3(Xc, X[..., None, :3, :].expand(Xc.shape), fix_scale=True)
    Ts = rt_to_mat(R, t)
    pc = (R @ X[..., None, 3, :, None])[..., 0] + t
    z = torch.clamp(pc[..., 2], min=1e-6)
    err3 = ((pc[..., :2] / z[..., None] - xn[..., None, 3, :]) ** 2).sum(-1)
    err3 = torch.where(ok & (pc[..., 2] > 0), err3, 1e12)
    return Ts, ok, err3


def p3p_ransac(
    uv: torch.Tensor,
    points_w: torch.Tensor,
    valid: torch.Tensor,
    inv_sigma2: torch.Tensor,
    cam: CameraModel,
    generator: Optional[torch.Generator] = None,
    iters: int = 1024,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    samples: Optional[torch.Tensor] = None,
) -> PnPResult:
    """Batched P3P+1 RANSAC (PnPsolver::iterate's shape with a planar-safe
    minimal solver): uv (M, 2) undistorted pixels, points_w (M, 3), valid
    (M,), inv_sigma2 (M,).  ``samples`` (iters, 4) replaces the draw."""
    if samples is None:
        samples = draw_samples(valid, iters, 4, generator)
    samples = samples.long()
    xn = _normalized(uv, cam)
    Ts, sol_ok, err3 = _p3p_poses(xn[samples], points_w[samples])
    best_sol = torch.argmin(err3, dim=1)  # the first minimum, as jnp.argmin
    rows = torch.arange(samples.shape[0], device=uv.device)
    Ts = Ts[rows, best_sol]
    inls, n_in = _score(Ts, uv, points_w, valid, inv_sigma2, cam, chi2_th)
    n_in = torch.where(sol_ok[rows, best_sol], n_in, 0)
    return _best(Ts, inls, n_in, min_inliers)


def pnp_ransac(
    uv: torch.Tensor,
    points_w: torch.Tensor,
    valid: torch.Tensor,
    inv_sigma2: torch.Tensor,
    cam: CameraModel,
    generator: Optional[torch.Generator] = None,
    iters: int = 256,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    samples: Optional[torch.Tensor] = None,
) -> PnPResult:
    """Batched 6-point DLT RANSAC (PnPsolver::iterate, ≈170).
    ``samples`` (iters, 6) replaces the draw."""
    if samples is None:
        samples = draw_samples(valid, iters, 6, generator)
    samples = samples.long()
    Ts = _dlt_pose(_normalized(uv, cam)[samples], points_w[samples])
    inls, n_in = _score(Ts, uv, points_w, valid, inv_sigma2, cam, chi2_th)
    return _best(Ts, inls, n_in, min_inliers)
