"""Two-view geometry: the triangulation that local mapping uses.

Port of ``orbslam2_tpu/ops/twoview.py::triangulate_linear``
(``Initializer::Triangulate``, src/Initializer.cc:≈210).  Mono two-view
initialization (H/F scoring, decompositions, CheckRT) is not ported yet.
"""

from __future__ import annotations

import torch

from ..solvers.lie import inv3x3


def _eye3(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def triangulate_linear(
    P1: torch.Tensor, P2: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor,
    gn_iters: int = 2,
) -> torch.Tensor:
    """Linear triangulation + Gauss-Newton reprojection polish.
    P*: (3, 4); xy*: (N, 2) -> (N, 3).

    Seed: with A = [A3 | a4] the four DLT rows, solve A3^T A3 X = -A3^T a4
    by the closed-form 3x3 inverse; then ``gn_iters`` Gauss-Newton steps on
    the reprojection error in both views, a step being skipped where it is
    not finite or longer than 1e3."""
    A = torch.stack(
        [
            xy1[:, 0, None] * P1[2] - P1[0],
            xy1[:, 1, None] * P1[2] - P1[1],
            xy2[:, 0, None] * P2[2] - P2[0],
            xy2[:, 1, None] * P2[2] - P2[1],
        ],
        dim=-2,
    )  # (N, 4, 4)
    A3, a4 = A[..., :3], A[..., 3]
    H = torch.einsum("nri,nrj->nij", A3, A3)
    g = torch.einsum("nri,nr->ni", A3, a4)
    X = -torch.einsum("nij,nj->ni", inv3x3(H + 1e-9 * _eye3(H)), g)

    def residual_jac(Pm, X, xy):
        Xh = torch.cat([X, torch.ones_like(X[:, :1])], -1)
        p = Xh @ Pm.T
        w = torch.where(p[:, 2].abs() < 1e-9, torch.full_like(p[:, 2], 1e-9), p[:, 2])
        uv = p[:, :2] / w[:, None]
        # d(uv)/dX = (P[:2, :3] - uv P[2, :3]) / w
        J = (Pm[None, :2, :3] - uv[..., None] * Pm[None, 2:3, :3]) / w[:, None, None]
        return uv - xy, J

    for _ in range(gn_iters):
        r1, J1 = residual_jac(P1, X, xy1)
        r2, J2 = residual_jac(P2, X, xy2)
        Hn = torch.einsum("nri,nrj->nij", J1, J1) + torch.einsum("nri,nrj->nij", J2, J2)
        gn = torch.einsum("nri,nr->ni", J1, r1) + torch.einsum("nri,nr->ni", J2, r2)
        dX = -torch.einsum("nij,nj->ni", inv3x3(Hn + 1e-6 * _eye3(Hn)), gn)
        ok = torch.isfinite(dX).all(-1) & (torch.linalg.norm(dX, dim=-1) < 1e3)
        X = torch.where(ok[:, None], X + dX, X)
    return X
