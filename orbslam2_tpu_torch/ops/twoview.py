"""Two-view geometry: triangulation, and the monocular map bootstrap.

Port of ``orbslam2_tpu/ops/twoview.py`` (``Initializer``,
src/Initializer.cc): ``triangulate_linear`` (which local mapping uses too),
the normalized 8-point fundamental and DLT homography, their symmetric
scores, CheckRT, the E and H motion decompositions and
``initialize_two_view``, which scores every F and H hypothesis of the
RANSAC as one batch, picks the model by RH = SH / (SH + SF) > 0.40 and
verifies the 4 + 8 candidate motions by a batched CheckRT.

The reference takes its null vectors and decompositions from SVDs.  Here
every SVD is the eigen-decomposition of a symmetric Gram matrix by cyclic
Jacobi rotations in float64 (``jacobi_eigh``): a fixed number of batched
elementwise steps and products, with no status read back to the host, so
``initialize_two_view`` makes no host read on a card (cuSOLVER's batched
factorizations read their status, and ``torch.linalg.svd`` checks for
convergence failure).  Singular vectors carry arbitrary signs in either
package: the scores are sign-free and the candidate motions form the same
set, possibly in another order.  ``_score_h`` inverts H in closed form
(``solvers/lie.inv3x3``), since ``torch.linalg.inv`` checks for singular
matrices.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..solvers.lie import det3x3, inv3x3

CHI2_F = 3.841
CHI2_H = 5.991
SCORE_TH = 5.991
# Jacobi sweeps: the off-diagonal mass falls quadratically once small; on
# Gram matrices of random 8x9 systems the eigen-residual is 6e-7 after 5
# sweeps and 6e-14 (float64's last bits) after 6; two more for margin.
SWEEPS_9 = 8
SWEEPS_3 = 6


def _eye3(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Symmetric eigen-decomposition by Jacobi rotations
# ---------------------------------------------------------------------------


def _rounds(n: int):
    """The round-robin schedule of the n (n-1) / 2 index pairs: rounds of
    disjoint pairs (the circle method on an even count, pairs with the
    padding index dropped), as flat positions (pp, qq, pq, qp) per round."""
    m = n + (n % 2)
    idx = list(range(m))
    out = []
    for _ in range(m - 1):
        pairs = [(min(idx[i], idx[m - 1 - i]), max(idx[i], idx[m - 1 - i]))
                 for i in range(m // 2)]
        pairs = [(p, q) for p, q in pairs if q < n]
        P = [p for p, _ in pairs]
        Q = [q for _, q in pairs]
        out.append(([p * n + p for p in P], [q * n + q for q in Q],
                    [p * n + q for p, q in zip(P, Q)], [q * n + p for p, q in zip(P, Q)]))
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return out


@functools.lru_cache(maxsize=None)
def _schedule(n: int, device: torch.device):
    """``_rounds(n)`` as index tensors on ``device``, made once per device
    (so that a call on a card copies nothing to it): per round the diagonal
    positions (pp then qq), the pq positions, and the positions J's four
    rotation entries go to."""
    return tuple((torch.tensor(pp + qq, device=device), torch.tensor(pq, device=device),
                  torch.tensor(pp + qq + pq + qp, device=device))
                 for pp, qq, pq, qp in _rounds(n))


def prepare(device) -> None:
    """Build the Jacobi index tables on ``device`` (the tracker does so
    before its first initialization attempt, so that the solve itself
    copies nothing to the card)."""
    device = torch.empty(0, device=device).device  # with its index, as a tensor's
    for n in (9, 3):
        _schedule(n, device)


def jacobi_eigh(A: torch.Tensor, sweeps: int):
    """Eigenvalues (..., n) and eigenvectors (..., n, n), as columns, of
    symmetric (..., n, n) matrices: ``sweeps`` cyclic Jacobi sweeps, each a
    round-robin of rounds that rotate disjoint index pairs at once with the
    rotation of Numerical Recipes (11.1.8-11.1.10), A <- J^T A J and
    V <- V J.  Unsorted: eigenvalue i is A's diagonal entry i at the end.
    Every step is elementwise or a batched product: no host read."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.expand(batch + (n, n))
    eye_flat = eye.reshape(-1).expand(batch + (n * n,))
    for _ in range(sweeps):
        for diag_idx, pq_idx, put_idx in _schedule(n, A.device):
            flat = A.reshape(batch + (n * n,))
            k = pq_idx.shape[0]
            d = flat.index_select(-1, diag_idx)
            app, aqq = d[..., :k], d[..., k:]
            apq = flat.index_select(-1, pq_idx)
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(zero, torch.ones_like(apq), apq))
            t = torch.copysign(1.0 / (theta.abs() + torch.hypot(theta, torch.ones_like(theta))),
                               theta)
            t = torch.where(zero, torch.zeros_like(t), t)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            J = eye_flat.index_copy(-1, put_idx, torch.cat([c, c, s, -s], -1))
            J = J.reshape(batch + (n, n))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """Unit right null vector of (..., M, 9) float32 systems: the
    eigenvector of the smallest eigenvalue of A^T A (float64, Jacobi), the
    first on ties; the reference's last right singular vector up to
    sign."""
    A64 = A.double()
    lam, V = jacobi_eigh(A64.transpose(-1, -2) @ A64, SWEEPS_9)
    i = torch.argmin(lam, dim=-1)
    return V.gather(-1, i[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def _svd3(M: torch.Tensor, rank2: bool = False):
    """(U, w, V) of float64 (..., 3, 3) with M = U diag(w) V^T, w
    descending, from the Jacobi eigen-decomposition of M^T M: U's columns
    are M v_i / w_i, but with ``rank2`` the third is the cross product of
    the first two (the left null vector's direction)."""
    lam, V = jacobi_eigh(M.transpose(-1, -2) @ M, SWEEPS_3)
    lam, order = torch.sort(lam, dim=-1, descending=True, stable=True)
    V = V.gather(-1, order[..., None, :].expand(V.shape))
    w = torch.sqrt(torch.clamp(lam, min=0.0))
    U = (M @ V) / torch.clamp(w[..., None, :], min=1e-300)
    if rank2:
        u3 = torch.linalg.cross(U[..., 0], U[..., 1], dim=-1)
        U = torch.cat([U[..., :2], u3[..., None]], -1)
    return U, w, V


# ---------------------------------------------------------------------------
# Normalization (Initializer::Normalize, src/Initializer.cc:≈680)
# ---------------------------------------------------------------------------


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without reading it on the host
    (indexing with a 0-d tensor takes its value)."""
    return x.index_select(0, i.view(1))[0]


def _mat3(rows) -> torch.Tensor:
    """A (..., 3, 3) matrix from nine same-shaped tensors, row by row."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def normalize_points(xy: torch.Tensor, valid: torch.Tensor):
    """Zero-mean, unit mean-abs-dev normalization.  Returns (xn, T 3x3)."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (xy * w[:, None]).sum(0) / n
    dev = ((xy - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-8)
    xn = (xy - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = _mat3([[s[0], z, -mean[0] * s[0]], [z, s[1], -mean[1] * s[1]], [z, z, o]])
    return xn, T


# ---------------------------------------------------------------------------
# Minimal solvers (batched over leading dimensions)
# ---------------------------------------------------------------------------


def _solve_f_8pt(x1: torch.Tensor, x2: torch.Tensor,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized 8-point fundamental from (..., M, 2) + (..., M, 2) ->
    (..., 3, 3), rank 2.  With ``w`` the rows are weighted (the all-inlier
    least-squares refinement after RANSAC)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
                    -1)  # rows x2^T F x1 = 0
    if w is not None:
        A = A * w[..., None]
    F = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    # Rank 2: F - w3 u3 v3^T = F (I - v3 v3^T), v3 F's smallest right
    # singular vector.
    lam, V = jacobi_eigh(F.transpose(-1, -2) @ F, SWEEPS_3)
    i = torch.argmin(lam, dim=-1)
    v3 = V.gather(-1, i[..., None, None].expand(V.shape[:-1] + (1,)))
    return (F - (F @ v3) @ v3.transpose(-1, -2)).to(torch.float32)


def _solve_h_dlt(x1: torch.Tensor, x2: torch.Tensor,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized DLT homography from (..., M, 2) + (..., M, 2) ->
    (..., 3, 3), x2 ~ H x1."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = torch.cat([r1, r2], -2)  # (..., 2M, 9)
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3)).to(torch.float32)


# ---------------------------------------------------------------------------
# Scoring (CheckHomography / CheckFundamental, src/Initializer.cc:≈240-380),
# batched over hypotheses (..., 3, 3)
# ---------------------------------------------------------------------------


def _homogeneous(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[:, :1])], -1)


def _score_h(H: torch.Tensor, xy1, xy2, valid, sigma: float = 1.0):
    """Symmetric transfer error score; returns (score, inlier mask)."""
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(Hm, a, b):
        p = _homogeneous(a) @ Hm.transpose(-1, -2)
        den = torch.where(p[..., 2:3].abs() < 1e-12, torch.full_like(p[..., 2:3], 1e-12),
                          p[..., 2:3])
        return ((p[..., :2] / den - b) ** 2).sum(-1)

    e12 = transfer(H, xy1, xy2) * inv_s2  # chi2 of x1 -> x2
    e21 = transfer(inv3x3(H), xy2, xy1) * inv_s2
    in12, in21 = e12 < CHI2_H, e21 < CHI2_H
    zero = torch.zeros_like(e12)
    score = (torch.where(valid & in12, SCORE_TH - e12, zero)
             + torch.where(valid & in21, SCORE_TH - e21, zero)).sum(-1)
    return score, valid & in12 & in21


def _score_f(F: torch.Tensor, xy1, xy2, valid, sigma: float = 1.0):
    inv_s2 = 1.0 / (sigma * sigma)
    x1h, x2h = _homogeneous(xy1), _homogeneous(xy2)
    l2 = x1h @ F.transpose(-1, -2)  # line in image 2
    l1 = x2h @ F                    # line in image 1
    num2 = (l2 * x2h).sum(-1)
    e2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) * inv_s2
    num1 = (l1 * x1h).sum(-1)
    e1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) * inv_s2
    in2, in1 = e2 < CHI2_F, e1 < CHI2_F
    zero = torch.zeros_like(e2)
    score = (torch.where(valid & in2, SCORE_TH - e2, zero)
             + torch.where(valid & in1, SCORE_TH - e1, zero)).sum(-1)
    return score, valid & in1 & in2


# ---------------------------------------------------------------------------
# Triangulation (Initializer::Triangulate, src/Initializer.cc:≈210)
# ---------------------------------------------------------------------------


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


def check_rt(R: torch.Tensor, t: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor,
             valid: torch.Tensor, K: torch.Tensor, sigma: float = 1.0):
    """Count the triangulated points with positive depth in both views,
    parallax and low reprojection error under motions (R, t), (..., 3, 3)
    and (..., 3) (Initializer::CheckRT, src/Initializer.cc:≈720).

    Returns (n_good (...), parallax_deg (...), points (..., N, 3), good
    (..., N)); the parallax is the 50th-smallest good one (the last when
    fewer), 0 with none."""
    th2 = 4.0 * sigma * sigma
    P1 = K @ torch.cat([_eye3(K), torch.zeros_like(K[:, :1])], 1)
    P2 = K @ torch.cat([R, t[..., None]], -1)
    # One triangulation per motion: local mapping's, unchanged.
    X = torch.stack([triangulate_linear(P1, P, xy1, xy2)
                     for P in P2.reshape(-1, 3, 4)]).reshape(P2.shape[:-2] + xy1.shape[:1] + (3,))

    finite = torch.isfinite(X).all(-1)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # camera 2's centre in frame 1
    n2 = X - O2[..., None, :]
    cos_par = (X * n2).sum(-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = Xc2[..., 2]
    depth_ok = (z1 > 0) & (z2 > 0)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    p1 = torch.stack([fx * X[..., 0] / z1 + cx, fy * X[..., 1] / z1 + cy], -1)
    p2 = torch.stack([fx * Xc2[..., 0] / z2 + cx, fy * Xc2[..., 1] / z2 + cy], -1)
    e1 = ((p1 - xy1) ** 2).sum(-1)
    e2 = ((p2 - xy2) ** 2).sum(-1)
    good = valid & finite & depth_ok & (cos_par < 0.99998) & (e1 < th2) & (e2 < th2)
    n_good = good.sum(-1)
    par_deg = torch.rad2deg(torch.arccos(torch.clamp(cos_par, -1.0, 1.0)))
    par_sorted = torch.sort(torch.where(good, par_deg, torch.full_like(par_deg, 1e9)), -1).values
    idx = torch.clamp(n_good - 1, min=0, max=49)
    parallax = torch.where(n_good > 0, par_sorted.gather(-1, idx[..., None])[..., 0],
                           torch.zeros_like(par_sorted[..., 0]))
    return n_good, parallax, X, good


# ---------------------------------------------------------------------------
# Motion decomposition
# ---------------------------------------------------------------------------


def _flip_improper(R: torch.Tensor) -> torch.Tensor:
    return torch.where(det3x3(R)[..., None, None] < 0, -R, R)


def decompose_e(E: torch.Tensor):
    """E -> 4 candidate (R, t) (Initializer::DecomposeE, Initializer.cc:≈870):
    R1 = U W V^T and R2 = U W^T V^T made proper, t = +-u3 (unit)."""
    U, _, V = _svd3(E.double(), rank2=True)
    o, z = torch.ones_like(E[0, 0]).double(), torch.zeros_like(E[0, 0]).double()
    W = _mat3([[z, -o, z], [o, z, z], [z, z, o]])
    R1 = _flip_improper(U @ W @ V.T)
    R2 = _flip_improper(U @ W.T @ V.T)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    return Rs.to(torch.float32), ts.to(torch.float32)


def decompose_h(H: torch.Tensor, K: torch.Tensor):
    """Faugeras' 8-motion homography decomposition
    (Initializer::ReconstructH, src/Initializer.cc:≈480).  Returns
    (Rs (8, 3, 3), ts (8, 3)), the four motions of the d' > 0 case then the
    four of d' < 0."""
    A = (inv3x3(K) @ H @ K).double()
    U, w, V = _svd3(A)
    s = det3x3(U) * det3x3(V)
    d1, d2, d3 = w[0], w[1], w[2]
    z, o = torch.zeros_like(d1), torch.ones_like(d1)

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))

    def motions(st, ct, Rp_rows, tp):
        Rp = _mat3(Rp_rows)                          # (4, 3, 3)
        R = s * (U @ Rp @ V.T)
        return R, tp @ U.T                           # t = U tp

    # d' > 0
    den = torch.clamp((d1 + d3) * d2, min=1e-12)
    aux_st, ct = root / den, (d2 * d2 + d1 * d3) / den
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    ct4, z4, o4 = ct.expand(4), z.expand(4), o.expand(4)
    Rs_pos, ts_pos = motions(st, ct, [[ct4, z4, -st], [z4, o4, z4], [st, z4, ct4]],
                             torch.stack([x1s, z4, -x3s], -1) * (d1 - d3))
    # d' < 0
    den = torch.clamp((d1 - d3) * d2, min=1e-12)
    aux_sp, cp = root / den, (d1 * d3 - d2 * d2) / den
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    cp4 = cp.expand(4)
    Rs_neg, ts_neg = motions(sp, cp, [[cp4, z4, sp], [z4, -o4, z4], [sp, z4, -cp4]],
                             torch.stack([x1s, z4, x3s], -1) * (d1 + d3))
    Rs = torch.cat([Rs_pos, Rs_neg])
    ts = torch.cat([ts_pos, ts_neg])
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    return Rs.to(torch.float32), ts.to(torch.float32)


# ---------------------------------------------------------------------------
# Two-view initialization (Initializer::Initialize, src/Initializer.cc:≈40)
# ---------------------------------------------------------------------------


class TwoViewResult(NamedTuple):
    success: torch.Tensor    # bool scalar
    T21: torch.Tensor        # (4, 4): camera 2's pose w.r.t. camera 1 (world = camera 1)
    points: torch.Tensor     # (N, 3) triangulated in camera 1's frame
    good: torch.Tensor       # (N,) triangulation inliers
    used_h: torch.Tensor     # bool scalar: which model was selected
    n_inliers: torch.Tensor  # int scalar: the winning motion's good points


def initialize_two_view(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    match_valid: torch.Tensor,
    K: torch.Tensor,
    samples: Optional[torch.Tensor] = None,
    iters: int = 256,
    sigma: float = 1.0,
    min_parallax: float = 1.0,
    min_triangulated: int = 50,
    generator: Optional[torch.Generator] = None,
) -> TwoViewResult:
    """Monocular map bootstrap from matched undistorted keypoints: xy1 /
    xy2 (N, 2), xy2[i] matching xy1[i] where ``match_valid``.  ``samples``
    (iters, 8) are the RANSAC's indices (the reference draws them uniformly
    over the valid matches, ``jax.random.choice`` with p = valid / sum,
    twoview.py:377); without them they are drawn from ``generator``
    (``pnp.draw_samples``).  Both models' hypotheses are one batch.  No
    host read: every output stays on the device."""
    from .pnp import draw_samples

    if samples is None:
        samples = draw_samples(match_valid, iters, 8, generator)
    samples = samples.long()
    w = match_valid.to(torch.float32)

    x1n, T1 = normalize_points(xy1, match_valid)
    x2n, T2 = normalize_points(xy2, match_valid)
    T2inv = inv3x3(T2)
    s1, s2 = x1n[samples], x2n[samples]  # (iters, 8, 2)

    # Fundamental hypotheses, denormalized T2^T Fn T1, then the least-squares
    # refinement on the best one's inliers (the reference reruns its solver
    # on all inliers after RANSAC; here one weighted solve).
    Fn = _solve_f_8pt(s1, s2)
    F = torch.einsum("ij,bjk,kl->bil", T2.T, Fn, T1)
    f_scores, f_inliers = _score_f(F, xy1, xy2, match_valid, sigma)
    fi = torch.argmax(f_scores)
    f_in = _pick(f_inliers, fi)
    F_ref = T2.T @ _solve_f_8pt(x1n, x2n, w=f_in.to(torch.float32)) @ T1
    s_ref, in_ref = _score_f(F_ref, xy1, xy2, match_valid, sigma)
    f_best = _pick(f_scores, fi)
    better = s_ref >= f_best
    SF = torch.maximum(s_ref, f_best)
    bestF = torch.where(better, F_ref, _pick(F, fi))
    f_in = torch.where(better, in_ref, f_in)

    # Homography hypotheses.
    Hn = _solve_h_dlt(s1, s2)
    H = torch.einsum("ij,bjk,kl->bil", T2inv, Hn, T1)
    h_scores, h_inliers = _score_h(H, xy1, xy2, match_valid, sigma)
    hi = torch.argmax(h_scores)
    h_in = _pick(h_inliers, hi)
    H_ref = T2inv @ _solve_h_dlt(x1n, x2n, w=h_in.to(torch.float32)) @ T1
    hs_ref, h_in_ref = _score_h(H_ref, xy1, xy2, match_valid, sigma)
    h_best = _pick(h_scores, hi)
    h_better = hs_ref >= h_best
    SH = torch.maximum(hs_ref, h_best)
    bestH = torch.where(h_better, H_ref, _pick(H, hi))
    h_in = torch.where(h_better, h_in_ref, h_in)

    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    # Candidate motions: 4 from E, 8 from H, all 12 checked in one batch,
    # the half of the model not selected masked out.
    Rs_e, ts_e = decompose_e(K.T @ bestF @ K)
    Rs_h, ts_h = decompose_h(bestH, K)
    Rs = torch.cat([Rs_e, Rs_h])  # (12, 3, 3)
    ts = torch.cat([ts_e, ts_h])  # (12, 3)
    from_h = torch.arange(12, device=xy1.device) >= 4
    model_mask = torch.where(use_h, from_h, ~from_h)
    inlier_mask = torch.where(use_h, h_in, f_in)

    n_goods, parallaxes, Xs, goods = check_rt(Rs, ts, xy1, xy2, inlier_mask, K, sigma)
    n_goods = torch.where(model_mask, n_goods, -1)
    best = torch.argmax(n_goods)
    n_best = _pick(n_goods, best)
    # The runner-up must be clearly worse (secondBest < 0.75 best).
    n_second = torch.sort(n_goods).values[-2]
    n_inliers = inlier_mask.sum()
    min_good = torch.clamp((0.9 * n_inliers.to(torch.float32)).to(torch.int64),
                           min=min_triangulated)
    success = ((n_best >= min_good)
               & (n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
               & (_pick(parallaxes, best) > min_parallax))
    # (A scalar written into a card tensor is copied there from the host.)
    bottom = torch.cat([torch.zeros_like(T1[2:]), torch.ones_like(T1[2:, :1])], 1)
    T21 = torch.cat([torch.cat([_pick(Rs, best), _pick(ts, best)[:, None]], 1), bottom], 0)
    return TwoViewResult(success=success, T21=T21, points=_pick(Xs, best), good=_pick(goods, best),
                         used_h=use_h, n_inliers=n_best)
