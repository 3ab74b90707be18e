"""SE(3) and Sim(3) operations on torch tensors — port of
``orbslam2_tpu/solvers/lie.py``.

SE3 is a (..., 4, 4) homogeneous matrix; tangent vectors are
``[rho(3), phi(3)]`` (translation first), as in the reference package.
Sim3 is packed as a 4x4 with the scaled rotation sR in the upper-left
block (the g2o::Sim3 convention); its tangent is ``[rho(3), phi(3),
sigma]`` with scale ``s = exp(sigma)``.  The branches for small angles and
small sigma are ``torch.where`` on both sides, so forward-mode derivatives
(``torch.func.jvp``) pass through every function here.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(Phi: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], dim=-1)


def _sinc_terms(theta2: torch.Tensor):
    """Taylor-safe (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + _EPS))
    return A, B, C


def _eye3_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    A, B, _ = _sinc_terms((phi * phi).sum(-1))
    Phi = hat(phi)
    return _eye3_like(Phi) + A[..., None, None] * Phi + B[..., None, None] * (Phi @ Phi)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map: (..., 3, 3) -> (..., 3) axis-angle, safe near 0 and pi (the
    reference's branches and clamps)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # sin(theta) * axis
    sin_t = torch.sin(theta)
    small_scale = 0.5 + theta * theta / 12.0
    scale = torch.where(sin_t > 1e-6, theta / (2.0 * sin_t + _EPS), small_scale)
    phi_generic = 2.0 * w * scale[..., None]
    # Near pi: the axis is the largest column of R + I.
    Rp = R + _eye3_like(R)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = Rp.gather(-1, k[..., None, None].expand(Rp.shape[:-1] + (1,)))[..., 0]
    axis = col / (torch.linalg.norm(col, dim=-1, keepdim=True) + _EPS)
    near_pi = (torch.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], axis * theta[..., None], phi_generic)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi): the V matrix of the SE3 exp."""
    _, B, C = _sinc_terms((phi * phi).sum(-1))
    Phi = hat(phi)
    return _eye3_like(Phi) + B[..., None, None] * Phi + C[..., None, None] * (Phi @ Phi)


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    Phi = hat(phi)
    half = 0.5 * theta
    cot = torch.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0,
                      (1.0 - half * torch.cos(half) / (torch.sin(half) + _EPS)) / (theta2 + _EPS))
    return _eye3_like(Phi) - 0.5 * Phi + cot[..., None, None] * (Phi @ Phi)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) homogeneous."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: (..., 4, 4) -> (..., 6) [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = (_left_jacobian_inv(phi) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3)."""
    return (p[..., None, :] * T[..., :3, :3]).sum(-1) + T[..., :3, 3]


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched (..., 3, 3) matrices, with
    the reference's determinant floor: |det| < 1e-12 becomes 1e-12."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def orthonormalize_se3(T: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project the rotation block of (..., 4, 4) back onto SO(3) by
    Newton-Schulz polar iteration (X <- 0.5 X (3I - X^T X)); inputs are
    near-rotations drifted by float accumulation in the velocity chain."""
    R = T[..., :3, :3]
    norm = torch.sqrt((R * R).sum(dim=(-2, -1), keepdim=True))
    X = R / torch.clamp(norm / 3.0 ** 0.5, min=1.0)
    eye = _eye3_like(X)
    for _ in range(iters):
        X = 0.5 * (X @ (3.0 * eye - X.transpose(-1, -2) @ X))
    return rt_to_mat(X, T[..., :3, 3])


def jacfwd_batched(f, args, argnum: int):
    """Value and Jacobian of ``f(*args)`` in ``args[argnum]`` (..., n) by
    forward-mode differentiation (the reference's ``jax.jacfwd``): one
    pass of dual tensors with the n basis directions as a new leading
    dimension, so ``f`` must broadcast over leading dimensions.  Returns
    (value (..., m), J (..., m, n)).  (``torch.func.jacfwd`` runs the same
    passes under ``vmap``, where a ``torch.where`` tangent came out in
    float64.)"""
    x = args[argnum]
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    basis = basis.view((n,) + (1,) * (x.dim() - 1) + (n,)).expand((n,) + x.shape).contiguous()
    with fwAD.dual_level():
        a = list(args)
        a[argnum] = fwAD.make_dual(x.expand((n,) + x.shape).contiguous(), basis)
        value, tangent = fwAD.unpack_dual(f(*a))
    return value[0], tangent.movedim(0, -1)


# ---------------------------------------------------------------------------
# Sim(3): loop closing and the essential graph
# ---------------------------------------------------------------------------


def det3x3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of batched (..., 3, 3) matrices by cofactors."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def sim3_to_mat(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Pack Sim3 as 4x4 with the sR block."""
    return rt_to_mat(s[..., None, None] * R, t)


def sim3_from_mat(S: torch.Tensor):
    """Packed Sim3 -> (R, t, s), s the cube root of |det(sR)|."""
    sR = S[..., :3, :3]
    s = torch.pow(det3x3(sR).abs() + _EPS, 1.0 / 3.0)
    return sR / s[..., None, None], S[..., :3, 3], s


def sim3_inverse_mat(S: torch.Tensor) -> torch.Tensor:
    R, t, s = sim3_from_mat(S)
    Rinv = R.transpose(-1, -2)
    sinv = 1.0 / s
    tinv = -sinv[..., None] * (Rinv @ t[..., None])[..., 0]
    return sim3_to_mat(Rinv, tinv, sinv)


def sim3_apply(S: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply packed Sim3 (sR | t) to points (..., 3)."""
    return (p[..., None, :] * S[..., :3, :3]).sum(-1) + S[..., :3, 3]


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) exp: (..., 7) [rho, phi, sigma] -> packed 4x4 (sR | t), with
    the closed-form W matrix of Strasdat's thesis (g2o's Sim3)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return sim3_to_mat(so3_exp(phi), t, torch.exp(sigma))


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Packed Sim3 -> (..., 7) [rho, phi, sigma], rho solving W rho = t by
    the closed-form 3x3 inverse (no solver status read back)."""
    R, t, s = sim3_from_mat(S)
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = (inv3x3(_sim3_W(phi, sigma)) @ t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    # Scalars enter torch.where as tensors: under torch.func's vmap a bare
    # Python float there is promoted to float64.
    one = torch.ones_like(sigma)
    s = torch.exp(sigma)
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    Phi = hat(phi)
    eps_sigma = sigma.abs() < 1e-5
    small_theta = theta2 < 1e-8
    sig = torch.where(eps_sigma, one, sigma)
    s_cos = s * torch.cos(theta)
    s_sin = s * torch.sin(theta)
    denom = sig * sig + theta2
    A = torch.where(eps_sigma, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig)
    b_gen = (sig * s_sin + (1.0 - s_cos) * theta) / (torch.where(small_theta, one, theta) * denom)
    c_gen = (A - ((s_cos - 1.0) * sig + s_sin * theta) / denom) / torch.where(
        small_theta, one, theta2)
    _, B0, C0 = _sinc_terms(theta2)
    b = torch.where(eps_sigma, B0, b_gen)
    c = torch.where(eps_sigma, C0, c_gen)
    b_t0 = (sig * s + 1.0 - s) / (sig * sig)
    b = torch.where(small_theta & ~eps_sigma, b_t0, b)
    c = torch.where(small_theta, torch.where(eps_sigma, one / 6.0, c), c)
    return (A[..., None, None] * _eye3_like(Phi) + b[..., None, None] * Phi
            + c[..., None, None] * (Phi @ Phi))
