"""Essential-graph (Sim3 pose graph) optimization.

Port of ``orbslam2_tpu/solvers/pose_graph.py`` (``Optimizer::
OptimizeEssentialGraph``, src/Optimizer.cc:≈700): all keyframes as Sim3
variables (7-DoF mono, scale frozen for stereo/RGB-D), edges = loop edges
+ spanning tree + strong covisibility (weight >= 100), 20 LM iterations,
then poses recovered by dividing the translation by the scale.

Edges live in fixed-capacity arrays; the residual r_e = log(S_meas_ji *
S_i * S_j^-1) runs on all edges at once and its per-edge Jacobians come
from forward-mode differentiation (``lie.jacfwd_batched``, the
reference's ``jax.jacfwd`` under ``vmap``).  The normal equations are
summed per node and per block in a fixed order (``map_state.segment_sum`` over plans built
once per solve: a float ``index_add`` would run through atomics on the
card); the dense (7K, 7K) system is solved with ``torch.linalg.solve_ex``,
and beyond 4096 unknowns a matrix-free block-Jacobi PCG replaces it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models import map_state as ms
from ..ops.select import topk_stable
from .lie import jacfwd_batched, rt_to_mat, sim3_exp, sim3_from_mat, sim3_inverse_mat, sim3_log
from .sim3_opt import scale_keep


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity edge list: S_ji measurements between keyframes.

    i/j:    (E,) int endpoints
    S_ji:   (E, 4, 4) packed sim3 measurement (frame j <- frame i)
    weight: (E,) float32
    valid:  (E,) bool
    """

    i: torch.Tensor
    j: torch.Tensor
    S_ji: torch.Tensor
    weight: torch.Tensor
    valid: torch.Tensor


def sim3_of_se3(T: torch.Tensor) -> torch.Tensor:
    """SE3 (..., 4, 4) -> packed Sim3 with s = 1 (the same matrix)."""
    return T


def edges_from_map(
    kf_pose_cw: torch.Tensor,
    kf_valid: torch.Tensor,
    kf_parent: torch.Tensor,
    covis: torch.Tensor,
    loop_i: torch.Tensor,
    loop_j: torch.Tensor,
    loop_S_ji: torch.Tensor,
    loop_valid: torch.Tensor,
    min_covis_weight: int = 100,
    max_covis_per_node: int = 16,
) -> PoseGraphEdges:
    """The essential graph's edges: the spanning tree (child, parent), each
    node's top ``max_covis_per_node`` covisible neighbours of weight >=
    ``min_covis_weight`` (ties to the lower id), and the loop edges.  Tree
    and covisibility measurements come from the current relative poses;
    loop edges carry their own Sim3."""
    K = kf_pose_cw.shape[0]
    dev = kf_pose_cw.device
    S_cw = sim3_of_se3(kf_pose_cw)

    child = torch.arange(K, dtype=torch.int64, device=dev)
    parent = kf_parent.long()
    tree_ok = kf_valid & (parent >= 0) & kf_valid[parent.clamp(min=0)]
    tree_i = parent.clamp(min=0)
    tree_j = child

    kk = min(max_covis_per_node, K)
    w_top, nbr = topk_stable(covis, kk)                          # (K, kk)
    cov_i = child[:, None].expand(K, kk).reshape(-1)
    cov_j = nbr.reshape(-1)
    cov_ok = ((w_top.reshape(-1) >= min_covis_weight)
              & kf_valid[cov_i] & kf_valid[cov_j] & (cov_i != cov_j))

    def rel(Si, Sj):  # S_ji = S_j * S_i^-1
        return Sj @ sim3_inverse_mat(Si)

    i_all = torch.cat([tree_i, cov_i, loop_i.long()])
    j_all = torch.cat([tree_j, cov_j, loop_j.long()])
    S_all = torch.cat([rel(S_cw[tree_i], S_cw[tree_j]), rel(S_cw[cov_i], S_cw[cov_j]),
                       loop_S_ji.to(S_cw.dtype)])
    v_all = torch.cat([tree_ok, cov_ok, loop_valid])
    return PoseGraphEdges(i=i_all, j=j_all, S_ji=S_all,
                          weight=torch.ones(v_all.shape, dtype=torch.float32, device=dev),
                          valid=v_all)


def _block_plan(flat: torch.Tensor, keep: torch.Tensor):
    """The distinct targets of the kept entries of ``flat`` and a segment
    plan over them, the other entries dropped: returns (targets (U,), each
    entry's segment (dropped: U), plan).  Three host reads, once per
    solve: the distinct count, whether an entry was dropped, the plan's
    width."""
    uniq, inv = torch.unique(torch.where(keep, flat, -1), return_inverse=True)
    first = int(uniq[0] < 0)  # the dropped entries' -1 sorts first
    seg = torch.where(keep, inv - first, uniq.shape[0] - first)
    return uniq[first:], seg, ms.segment_plan(uniq.shape[0] - first, seg)


def _cg(matvec, b, precond, maxiter: int, tol: float):
    """Preconditioned conjugate gradients from x0 = 0 as
    ``jax.scipy.sparse.linalg.cg`` runs them (its stopping rule: |r|^2 <=
    tol^2 |b|^2, at most ``maxiter`` steps).  The loop runs all ``maxiter``
    steps and freezes the state once the rule holds, so it reads nothing
    back to the host and ends where the reference's loop ends."""
    atol2 = tol * tol * (b * b).sum()
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    gamma = (r * z).sum()
    for _ in range(maxiter):
        run = (r * r).sum() > atol2
        Ap = matvec(p)
        alpha = gamma / (p * Ap).sum()
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = precond(r_)
        gamma_ = (r_ * z_).sum()
        p_ = z_ + (gamma_ / gamma) * p
        x = torch.where(run, x_, x)
        r = torch.where(run, r_, r)
        p = torch.where(run, p_, p)
        gamma = torch.where(run, gamma_, gamma)
    return x


def optimize_essential_graph(
    kf_pose_cw: torch.Tensor,     # (K, 4, 4) current SE3 poses
    kf_valid: torch.Tensor,       # (K,)
    edges: PoseGraphEdges,
    fixed_mask: torch.Tensor,     # (K,) keyframes held fixed (the loop KF)
    init_S_cw: Optional[torch.Tensor] = None,  # (K, 4, 4) packed sim3 seeds
    iters: int = 20,
    fix_scale: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (corrected SE3 poses (K, 4, 4), scales (K,)).  Correcting
    the map points with them is the caller's job."""
    K = kf_pose_cw.shape[0]
    dev = kf_pose_cw.device
    S0 = kf_pose_cw if init_S_cw is None else init_S_cw
    keep = scale_keep(fix_scale, dev)
    ei, ej = edges.i.long(), edges.j.long()
    w_e = edges.weight * edges.valid.to(torch.float32)

    def edge_res_of(xi_i, xi_j, Si0, Sj0, S_meas):
        Si = sim3_exp(xi_i * keep) @ Si0
        Sj = sim3_exp(xi_j * keep) @ Sj0
        return sim3_log(S_meas @ Si @ sim3_inverse_mat(Sj))

    def total_err(xi_all):
        r = edge_res_of(xi_all[ei], xi_all[ej], S0[ei], S0[ej], edges.S_ji)
        return (w_e[:, None] * r * r).sum()

    def res_and_jacobians(xi_all):
        """r (E, 7) and the Jacobians in both endpoints' tangents, in one
        forward pass of 14 directions."""
        def f(x, Si0, Sj0, S_meas):
            return edge_res_of(x[..., :7], x[..., 7:], Si0, Sj0, S_meas)

        x = torch.cat([xi_all[ei], xi_all[ej]], -1)
        r, J = jacfwd_batched(f, (x, S0[ei], S0[ej], edges.S_ji), 0)
        return r, J[..., :7], J[..., 7:]

    # Node sums take the reference's scatter order: every ei entry in edge
    # order, then every ej entry.  An invalid edge's terms are zeros (its
    # weight is 0); they are dropped, which leaves every sum as it is and
    # keeps the padding edges of unused pool slots, all on a few nodes,
    # from widening the plan's buffer.
    node_idx = torch.cat([ei, ej])
    node_keep = torch.cat([edges.valid, edges.valid])
    node_seg = torch.where(node_keep, node_idx, K)
    node_plan = ms.segment_plan(K, node_seg)

    def node_sum(a, b):
        return ms.segment_sum(K, node_seg, torch.cat([a, b]), node_plan)

    # Freeze nodes with no valid edge (whole numbers: an integer scatter).
    degree = ms.scatter_add(K, node_seg, 1)
    free = kf_valid & ~fixed_mask & (degree > 0)
    free_dims = free[:, None].expand(K, 7)
    if fix_scale:
        # Pin every scale dimension: its Hessian row is ~zero.
        free_dims = free_dims & (torch.arange(7, device=dev) != 6)[None, :]

    use_cg = K * 7 > 4096
    if not use_cg:
        blk_idx = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
        blk_uniq, blk_seg, blk_plan = _block_plan(blk_idx, torch.cat([edges.valid] * 4))
        free7 = free_dims.reshape(-1)

    xi = torch.zeros((K, 7), dtype=torch.float32, device=dev)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    # The incumbent's cost carries over: recomputed, it would be the same
    # value from the same inputs.
    err_cur = total_err(xi)
    for _ in range(iters):
        r, J_i, J_j = res_and_jacobians(xi)                      # (E, 7), 2 x (E, 7, 7)
        wJe_i = J_i * w_e[:, None, None]
        wJe_j = J_j * w_e[:, None, None]
        b = node_sum(torch.einsum("eri,er->ei", wJe_i, r), torch.einsum("eri,er->ei", wJe_j, r))
        Hii = torch.einsum("eri,erj->eij", J_i, wJe_i)
        Hjj = torch.einsum("eri,erj->eij", J_j, wJe_j)
        H_diag = node_sum(Hii, Hjj)
        d_elem = torch.clamp(torch.diagonal(H_diag, dim1=-2, dim2=-1), min=1e-6)  # (K, 7)

        if not use_cg:
            blocks = torch.cat([Hii, Hjj, torch.einsum("eri,erj->eij", J_i, wJe_j),
                                torch.einsum("eri,erj->eij", J_j, wJe_i)])
            Hb = torch.zeros((K * K, 7, 7), dtype=torch.float32, device=dev)
            Hb[blk_uniq] = ms.segment_sum(blk_uniq.shape[0], blk_seg, blocks, blk_plan)
            Hd = Hb.view(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
            Hd = Hd + torch.diag((lam * d_elem).reshape(-1))
            Hd = torch.where(free7[:, None] & free7[None, :], Hd, 0.0)
            Hd = Hd + torch.diag(torch.where(free7, 0.0, 1.0))
            bd = torch.where(free7, b.reshape(-1), 0.0)
            dx = -torch.linalg.solve_ex(Hd, bd[:, None])[0][:, 0].view(K, 7)
        else:
            bm = torch.where(free_dims, b, 0.0)

            def matvec(x):
                x = torch.where(free_dims, x, 0.0)
                y = (torch.einsum("erc,ec->er", J_i, x[ei])
                     + torch.einsum("erc,ec->er", J_j, x[ej])) * w_e[:, None]
                out = node_sum(torch.einsum("erc,er->ec", J_i, y),
                               torch.einsum("erc,er->ec", J_j, y))
                out = out + lam * d_elem * x
                return torch.where(free_dims, out, x)

            # Block-Jacobi preconditioner: damped 7x7 block inverses.
            M = H_diag + torch.diag_embed(lam * d_elem + 1e-6)
            M_inv = torch.linalg.inv_ex(M)[0]

            def precond(x):
                return torch.where(free_dims, torch.einsum("kij,kj->ki", M_inv, x), x)

            dx_neg = _cg(matvec, bm, precond, maxiter=100, tol=1e-6)
            dx = -torch.where(free_dims, dx_neg, 0.0)

        xi_new = xi + dx
        err_new = total_err(xi_new)
        accept = err_new < err_cur
        xi = torch.where(accept, xi_new, xi)
        err_cur = torch.where(accept, err_new, err_cur)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e3)

    R, t, s = sim3_from_mat(sim3_exp(xi * keep) @ S0)
    # Recover SE3: divide the translation by the scale (Optimizer.cc:≈1050).
    return rt_to_mat(R, t / s[..., None]), s
