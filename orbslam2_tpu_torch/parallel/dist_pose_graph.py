"""The essential graph (Sim3 pose graph) with its edges sharded over the
mesh.

Port of ``orbslam2_tpu/parallel/dist_pose_graph.py``: each rank holds a
block of the edges (padded to a multiple of the mesh size with invalid
edges), evaluates their residuals and forward-mode Jacobians
(``lie.jacfwd_batched``) and assembles its part of the dense (K, 7, K, 7)
normal equations with sums in a fixed order (``map_state.segment_sum``);
the parts are added once per LM iteration in rank order (the reference's
``psum``), and every rank runs the same damped dense solve
(``torch.linalg.solve_ex``), so the corrected poses come out the same on
every rank.  Its damping and gauge are the reference's distributed
solver's: it is not ``solvers/pose_graph.optimize_essential_graph``, whose
result it matches within the reference's 2e-3.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import map_state as ms
from ..solvers.lie import jacfwd_batched, rt_to_mat, sim3_exp, sim3_from_mat, sim3_inverse_mat, sim3_log
from ..solvers.pose_graph import PoseGraphEdges, _block_plan
from ..solvers.sim3_opt import scale_keep
from .mesh import block_rows, sum_over_ranks


def pad_edges(edges: PoseGraphEdges, n_devices: int) -> PoseGraphEdges:
    """The edge arrays padded to a multiple of ``n_devices`` with invalid
    edges (0 -> 0, identity, weight 0)."""
    E = edges.i.shape[0]
    pad = -(-E // n_devices) * n_devices - E
    if pad == 0:
        return edges
    dev = edges.S_ji.device
    zeros = torch.zeros(pad, dtype=edges.i.dtype, device=dev)
    return PoseGraphEdges(
        i=torch.cat([edges.i, zeros]),
        j=torch.cat([edges.j, zeros]),
        S_ji=torch.cat([edges.S_ji, torch.eye(4, dtype=edges.S_ji.dtype,
                                              device=dev).expand(pad, 4, 4)]),
        weight=torch.cat([edges.weight, torch.zeros(pad, dtype=edges.weight.dtype,
                                                    device=dev)]),
        valid=torch.cat([edges.valid, torch.zeros(pad, dtype=torch.bool, device=dev)]),
    )


def make_distributed_pose_graph(mesh: DeviceMesh, iters: int = 20, fix_scale: bool = False):
    """Returns ``run(S0, kf_valid, edges, fixed_mask) -> (T (K, 4, 4),
    s (K,))``, which every rank calls with the whole edge list (it keeps
    its block): ``S0`` the packed Sim3 seeds (SE3 poses are seeds with
    s = 1), the outputs the same on every rank."""

    def run(S0, kf_valid, edges: PoseGraphEdges, fixed_mask):
        K = S0.shape[0]
        dev = S0.device
        keep = scale_keep(fix_scale, dev)
        edges = pad_edges(edges, mesh.size())
        rows = block_rows(edges.i.shape[0], mesh)
        ei, ej = edges.i[rows].long(), edges.j[rows].long()
        S_ji, valid = edges.S_ji[rows], edges.valid[rows]
        w_e = edges.weight[rows] * valid.to(torch.float32)

        def edge_res_of(xi_i, xi_j, Si0, Sj0, S_meas):
            Si = sim3_exp(xi_i * keep) @ Si0
            Sj = sim3_exp(xi_j * keep) @ Sj0
            return sim3_log(S_meas @ Si @ sim3_inverse_mat(Sj))

        def total_err(xi_all):
            r = edge_res_of(xi_all[ei], xi_all[ej], S0[ei], S0[ej], S_ji)
            return sum_over_ranks((w_e[:, None] * r * r).sum(), mesh)

        # The nodes' degrees (whole numbers) and this rank's sum plans.
        node_seg = torch.where(torch.cat([valid, valid]), torch.cat([ei, ej]), K)
        degree = sum_over_ranks(ms.scatter_add(K, node_seg, 1), mesh)
        free = kf_valid & ~fixed_mask & (degree > 0)
        free7 = free[:, None].expand(K, 7)
        if fix_scale:
            free7 = free7 & (torch.arange(7, device=dev) != 6)[None, :]
        free7 = free7.reshape(-1)
        node_plan = ms.segment_plan(K, node_seg)
        blk_uniq, blk_seg, blk_plan = _block_plan(
            torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),
            torch.cat([valid] * 4))

        def f(x, Si0, Sj0, S_meas):
            return edge_res_of(x[..., :7], x[..., 7:], Si0, Sj0, S_meas)

        xi = torch.zeros((K, 7), dtype=torch.float32, device=dev)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        for _ in range(iters):
            r, J = jacfwd_batched(f, (torch.cat([xi[ei], xi[ej]], -1), S0[ei], S0[ej], S_ji), 0)
            J_i, J_j = J[..., :7], J[..., 7:]
            wJe_i = J_i * w_e[:, None, None]
            wJe_j = J_j * w_e[:, None, None]
            b = ms.segment_sum(K, node_seg, torch.cat([
                torch.einsum("eri,er->ei", wJe_i, r), torch.einsum("eri,er->ei", wJe_j, r)]),
                node_plan)
            blocks = torch.cat([
                torch.einsum("eri,erj->eij", J_i, wJe_i), torch.einsum("eri,erj->eij", J_j, wJe_j),
                torch.einsum("eri,erj->eij", J_i, wJe_j), torch.einsum("eri,erj->eij", J_j, wJe_i)])
            Hb = torch.zeros((K * K, 7, 7), dtype=torch.float32, device=dev)
            Hb[blk_uniq] = ms.segment_sum(blk_uniq.shape[0], blk_seg, blocks, blk_plan)
            # One reduction per iteration: this rank's normal equations.
            Hb, b = sum_over_ranks(torch.cat([Hb.reshape(-1), b.reshape(-1)]), mesh).split(
                [K * K * 49, K * 7])
            Hd = Hb.view(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
            Hd = Hd + torch.diag(lam * torch.clamp(torch.diagonal(Hd), min=1e-6))
            Hd = torch.where(free7[:, None] & free7[None, :], Hd, 0.0)
            Hd = Hd + torch.diag(torch.where(free7, 0.0, 1.0))
            bd = torch.where(free7, b, 0.0)
            dx = -torch.linalg.solve_ex(Hd, bd[:, None])[0][:, 0].view(K, 7)
            xi_new = xi + dx
            accept = total_err(xi_new) < total_err(xi)
            xi = torch.where(accept, xi_new, xi)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e3)

        R, t, s = sim3_from_mat(sim3_exp(xi * keep) @ S0)
        return rt_to_mat(R, t / s[..., None]), s

    return run
