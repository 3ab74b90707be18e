"""Bundle adjustment with the cameras sharded over the mesh.

Port of ``orbslam2_tpu/parallel/dist_ba.py``.  Each rank holds a block of
the keyframes (cameras) and runs the code the reference's ``shard_map``
body runs on it:

  * ``make_distributed_ba_step``: the one-iteration Gauss-Newton step with
    its own residuals and Jacobians (not K4).  Each rank assembles the
    landmark blocks H_pp, b_p and the camera-point cross blocks G of its
    cameras (``map_state.segment_sum``: sums in a fixed order), the ranks'
    landmark blocks are added in rank order (the reference's ``psum``), the
    camera blocks gathered (its ``all_gather``), and every rank solves the
    same reduced camera system and applies its block of the update;
  * ``distributed_local_ba`` and ``distributed_joint_global_ba``: the
    full schedules, ``local_bundle_adjustment`` and ``run_joint_global_ba``
    with the mesh.  Each rank runs K4 and K5 on its block of the cameras,
    the per-camera outputs are gathered, and every rank runs the
    single-device tail, so both equal the single-device solvers bit for
    bit on every rank.  The camera window is padded to a multiple of the
    mesh size with sentinel rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import map_state as ms
from ..solvers.global_ba import run_joint_global_ba
from ..solvers.lie import inv3x3, se3_exp
from ..solvers.local_ba import _blockdiag, _residuals, local_bundle_adjustment
from ..utils.camera import CameraModel
from .mesh import all_gather_rows, block_rows, sum_over_ranks


class ShardedBAProblem(NamedTuple):
    """One rank's block of a BA problem (leading axis: its cameras).

    poses:    (c, 4, 4)  keyframe poses
    uv:       (c, N, 2)  measurements
    pid:      (c, N)     point index per observation (-1 invalid)
    obs_ok:   (c, N)     validity
    inv_s2:   (c, N)     information weights
    is_fixed: (c,)       gauge/fixed mask
    points:   (P, 3)     landmarks (replicated)
    ur:       (c, N)     stereo right-u (<0 = mono observation), or None
    """

    poses: torch.Tensor
    uv: torch.Tensor
    pid: torch.Tensor
    obs_ok: torch.Tensor
    inv_s2: torch.Tensor
    is_fixed: torch.Tensor
    points: torch.Tensor
    ur: Optional[torch.Tensor] = None


def shard_problem(prob: ShardedBAProblem, mesh: Optional[DeviceMesh]) -> ShardedBAProblem:
    """This rank's block of a whole problem (every field but the points)."""
    rows = block_rows(prob.poses.shape[0], mesh)
    return ShardedBAProblem(*(None if x is None else (x if name == "points" else x[rows])
                              for name, x in zip(prob._fields, prob)))


def _residuals_mono(poses, pts, uv, pid, cam: CameraModel, ur=None):
    """Residuals r (c, N, 3) and Jacobians J_cam (c, N, 3, 6), J_pt
    (c, N, 3, 3) and behind (c, N) of the one-step primitive; the third
    (right-u) row only where ``ur`` >= 0 (EdgeStereoSE3ProjectXYZ,
    Optimizer.cc:≈500)."""
    if ur is None:
        ur = torch.full(pid.shape, -1.0, dtype=torch.float32, device=pid.device)
    return _residuals(poses, pts, uv, ur, pid.clamp(min=0), cam)


def make_distributed_ba_step(mesh: Optional[DeviceMesh], cam: CameraModel, n_total_cams: int,
                             lam: float = 1e-4):
    """The one-iteration distributed BA step.  Returns ``step(block)``,
    which every rank calls with its ``ShardedBAProblem`` block and which
    returns (its block of the new poses (c, 4, 4), the new points (P, 3),
    the same on every rank).  ``mesh`` None is the step on one device."""
    C = n_total_cams
    n = 1 if mesh is None else mesh.size()
    c_local = C // n
    if c_local * n != C:
        raise ValueError(f"{C} cameras do not divide over {n} ranks")

    def step(prob: ShardedBAProblem):
        poses, points, pid = prob.poses, prob.points, prob.pid
        P = points.shape[0]
        N = pid.shape[1]
        dev = points.device
        r, J_cam, J_pt, behind = _residuals_mono(poses, points, prob.uv, pid, cam, ur=prob.ur)
        w = prob.inv_s2 * prob.obs_ok.to(torch.float32) * (~behind).to(torch.float32)
        J_cam = torch.where(prob.is_fixed[:, None, None, None], 0.0, J_cam)

        # This rank's blocks.
        H_cc = torch.einsum("cnij,cn,cnik->cjk", J_cam, w, J_cam)
        b_c = torch.einsum("cnij,cn,cni->cj", J_cam, w, r)
        flat_pid = pid.clamp(min=0).reshape(-1)
        plan = ms.segment_plan(P, flat_pid)
        H_pp = ms.segment_sum(P, flat_pid, torch.einsum(
            "cnij,cn,cnik->cnjk", J_pt, w, J_pt).reshape(-1, 3, 3), plan)
        b_p = ms.segment_sum(P, flat_pid, torch.einsum(
            "cnij,cn,cni->cnj", J_pt, w, r).reshape(-1, 3), plan)
        cam_idx = torch.arange(c_local, device=dev)[:, None].expand(c_local, N).reshape(-1)
        G_local = ms.segment_sum(P * c_local, flat_pid * c_local + cam_idx, torch.einsum(
            "cnij,cn,cnik->cnjk", J_cam, w, J_pt).reshape(-1, 6, 3)).view(P, c_local, 6, 3)

        # The collectives: landmark blocks added in rank order, camera
        # blocks gathered.
        H_pp = sum_over_ranks(H_pp, mesh)
        b_p = sum_over_ranks(b_p, mesh)
        G = all_gather_rows(G_local.transpose(0, 1).contiguous(), mesh).transpose(0, 1)
        H_cc_all = all_gather_rows(H_cc, mesh)
        b_c_all = all_gather_rows(b_c, mesh)
        fixed_all = all_gather_rows(prob.is_fixed, mesh)

        eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        tr = H_pp.diagonal(dim1=-2, dim2=-1).sum(-1)
        active = tr > 1e-9
        H_pp_d = H_pp + (lam * eye3)[None] * torch.clamp(tr / 3.0, min=1e-6)[:, None, None]
        Hpp_inv = torch.where(active[:, None, None], inv3x3(H_pp_d + 1e-9 * eye3), 0.0)

        M = torch.einsum("pcij,pjk->pcik", G, Hpp_inv)
        S = _blockdiag(H_cc_all) - torch.einsum("pcik,pdlk->cidl", M, G).reshape(C * 6, C * 6)
        rhs = (b_c_all - torch.einsum("pcik,pk->ci", M, b_p)).reshape(-1)
        free6 = torch.repeat_interleave(~fixed_all, 6)
        S = S + torch.diag(lam * torch.clamp(torch.diagonal(S), min=1e-6))
        S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + torch.diag(torch.where(free6, 0.0, 1.0))
        rhs = torch.where(free6, rhs, 0.0)
        L = torch.linalg.cholesky_ex(S)[0]
        delta_c = -torch.cholesky_solve(rhs[:, None], L)[:, 0].view(C, 6)
        Gt_dc = torch.einsum("pcij,ci->pj", G, delta_c)
        delta_p = -torch.einsum("pij,pj->pi", Hpp_inv, b_p + Gt_dc)
        delta_p = torch.where(active[:, None], delta_p, 0.0)

        # This rank's slice of the camera update.
        d = delta_c[block_rows(C, mesh)]
        poses_new = torch.where(prob.is_fixed[:, None, None], poses, se3_exp(d) @ poses)
        return poses_new, points + delta_p

    return step


def distributed_local_ba(m: ms.MapState, kf_id, mesh: DeviceMesh, cam: CameraModel,
                         inv_sigma2_lut: torch.Tensor, n_local: int = 8, n_fixed: int = 8,
                         phase_iters: Tuple[int, ...] = (5, 10),
                         pt_cap: int = 4096) -> ms.MapState:
    """Local BA around ``kf_id`` with the camera window sharded over
    ``mesh`` (``LocalMapper(mesh=...)``): ``local_bundle_adjustment``'s
    gather, compaction and write-back, the window padded to a multiple of
    the mesh size with sentinel rows; every rank returns the same map,
    that of the single-device solver."""
    return local_bundle_adjustment(m, kf_id, cam, inv_sigma2_lut, n_local=n_local,
                                   n_fixed=n_fixed, phase_iters=phase_iters, pt_cap=pt_cap,
                                   mesh=mesh)


def distributed_joint_global_ba(m: ms.MapState, mesh: DeviceMesh, cam: CameraModel,
                                inv_sigma2_lut: torch.Tensor,
                                phase_iters: Tuple[int, int] = (5, 10), max_cams: int = 512,
                                initial_prune: float = 0.0,
                                unbind_outliers: bool = True) -> ms.MapState:
    """Joint global BA with the compacted cameras sharded over ``mesh``
    (``LoopCloser(mesh=...)``): ``run_joint_global_ba``'s compaction, C
    padded to a multiple of the mesh size."""
    return run_joint_global_ba(m, cam, inv_sigma2_lut, phase_iters=phase_iters,
                               max_cams=max_cams, initial_prune=initial_prune,
                               unbind_outliers=unbind_outliers, mesh=mesh)
