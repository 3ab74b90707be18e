"""One process of the port's multi-process test of the sharded BA step.

N operating-system processes, one rank each, join one process group
through ``parallel/distributed.initialize_distributed`` and run the
one-iteration distributed BA step (``parallel/dist_ba.
make_distributed_ba_step``) ten times on one problem with its cameras
sharded over them; each process then solves the identical problem alone
(one device, no collective) and writes both results' reprojection errors
and their largest pose gap as JSON.  ``tools/multiproc_worker.py`` is the
JAX package's sibling.

    python tools/torch_multiproc_worker.py <coordinator> <nprocs> <rank> <out.json>
        --backend {gloo,nccl} [--device cuda]

``<coordinator>``: "tcp://host:port", "host:port" or "file:///path".  The
caller names the backend; the problem lives on the card unless
``--device cpu`` is given (rank r on card r modulo the cards present).
Launched by ``tests/test_torch_multiprocess.py`` (gloo on the CPU).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAMS_PER_RANK = 4


def make_problem(n_cams, n_obs=64, n_pts=128, noise=0.3, perturb=0.05, seed=3, device="cpu"):
    """``tests/test_parallel.make_problem``'s recipe: cameras on a line
    observing n_obs of n_pts points with pixel noise, every pose but the
    first and every point perturbed."""
    import numpy as np
    import torch

    from orbslam2_tpu_torch.parallel.dist_ba import ShardedBAProblem
    from orbslam2_tpu_torch.solvers.lie import se3_exp
    from orbslam2_tpu_torch.utils.camera import make_camera

    rng = np.random.default_rng(seed)
    cam = make_camera(300.0, 300.0, 128.0, 96.0, width=256, height=192)
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(5, 9, n_pts)], -1).astype(np.float32)
    poses, uv, pid, ok = [], [], [], []
    for c in range(n_cams):
        xi = np.concatenate([[0.2 * c, 0.01 * c, 0.0], rng.normal(0, 0.02, 3)]).astype(np.float32)
        T = se3_exp(torch.from_numpy(xi)).numpy()
        poses.append(T)
        ids = rng.choice(n_pts, n_obs, replace=False)
        pc = X[ids] @ T[:3, :3].T + T[:3, 3]
        uv.append(np.stack([300.0 * pc[:, 0] / pc[:, 2] + 128.0 + rng.normal(0, noise, n_obs),
                            300.0 * pc[:, 1] / pc[:, 2] + 96.0 + rng.normal(0, noise, n_obs)],
                           -1))
        pid.append(ids)
        ok.append(pc[:, 2] > 0)
    poses0 = np.stack(poses)
    for c in range(1, n_cams):
        d = rng.normal(0, perturb, 6).astype(np.float32)
        poses0[c] = se3_exp(torch.from_numpy(d)).numpy() @ poses0[c]
    X0 = X + rng.normal(0, 0.03, X.shape).astype(np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    prob = ShardedBAProblem(
        poses=t(poses0), uv=t(np.stack(uv), torch.float32), pid=t(np.stack(pid), torch.int32),
        obs_ok=t(np.stack(ok)), inv_s2=torch.ones((n_cams, n_obs), device=device),
        is_fixed=torch.arange(n_cams, device=device) == 0, points=t(X0))
    return prob, cam


def mean_reproj_err(prob, poses, pts, cam) -> float:
    from orbslam2_tpu_torch.parallel.dist_ba import _residuals_mono

    r = _residuals_mono(poses, pts, prob.uv, prob.pid, cam, ur=prob.ur)[0]
    return float(r.norm(dim=-1)[prob.obs_ok].mean())


def solve(prob, cam, mesh):
    """Ten iterations of the sharded step on ``mesh`` (None: one device);
    returns the whole poses and the points."""
    from orbslam2_tpu_torch.parallel import dist_ba
    from orbslam2_tpu_torch.parallel.mesh import all_gather_rows

    step = dist_ba.make_distributed_ba_step(mesh, cam, n_total_cams=prob.poses.shape[0])
    block = dist_ba.shard_problem(prob, mesh)
    poses, pts = block.poses, block.points
    for _ in range(10):
        poses, pts = step(block._replace(poses=poses, points=pts))
    return all_gather_rows(poses, mesh), pts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("coordinator")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("out")
    ap.add_argument("--backend", required=True, help="torch.distributed backend: gloo or nccl")
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from orbslam2_tpu_torch.parallel.distributed import initialize_distributed
    from orbslam2_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    device = args.device
    if device == "cuda":
        device = f"cuda:{args.rank % max(torch.cuda.device_count(), 1)}"
        torch.cuda.set_device(device)
    if not initialize_distributed(args.coordinator, num_processes=args.nprocs,
                                  process_id=args.rank, backend=args.backend):
        raise SystemExit("one process: nothing to distribute")
    try:
        mesh = make_mesh()
        prob, cam = make_problem(CAMS_PER_RANK * args.nprocs, device=device)
        poses_g, pts_g = solve(prob, cam, mesh)
        poses_l, pts_l = solve(prob, cam, None)
        out = {
            "rank": args.rank,
            "world_size": dist.get_world_size(),
            "n_cams": int(prob.poses.shape[0]),
            "err_before": mean_reproj_err(prob, prob.poses, prob.points, cam),
            "err_global_mesh": mean_reproj_err(prob, poses_g, pts_g, cam),
            "err_local": mean_reproj_err(prob, poses_l, pts_l, cam),
            "pose_max_abs_gap": float((poses_g - poses_l).abs().max()),
        }
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
