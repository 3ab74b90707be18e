"""Entry points of the PyTorch/CUDA port: the per-frame tracking step, the
chunked driver's step, and a multi-rank dry run of the sharded solvers.

The port's siblings of ``__graft_entry__.py``'s (which stays the JAX
package's):

  * ``entry()``: (step, example_args) of one frame of the Track() chain
    (ORB extraction, depth association, motion model, reference-keyframe
    fallback, local map, keyframe policy) on a TUM-sized RGB-D frame and a
    map made by running the system for a few frames;
  * ``entry_chunk(C)``: (step, example_args) of C frames of the chunked
    driver (``track_fused.make_fused_chunk_tracker``);
  * ``dryrun_multichip(n)``: n ranks (processes), one per device, joined
    by ``torch.distributed``, run the five steps of the JAX package's dry
    run on one map: the sharded local BA, the sharded joint GBA, the
    distributed essential graph, the one-iteration distributed BA step,
    and the live map sharded over the mesh through
    ``LocalMapper.process_keyframe``.

They run on the card unless the caller asks for the CPU:

    python graft_entry_torch.py                    # entry() on the card
    python graft_entry_torch.py --dryrun 2 --device cpu --backend gloo
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _bootstrap(device):
    """TUM-sized RGB-D settings, a sequence, and a system that tracked its
    first frames (so the step sees a populated map)."""
    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.utils import synthetic

    settings = Settings(
        camera=CameraSettings(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480,
                              bf=40.0, th_depth=40.0),
        orb=OrbSettings(n_features=1000, n_levels=8),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=64, max_points=8192),
    )
    n_boot = 10
    seq = synthetic.make_sequence(settings.camera_model(), n_frames=n_boot + 1, n_points=1500,
                                  with_depth=True, seed=0, radius=0.25, forward=0.5)
    system = SlamSystem(settings, "rgbd", enable_mapping=False, enable_loop_closing=False,
                        device=device)
    for i in range(n_boot):
        system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
    if system.tracker.state != 1:
        raise RuntimeError("the bootstrap frames did not track")
    return settings, seq, n_boot, system


def entry(device="cuda"):
    """One frame of the Track() chain: returns (step, (image, depth, map,
    ctx)); ``step(*example_args)`` returns ``track_fused.TrackOut``."""
    import torch

    from orbslam2_tpu_torch.models.track_fused import _fused_track

    settings, seq, n_boot, system = _bootstrap(device)
    tr = system.tracker
    tpu = settings.tpu

    def step(image, depth, m, ctx):
        frame = tr._build_frame("rgbd", (image, depth))
        return _fused_track(m, frame, ctx, tr.cam, tr.scale_factors, tr.inv_sigma2,
                            tr._th_depth(), local_window=tpu.local_window,
                            kf_max_gap=tpu.kf_max_gap, kf_busy_frames=tpu.kf_busy_frames,
                            sensor="rgbd")

    return step, (torch.as_tensor(seq.images[n_boot], dtype=torch.float32, device=tr.device),
                  torch.as_tensor(seq.depths[n_boot], dtype=torch.float32, device=tr.device),
                  tr.map, tr._make_ctx())


def entry_chunk(n_frames_per_dispatch: int = 8, device="cuda"):
    """C frames of the chunked driver: returns (step, (images, depths, map,
    ctx, fid0, min_kf_fid)); ``step(*example_args)`` returns
    ``track_fused.ChunkOut``, whose map and context the caller threads into
    the next call.  ``min_kf_fid`` 2**30 inserts no keyframe (the decision
    still runs every frame)."""
    import torch

    from orbslam2_tpu_torch.models.track_fused import make_fused_chunk_tracker

    settings, seq, n_boot, system = _bootstrap(device)
    tr = system.tracker
    tpu = settings.tpu
    step = make_fused_chunk_tracker(
        lambda inputs: tr._build_frame("rgbd", inputs), tr.cam, tr.scale_factors,
        tr.inv_sigma2, tr._th_depth(), local_window=tpu.local_window,
        kf_max_gap=tpu.kf_max_gap, kf_busy_frames=tpu.kf_busy_frames, sensor="rgbd")
    C = n_frames_per_dispatch
    image = torch.as_tensor(seq.images[n_boot], dtype=torch.float32, device=tr.device)
    depth = torch.as_tensor(seq.depths[n_boot], dtype=torch.float32, device=tr.device)
    return step, ([image] * C, [depth] * C, tr.map, tr._make_ctx(), n_boot, 2**30)


def _dryrun_map(n_devices: int, device):
    """The JAX package's dry-run map: max(2n, 16) keyframes on a line, each
    observing 32 of 128 points, the points perturbed; its camera."""
    import torch

    from orbslam2_tpu_torch.models import map_state as ms
    from orbslam2_tpu_torch.utils.camera import make_camera

    cam = make_camera(300.0, 300.0, 64.0, 48.0, width=128, height=96)
    n_cams, n_obs, n_pts = max(2 * n_devices, 16), 32, 128
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(4, 8, n_pts)], -1).astype(np.float32)
    poses, uv, pid = [], [], []
    for c in range(n_cams):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.15 * c
        poses.append(T)
        ids = rng.choice(n_pts, n_obs, replace=False)
        pc = X[ids] @ T[:3, :3].T + T[:3, 3]
        uv.append(np.stack([300.0 * pc[:, 0] / pc[:, 2] + 64.0,
                            300.0 * pc[:, 1] / pc[:, 2] + 48.0], -1))
        pid.append(ids)
    m = ms.make_empty_map(n_cams, n_pts, n_obs, device="cpu")
    m = m._replace(
        kf_pose_cw=torch.from_numpy(np.stack(poses)),
        kf_xy=torch.from_numpy(np.stack(uv).astype(np.float32)),
        kf_point=torch.from_numpy(np.stack(pid).astype(np.int32)),
        kf_kp_valid=torch.ones((n_cams, n_obs), dtype=torch.bool),
        kf_valid=torch.ones(n_cams, dtype=torch.bool),
        kf_parent=torch.arange(n_cams, dtype=torch.int32) - 1,
        pt_pos=torch.from_numpy(X + rng.normal(0, 0.02, X.shape).astype(np.float32)),
        pt_valid=torch.ones(n_pts, dtype=torch.bool),
        n_kf=torch.tensor(n_cams, dtype=torch.int32), n_pt=torch.tensor(n_pts, dtype=torch.int32),
    )
    return type(m)(*(x.to(device) for x in m)), cam


def _dryrun_steps(mesh, n_devices: int, device):
    """The five steps on this rank; raises if one gives a wrong shape."""
    import torch

    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
    from orbslam2_tpu_torch.models import map_state as ms
    from orbslam2_tpu_torch.models.local_mapping import LocalMapper
    from orbslam2_tpu_torch.parallel import dist_ba, dist_pose_graph
    from orbslam2_tpu_torch.parallel.distributed import shard_map_state
    from orbslam2_tpu_torch.solvers import pose_graph as pg

    m, cam = _dryrun_map(n_devices, device)
    n_cams, n_obs = m.kf_capacity, m.feat_capacity
    n_pts = m.pt_capacity
    inv_s2 = torch.ones(8, device=device)

    # 1. The sharded local BA (what LocalMapper(mesh=...) runs).
    m1 = dist_ba.distributed_local_ba(m, 3, mesh, cam, inv_s2)
    assert m1.kf_pose_cw.shape == (n_cams, 4, 4)
    # 2. The sharded joint GBA (LoopCloser(mesh=...)'s).
    m2 = dist_ba.distributed_joint_global_ba(m, mesh, cam, inv_s2, phase_iters=(2, 2))
    assert m2.pt_pos.shape == (n_pts, 3)
    # 3. The distributed essential graph (LoopCloser(mesh=...)'s correction).
    S_loop = (m.kf_pose_cw[n_cams - 1] @ torch.linalg.inv(m.kf_pose_cw[0]))[None]
    edges = pg.edges_from_map(
        m.kf_pose_cw, m.kf_valid, m.kf_parent, ms.covisibility(m),
        torch.tensor([0], device=device), torch.tensor([n_cams - 1], device=device), S_loop,
        torch.ones(1, dtype=torch.bool, device=device))
    fixed = torch.arange(n_cams, device=device) == 0
    T_new, scales = dist_pose_graph.make_distributed_pose_graph(mesh, iters=5)(
        m.kf_pose_cw, m.kf_valid, edges, fixed)
    assert T_new.shape == (n_cams, 4, 4) and scales.shape == (n_cams,)
    # 4. The one-iteration distributed BA step on the first 2n cameras.
    c = 2 * n_devices
    prob = dist_ba.ShardedBAProblem(
        poses=m.kf_pose_cw[:c], uv=m.kf_xy[:c], pid=m.kf_point[:c],
        obs_ok=torch.ones((c, n_obs), dtype=torch.bool, device=device),
        inv_s2=torch.ones((c, n_obs), device=device), is_fixed=torch.arange(c, device=device) == 0,
        points=m.pt_pos)
    step = dist_ba.make_distributed_ba_step(mesh, cam, n_total_cams=c)
    poses_new, pts_new = step(dist_ba.shard_problem(prob, mesh))
    assert poses_new.shape == (c // n_devices, 4, 4) and pts_new.shape == (n_pts, 3)
    # 5. The live map sharded over the mesh through one process_keyframe.
    s = Settings(camera=CameraSettings(fx=300.0, fy=300.0, cx=96.0, cy=48.0, width=192,
                                       height=96),
                 orb=OrbSettings(n_features=n_obs, n_levels=4),
                 tpu=TpuSettings(max_keypoints=n_obs, max_keyframes=n_cams, max_points=n_pts))
    m5 = LocalMapper(s, sensor="mono").process_keyframe(shard_map_state(m, mesh), 3)
    assert m5.block.kf_pose_cw.shape == (n_cams // n_devices, 4, 4)


def _dryrun_rank(rank, n, init_file, device, backend):
    import torch
    import torch.distributed as dist

    from orbslam2_tpu_torch.parallel.distributed import initialize_distributed
    from orbslam2_tpu_torch.parallel.mesh import make_mesh

    dev = device
    if device == "cuda":
        dev = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(dev)
    initialize_distributed(f"file://{init_file}", num_processes=n, process_id=rank,
                           backend=backend)
    try:
        _dryrun_steps(make_mesh(n), n, dev)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, *, backend: str, device="cuda") -> None:
    """The five sharded steps on ``n_devices`` ranks, one process each,
    joined by ``backend`` (the caller names it: "nccl" with rank r on card
    r, "gloo" for CPU ranks with ``device="cpu"``).  Raises if a rank
    fails."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        mp.spawn(_dryrun_rank, args=(n_devices, os.path.join(root, "init"), device, backend),
                 nprocs=n_devices, join=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    ap.add_argument("--dryrun", type=int, metavar="N", help="dryrun_multichip(N) instead")
    ap.add_argument("--backend", help="the dry run's backend, required with --dryrun: nccl "
                    "(one rank per card) or gloo (CPU ranks)")
    args = ap.parse_args(argv)
    if args.dryrun:
        if not args.backend:
            ap.error("--dryrun needs --backend")
        dryrun_multichip(args.dryrun, device=args.device, backend=args.backend)
        print(f"dryrun_multichip({args.dryrun}) OK")
        return 0
    step, example_args = entry(device=args.device)
    out = step(*example_args)
    print("entry OK:", tuple(out.T_cw.shape), out.flags.tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
