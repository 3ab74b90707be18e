"""Run jobs of the port's multi-device solvers on a group of CPU ranks.

``run_ranks(n, jobs, payload, tmp_dir)`` starts ``n`` processes
(``torch.multiprocessing`` spawn), each with one torch thread, joined by
``torch.distributed`` with the gloo backend through a file under
``tmp_dir`` (no port to collide with other test processes), builds the
mesh and runs each named job of ``JOBS`` on ``payload`` (port objects and
numpy arrays, pickled by ``torch.save``).  Returns, per rank, a dict job ->
the job's outputs.  A rank imports torch, numpy and the port only.
"""

import os
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _ba_step(mesh, p, key):
    from orbslam2_tpu_torch.parallel import dist_ba
    from orbslam2_tpu_torch.parallel.mesh import all_gather_rows

    prob, cam = p[key], p["cam" if key == "prob" else "cam_stereo"]
    step = dist_ba.make_distributed_ba_step(mesh, cam, n_total_cams=prob.poses.shape[0])
    block = dist_ba.shard_problem(prob, mesh)
    poses, pts = block.poses, block.points
    firsts = None
    for _ in range(10):
        poses, pts = step(block._replace(poses=poses, points=pts))
        if firsts is None:
            firsts = (all_gather_rows(poses, mesh), pts)
    return {"poses1": firsts[0], "pts1": firsts[1], "poses": all_gather_rows(poses, mesh),
            "pts": pts}


def job_ba_step(mesh, p):
    return _ba_step(mesh, p, "prob")


def job_ba_step_stereo(mesh, p):
    return _ba_step(mesh, p, "prob_stereo")


def job_pose_graph(mesh, p):
    from orbslam2_tpu_torch.parallel.dist_pose_graph import make_distributed_pose_graph

    est, kf_valid, edges, fixed = p["pose_graph"]
    T, s = make_distributed_pose_graph(mesh, iters=30)(est, kf_valid, edges, fixed)
    T_fix, s_fix = make_distributed_pose_graph(mesh, iters=20, fix_scale=True)(
        est, kf_valid, edges, fixed)
    return {"T": T, "s": s, "T_fix": T_fix, "s_fix": s_fix}


def _same_map(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def job_local_ba(mesh, p):
    from orbslam2_tpu_torch.parallel.dist_ba import distributed_local_ba
    from orbslam2_tpu_torch.solvers.local_ba import local_bundle_adjustment

    m, cam = p["slam_map"], p["slam_cam"]
    inv_s2 = torch.ones(8)
    out = distributed_local_ba(m, 3, mesh, cam, inv_s2)
    single = local_bundle_adjustment(m, 3, cam, inv_s2)
    return {"map": out, "equal_single": _same_map(out, single)}


def job_joint_gba(mesh, p):
    from orbslam2_tpu_torch.parallel.dist_ba import distributed_joint_global_ba
    from orbslam2_tpu_torch.solvers.global_ba import run_joint_global_ba

    m, cam = p["slam_map"], p["slam_cam"]
    inv_s2 = torch.ones(8)
    out = distributed_joint_global_ba(m, mesh, cam, inv_s2, phase_iters=(5, 10))
    single = run_joint_global_ba(m, cam, inv_s2, phase_iters=(5, 10))
    return {"map": out, "equal_single": _same_map(out, single)}


def job_mapper(mesh, p):
    from orbslam2_tpu_torch.models.local_mapping import LocalMapper

    m, s = p["slam_map"], p["mapper_settings"]
    lm1 = LocalMapper(s, sensor="rgbd", enable_fuse=False)
    lmn = LocalMapper(s, sensor="rgbd", enable_fuse=False, mesh=mesh)
    kf = torch.tensor(3)
    out1, outn = lm1._local_ba(m, kf, 16), lmn._local_ba(m, kf, 16)
    return {"has_mesh": lmn.mesh is not None, "equal_single": _same_map(outn, out1)}


def job_sharded_map(mesh, p):
    from orbslam2_tpu_torch.models.local_mapping import LocalMapper
    from orbslam2_tpu_torch.parallel.distributed import (
        gather_map_state, map_state_shardings, shard_map_state)

    m, s = p["slam_map"], p["live_settings"]
    sm = shard_map_state(m, mesh)
    lm = LocalMapper(s, sensor="mono")
    out1 = lm.process_keyframe(m, 3)
    outn = lm.process_keyframe(sm, 3)
    return {
        "placements": tuple(map_state_shardings(m, mesh)),
        "block_kf_rows": sm.block.kf_pose_cw.shape[0],
        "block_pt_rows": sm.block.pt_pos.shape[0],
        "gathered_equal": _same_map(gather_map_state(sm), m),
        "sharded_out": isinstance(outn, type(sm)),
        "process_equal": _same_map(gather_map_state(outn), out1),
    }


def job_slam(mesh, p):
    from orbslam2_tpu_torch.models.system import SlamSystem

    images, depths = p["slam_frames"]
    system = SlamSystem(p["slam_settings"], "rgbd", mesh=mesh, device="cpu")
    for i in range(len(images)):
        system.track_rgbd(images[i], depths[i], float(i))
    system.shutdown()
    return {"has_mesh": system.local_mapper.mesh is not None,
            "poses_wc": system.poses_wc(), "map": system.map,
            "keyframes": system.tracker.metrics["keyframes_created"]}


JOBS = {name[4:]: fn for name, fn in globals().items() if name.startswith("job_")}


def _rank(rank, n, jobs, payload_path, tmp_dir):
    from orbslam2_tpu_torch.parallel.distributed import initialize_distributed
    from orbslam2_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    out = {}
    try:
        initialize_distributed(f"file://{tmp_dir}/init", num_processes=n, process_id=rank,
                               backend="gloo")
        mesh = make_mesh(n)
        payload = torch.load(payload_path, weights_only=False)
        for job in jobs:
            out[job] = JOBS[job](mesh, payload)
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(n, jobs, payload, tmp_dir):
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    payload_path = os.path.join(tmp_dir, "payload.pt")
    torch.save(payload, payload_path)
    mp.spawn(_rank, args=(n, list(jobs), payload_path, tmp_dir), nprocs=n, join=True)
    outs = [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]
    for r, o in enumerate(outs):
        if "error" in o:
            raise RuntimeError(f"rank {r} failed:\n{o['error']}")
    return outs
