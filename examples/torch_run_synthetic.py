"""Synthetic-sequence driver of the PyTorch/CUDA port: the smoke-test
example binary.

Runs a rendered sequence (exact ground truth) through the whole pipeline of
``orbslam2_tpu_torch``, prints each frame's state and time and the median
and mean tracking time at exit (as mono_tum.cc), saves the trajectories and
prints the ATE.

Usage:
  python examples/torch_run_synthetic.py --sensor mono   [--frames 16] [--device cuda]
  python examples/torch_run_synthetic.py --sensor rgbd
  python examples/torch_run_synthetic.py --sensor stereo

Exits 0 when the ATE is below 0.2 m.  ``--profile`` writes a torch.profiler
trace (Chrome format) of the tracking loop to OUT/trace.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"], default="mono")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--points", type=int, default=400)
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    ap.add_argument("--pipeline", action="store_true",
                    help="lag-1 pipelined tracking (the host does not wait for each frame)")
    ap.add_argument("--chunk", type=int, default=0, help="frames per dispatch (chunked driver)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="mapping and loop closing in a worker thread (ORB-SLAM2's "
                         "LocalMapping and LoopClosing threads)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "orbslam2_tpu_torch_out"))
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--viewer", action="store_true", help="write map and frame PNG snapshots")
    ap.add_argument("--viewer-every", type=int, default=0,
                    help="map snapshot every N keyframes and on each loop closure")
    ap.add_argument("--follow-radius", type=float, default=0.0,
                    help="snapshot window half-size around the camera")
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of the tracking loop to OUT/trace")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.utils import synthetic

    bf = 32.0 if args.sensor in ("stereo", "rgbd") else 0.0
    settings = Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0, k1=0, k2=0, p1=0, p2=0,
                              k3=0, width=320, height=240, bf=bf, th_depth=40.0,
                              depth_map_factor=1.0),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=64, max_points=8192,
                        min_init_matches=50),
    )
    cam = settings.camera_model()
    print(f"[synthetic] rendering {args.frames} frames ({args.sensor})...")
    seq = synthetic.make_sequence(
        cam, n_frames=args.frames, n_points=args.points, with_depth=(args.sensor == "rgbd"),
        stereo_baseline=(0.1 if args.sensor == "stereo" else 0.0), seed=7)

    system = SlamSystem(settings, args.sensor, pipeline=args.pipeline, chunk=args.chunk,
                        async_mapping=args.async_mapping, device=args.device)
    if args.no_ba and system.local_mapper is not None:
        system.local_mapper.enable_ba = False

    live_viewer = None
    if args.viewer_every > 0:
        from orbslam2_tpu_torch.utils.viewer import LiveViewer

        live_viewer = LiveViewer(args.out, every_kf=args.viewer_every,
                                 follow_radius=args.follow_radius)

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()

    times = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        if args.sensor == "mono":
            system.track_monocular(seq.images[i], seq.timestamps[i])
        elif args.sensor == "rgbd":
            system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        else:
            system.track_stereo(seq.images[i][0], seq.images[i][1], seq.timestamps[i])
        times.append(time.perf_counter() - t0)
        if live_viewer is not None:
            live_viewer.update(system)
        st = {0: "INIT", 1: "OK", 2: "LOST"}[system.tracking_state()]
        print(f"frame {i:3d}  state={st:5s}  kfs={int(system.map.n_kf):3d}  "
              f"points={int(system.map.pt_valid.sum()):5d}  t={times[-1] * 1e3:7.1f} ms")

    system.shutdown()  # resolve the frames in flight, drain the mapping worker
    if live_viewer is not None:
        live_viewer.finish(system, gt_trajectory=seq.poses_wc)
        print(f"live viewer: {live_viewer.n_snaps} snapshots in {args.out}")
    os.makedirs(args.out, exist_ok=True)
    if prof is not None:
        prof.stop()
        trace_dir = os.path.join(args.out, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print(f"profiler trace written to {trace_dir}/trace.json")

    times_sorted = sorted(times[2:] or times)
    print(f"median tracking time: {times_sorted[len(times_sorted) // 2] * 1e3:.1f} ms")
    print(f"mean tracking time:   {sum(times) / len(times) * 1e3:.1f} ms")
    print("metrics:", system.metrics())

    if args.viewer:
        from orbslam2_tpu_torch.utils import viewer

        viewer.draw_map(system.map, os.path.join(args.out, "map.png"),
                        trajectory=system.poses_wc(), gt_trajectory=seq.poses_wc)
        f = system.tracker.last_frame
        valid = f.valid.cpu().numpy()
        viewer.draw_frame(
            seq.images[-1] if args.sensor != "stereo" else seq.images[-1][0],
            f.xy.cpu().numpy()[valid],
            (system.tracker.last_bindings.cpu().numpy() >= 0)[valid],
            os.path.join(args.out, "frame.png"),
            state_text=f"KFs {int(system.map.n_kf)}  points {int(system.map.pt_valid.sum())}")
        print(f"viewer snapshots: {args.out}/map.png, frame.png")
    system.save_trajectory_tum(os.path.join(args.out, "CameraTrajectory.txt"))
    system.save_keyframe_trajectory_tum(os.path.join(args.out, "KeyFrameTrajectory.txt"))
    system.save_trajectory_kitti(os.path.join(args.out, "CameraTrajectory_kitti.txt"))
    print(f"trajectories written to {args.out}/")

    est = system.poses_wc()
    ate = synthetic.ate_rmse(est[1:], seq.poses_wc[1:], with_scale=(args.sensor == "mono"))
    align = "Sim3" if args.sensor == "mono" else "SE3"
    print(f"ATE RMSE ({align}-aligned): {ate:.4f} m over {args.frames} frames")
    return 0 if np.isfinite(ate) and ate < 0.2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
