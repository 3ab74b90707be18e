"""Dataset driver of the PyTorch/CUDA port: ORB-SLAM2's Examples/ binaries
as one CLI, over ``orbslam2_tpu_torch``.

  mono_tum      -> --dataset tum      --sensor mono
  rgbd_tum      -> --dataset tum      --sensor rgbd   --assoc <file>
  mono_kitti    -> --dataset kitti    --sensor mono
  stereo_kitti  -> --dataset kitti    --sensor stereo
  mono_euroc    -> --dataset euroc    --sensor mono   --timestamps <file>
  stereo_euroc  -> --dataset euroc    --sensor stereo --timestamps <file>
                   (rectified online from the settings' LEFT.* / RIGHT.*
                   blocks, as stereo_euroc.cc's initUndistortRectifyMap)

Usage:
  python examples/torch_run_dataset.py --dataset tum --sensor rgbd \\
      --path /data/rgbd_dataset_freiburg1_desk \\
      --assoc associations/fr1_desk.txt --settings TUM1.yaml [--device cuda]

Runs on the GPU unless ``--device cpu`` is given.  Prints the frame
states, the median and mean tracking time (mono_tum.cc's exit statistics)
and writes CameraTrajectory.txt (TUM format, KITTI format for KITTI) and
KeyFrameTrajectory.txt to ``--out``; ``--save-map`` writes the map
(``utils/checkpoint.py``), ``--gt`` prints ATE and RPE against a
ground-truth file through ``examples/evaluate.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def load_evaluate():
    """``examples/evaluate.py`` (numpy only, shared with the JAX examples),
    loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "evaluate", os.path.join(os.path.dirname(os.path.abspath(__file__)), "evaluate.py"))
    ev = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ev)
    return ev


def load_vocabulary(path):
    """ORBvoc.txt or a packed .npz, or None for the built-in vocabulary."""
    if not path:
        return None
    from orbslam2_tpu_torch.utils import vocab as vocab_io

    t0 = time.perf_counter()
    vocabulary = (vocab_io.load_vocabulary(path) if path.endswith(".npz")
                  else vocab_io.load_orbvoc_text(path))
    print(f"vocabulary loaded in {time.perf_counter() - t0:.2f} s")
    return vocabulary


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["tum", "kitti", "euroc"], required=True)
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"], required=True)
    ap.add_argument("--path", required=True, help="sequence directory")
    ap.add_argument("--settings", required=True, help="reference-format YAML")
    ap.add_argument("--vocabulary", default=None, help="ORBvoc.txt or packed .npz (optional)")
    ap.add_argument("--assoc", default=None, help="TUM rgbd association file")
    ap.add_argument("--timestamps", default=None, help="EuRoC timestamp file")
    ap.add_argument("--out", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    ap.add_argument("--pipeline", action="store_true",
                    help="lag-1 pipelined tracking (the host does not wait for each frame)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames per dispatch (chunked driver; mapping resolves with a lag "
                         "of at most a chunk)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="mapping and loop closing in a worker thread (ORB-SLAM2's "
                         "LocalMapping and LoopClosing threads)")
    ap.add_argument("--viewer-every", type=int, default=0,
                    help="map snapshot every N keyframes and on each loop closure "
                         "(utils/viewer.LiveViewer)")
    ap.add_argument("--follow-radius", type=float, default=0.0,
                    help="snapshot window half-size around the camera")
    ap.add_argument("--save-map", default=None, help="write the final map to this .npz")
    ap.add_argument("--gt", default=None,
                    help="ground-truth trajectory (TUM groundtruth.txt or KITTI poses "
                         "file): prints ATE / RPE at exit")
    return ap


def frame_source(args, settings, ap):
    """(frames, mode, rectify maps or None): frames yields (ts, a, b)."""
    from orbslam2_tpu_torch.utils import datasets

    if args.dataset == "tum" and args.sensor == "rgbd":
        if not args.assoc:
            ap.error("--assoc required for TUM RGB-D")
        return datasets.iter_tum_rgbd(args.path, args.assoc), "rgbd", None
    if args.dataset == "tum":
        return ((ts, im, None) for ts, im in datasets.iter_tum_mono(args.path)), "mono", None
    stereo = args.sensor == "stereo"
    if args.dataset == "kitti":
        return datasets.iter_kitti(args.path, stereo=stereo), args.sensor, None
    if not args.timestamps:
        ap.error("--timestamps required for EuRoC")
    frames = datasets.iter_euroc(args.path, args.timestamps, stereo=stereo)
    rect = settings.rectification
    maps = None
    if rect is not None and stereo:
        c = settings.camera
        maps = tuple(
            datasets.build_rectify_maps(rect[f"{side}.K"], rect[f"{side}.D"], rect[f"{side}.R"],
                                        rect[f"{side}.P"], c.width, c.height)
            for side in ("LEFT", "RIGHT"))
    return frames, args.sensor, maps


def main(argv=None):
    """Run the driver; returns the system, shut down, to a caller in the
    same process."""
    ap = parser()
    args = ap.parse_args(argv)

    from orbslam2_tpu_torch.config import Settings
    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.utils import checkpoint, datasets

    settings = Settings.from_yaml(args.settings, sensor=args.sensor)
    system = SlamSystem(settings, args.sensor, vocabulary=load_vocabulary(args.vocabulary),
                        pipeline=args.pipeline, chunk=args.chunk,
                        async_mapping=args.async_mapping, device=args.device)
    frames, mode, maps = frame_source(args, settings, ap)

    live_viewer = None
    if args.viewer_every > 0:
        from orbslam2_tpu_torch.utils.viewer import LiveViewer

        live_viewer = LiveViewer(args.out, every_kf=args.viewer_every,
                                 follow_radius=args.follow_radius)

    times = []
    n = 0
    for ts, a, b in frames:
        t0 = time.perf_counter()
        if mode == "rgbd":
            system.track_rgbd(a, b, ts)
        elif mode == "stereo":
            if maps is not None:
                a = datasets.remap_bilinear(a, *maps[0])
                b = datasets.remap_bilinear(b, *maps[1])
            system.track_stereo(a, b, ts)
        else:
            system.track_monocular(a, ts)
        times.append(time.perf_counter() - t0)
        if live_viewer is not None:
            live_viewer.update(system)
        n += 1
        if n % 50 == 0:
            print(f"frame {n}: state {system.tracking_state()} metrics {system.metrics()}")
        if args.max_frames and n >= args.max_frames:
            break

    ts_sorted = sorted(times[2:] or times)
    print(f"median tracking time: {ts_sorted[len(ts_sorted) // 2] * 1e3:.1f} ms")
    print(f"mean tracking time:   {sum(times) / len(times) * 1e3:.1f} ms")

    system.shutdown()  # resolve the frames in flight, drain the mapping worker
    lost = sum(bool(x[3]) for x in system.tracker.trajectory)
    print(f"frames: {n} read, {n - lost} tracked, {lost} lost; metrics {system.metrics()}")
    os.makedirs(args.out, exist_ok=True)
    if live_viewer is not None:
        live_viewer.finish(system)
        print(f"live viewer: {live_viewer.n_snaps} snapshots in {args.out}")
    traj = os.path.join(args.out, "CameraTrajectory.txt")
    if args.dataset == "kitti":
        system.save_trajectory_kitti(traj)
    else:
        system.save_trajectory_tum(traj)
    system.save_keyframe_trajectory_tum(os.path.join(args.out, "KeyFrameTrajectory.txt"))
    print(f"trajectories written to {args.out}/")
    if args.save_map:
        checkpoint.save_map(system.map, args.save_map)
        print(f"map written to {args.save_map}")

    if args.gt:
        res = load_evaluate().evaluate_files(
            traj, args.gt, fmt="kitti" if args.dataset == "kitti" else "tum",
            with_scale=(args.sensor == "mono"))
        align = "Sim3" if args.sensor == "mono" else "SE3"
        print(f"ATE RMSE ({align}): {res['ate_rmse_m']:.4f} m over {res['pairs']} pairs | "
              f"RPE {res['rpe_trans_rmse_m']:.4f} m | drift {res['drift_pct']:.2f}%")
    return system


if __name__ == "__main__":
    main()
