"""Live-stream demo of the PyTorch/CUDA port: the ROS node example binary
(Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc) without ROS.

Simulates asynchronous rgb and depth topics (jittered timestamps,
alternating arrival order) from the synthetic world, feeds them through
``utils/live.LiveDriver``'s callbacks, prints the tracking state and saves
the keyframe trajectory on shutdown, as the ROS node does.

Usage: python examples/torch_live_demo.py [--frames 14] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "orbslam2_tpu_torch_live"))
    args = ap.parse_args(argv)

    import numpy as np

    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.utils import synthetic
    from orbslam2_tpu_torch.utils.live import LiveDriver

    settings = Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0, k1=0, k2=0, p1=0, p2=0,
                              k3=0, width=320, height=240, bf=32.0, th_depth=40.0,
                              depth_map_factor=1.0),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=96, max_points=8192,
                        min_init_matches=50),
    )
    seq = synthetic.make_sequence(settings.camera_model(), n_frames=args.frames, n_points=400,
                                  with_depth=True, seed=11)
    system = SlamSystem(settings, "rgbd", device=args.device)
    drv = LiveDriver(system, "rgbd", slop=0.02)

    rng = np.random.default_rng(0)
    for i in range(args.frames):
        t = float(seq.timestamps[i])
        jit = float(rng.uniform(0, 0.005))
        if i % 2:
            drv.feed_depth(seq.depths[i], t + jit)
            drv.feed_rgb(seq.images[i], t)
        else:
            drv.feed_rgb(seq.images[i], t)
            drv.feed_depth(seq.depths[i], t + jit)
        print(f"frame {i:3d} state={system.tracking_state()} "
              f"kfs={int(system.tracker.map.n_kf)}")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "KeyFrameTrajectory.txt")
    drv.shutdown(path)
    ate = synthetic.ate_rmse(system.poses_wc(), seq.poses_wc, with_scale=False)
    print(f"fed={drv.frames} dropped={drv.dropped} ATE={ate:.4f} m; trajectory -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
