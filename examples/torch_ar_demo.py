"""AR demo of the PyTorch/CUDA port: the ros_mono_ar / ViewerAR example
binary.  Tracks a sequence, fits the map's dominant plane by RANSAC and
draws a virtual cube on it from the tracked camera poses.

Usage: python examples/torch_ar_demo.py [--device cuda] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "orbslam2_tpu_torch_ar"))
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--seed", type=int, default=0, help="seed of the plane RANSAC's draws")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.utils import synthetic
    from orbslam2_tpu_torch.utils.ar import draw_ar_overlay, fit_plane_ransac

    settings = Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0, k1=0, k2=0, p1=0, p2=0,
                              k3=0, width=320, height=240, bf=32.0, th_depth=40.0,
                              depth_map_factor=1.0),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=96, max_points=8192,
                        min_init_matches=50),
    )
    cam = settings.camera_model()
    seq = synthetic.make_sequence(cam, n_frames=args.frames, n_points=400, with_depth=True,
                                  seed=11)
    system = SlamSystem(settings, "rgbd", device=args.device)
    poses = []
    for i in range(args.frames):
        poses.append(system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
                     .cpu().numpy())
    system.tracker.flush()

    m = system.tracker.map
    gen = torch.Generator(device=m.pt_pos.device).manual_seed(args.seed)
    plane = fit_plane_ransac(m.pt_pos, m.pt_valid, generator=gen, inlier_th=0.05)
    print(f"plane inliers={int(plane.n_inliers)} ok={bool(plane.ok)} "
          f"normal={plane.normal.cpu().numpy().round(3)}")

    os.makedirs(args.out, exist_ok=True)
    for i in (0, args.frames // 2, args.frames - 1):
        p = os.path.join(args.out, f"ar_{i:03d}.png")
        draw_ar_overlay(seq.images[i], poses[i], cam, plane, p, size=0.4)
        print("wrote", p)
    return 0 if np.isfinite(plane.normal.cpu().numpy()).all() else 1


if __name__ == "__main__":
    raise SystemExit(main())
