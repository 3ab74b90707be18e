"""Mono circle evaluation of the PyTorch/CUDA port: tracks the
rotation-dominant 84-frame circle monocularly and reports the frames lost
and the Sim3-aligned ATE (the stress case of mono tracking, used to judge
front-end changes such as the doubled-budget initialization extractor,
Tracking.cc:≈150's mpIniORBextractor).

Usage: python examples/torch_eval_mono_circle.py [--frames 84] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=84)
    ap.add_argument("--radius", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--fuse", action="store_true")
    ap.add_argument("--points", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.utils import synthetic

    settings = Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0, k1=0, k2=0, p1=0, p2=0,
                              k3=0, width=320, height=240, bf=0.0, th_depth=40.0,
                              depth_map_factor=1.0),
        orb=OrbSettings(n_features=800, n_levels=4),
        tpu=TpuSettings(),
    )
    seq = synthetic.make_loop_sequence(settings.camera_model(), n_frames=args.frames,
                                       circle_radius=args.radius, with_depth=False,
                                       seed=args.seed, n_points=args.points)

    system = SlamSystem(settings, "mono", device=args.device)
    if args.no_ba:
        system.local_mapper.enable_ba = False
    if args.fuse:
        system.local_mapper.enable_fuse = True
    states = []
    t0 = time.time()
    for i in range(args.frames):
        system.track_monocular(seq.images[i], seq.timestamps[i])
        states.append(int(system.tracking_state()))
    wall = time.time() - t0

    lost = states.count(2)
    ok = states.count(1)
    try:
        ate = synthetic.ate_rmse(system.poses_wc(), seq.poses_wc, with_scale=True)
    except Exception as e:  # too few tracked poses to align
        ate = float("nan")
        print(f"ATE alignment failed: {e}")
    print(f"frames={args.frames} ok={ok} lost={lost} ate_sim3={ate:.3f} wall={wall:.1f}s")
    print("states:", "".join(str(s) for s in states))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
