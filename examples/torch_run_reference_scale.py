"""Reference-scale run of the PyTorch/CUDA port: a KITTI-class synthetic
sequence in the production configuration.

1000 or more frames at 1241x376 and 2000 features (ORB-SLAM2's
stereo_kitti operating point, Examples/Stereo/stereo_kitti.cc and
KITTI00-02.yaml) around a full circle that closes a loop at its end,
through the production options: chunked tracking, async mapping with
local BA, fuse, global BA and loop closing on.  The trajectory is written
in KITTI format and scored by ``examples/evaluate.py`` against the rendered
ground truth.

Reports the tracked-frame share, ATE, frames/s, the keyframe and point
pools' high-water marks, the loop edges and the wall time of each 100
frames (flat when the per-frame cost does not grow with the map).

  python examples/torch_run_reference_scale.py                 # the GPU
  python examples/torch_run_reference_scale.py --frames 120 --width 320 \\
      --height 96 --features 512 --device cpu                   # a smoke run

The rendered sequence is cached (``--cache``): rendering 1000 KITTI-size
stereo pairs takes minutes on the host.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--cache", default=os.path.join(tmp, "torch_refscale_seq.npz"))
    ap.add_argument("--out", default=os.path.join(tmp, "torch_refscale"))
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import numpy as np

    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.ops.bow import train_vocabulary
    from orbslam2_tpu_torch.ops.extractor import OrbExtractor
    from orbslam2_tpu_torch.utils import synthetic

    # KITTI00-02.yaml's operating point (intrinsics scaled for other sizes).
    sx = args.width / 1241.0
    settings = Settings(
        camera=CameraSettings(fx=718.856 * sx, fy=718.856 * sx, cx=607.1928 * sx,
                              cy=185.2157 * args.height / 376.0, width=args.width,
                              height=args.height, bf=386.1448 * sx, th_depth=35.0),
        orb=OrbSettings(n_features=args.features, n_levels=8),
        tpu=TpuSettings(max_keypoints=2048 if args.features > 1024 else 1024,
                        max_keyframes=256, max_points=65536),
    )
    cam = settings.camera_model()
    baseline = float(settings.camera.bf / settings.camera.fx)

    if os.path.exists(args.cache):
        data = np.load(args.cache)
        images, poses_gt = data["images"], data["poses"]
        print(f"loaded cached sequence {images.shape} from {args.cache}")
    else:
        t0 = time.time()
        seq = synthetic.make_loop_sequence(cam, n_frames=args.frames, circle_radius=40.0,
                                           n_points=12000, seed=args.seed,
                                           stereo_baseline=baseline, room_half=70.0)
        images, poses_gt = seq.images, seq.poses_wc
        np.savez_compressed(args.cache, images=images, poses=poses_gt)
        print(f"rendered {images.shape} in {time.time() - t0:.0f} s")

    n = images.shape[0]
    ex = OrbExtractor(settings.orb, settings.tpu, device=args.device)

    def descriptors(i):
        f = ex(images[i][0])
        return f.desc.cpu().numpy()[f.valid.cpu().numpy()].view(np.uint32)

    vocab = train_vocabulary(
        np.concatenate([descriptors(i) for i in range(0, n, max(1, n // 24))]),
        k=10, levels=4, seed=0)

    system = SlamSystem(settings, "stereo", vocabulary=vocab, chunk=8, async_mapping=True,
                        enable_loop_closing=True, device=args.device)
    lost = 0
    kf_hw = pt_hw = 0
    seg_times = []
    t_seg = t0 = time.perf_counter()
    for i in range(n):
        system.track_stereo(images[i][0], images[i][1], i / 10.0)
        lost += int(system.tracking_state() == 2)
        if (i + 1) % 100 == 0:
            seg_times.append(time.perf_counter() - t_seg)
            t_seg = time.perf_counter()
            kf_hw = max(kf_hw, int(system.map.n_kf))
            pt_hw = max(pt_hw, int(system.map.pt_valid.sum()))
            print(f"frame {i + 1}/{n}: seg={seg_times[-1]:.1f}s kf_hw={kf_hw} pt_hw={pt_hw} "
                  f"lost={lost}", flush=True)
    system.shutdown()
    dt = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    est_path = os.path.join(args.out, "CameraTrajectory.txt")
    gt_path = os.path.join(args.out, "gt_kitti.txt")
    system.save_trajectory_kitti(est_path)
    with open(gt_path, "w") as f:
        for T in poses_gt:
            f.write(" ".join(f"{v:.6e}" for v in T[:3].reshape(-1)) + "\n")

    # examples/evaluate.py (numpy only, shared with the JAX examples), by path.
    spec = importlib.util.spec_from_file_location(
        "evaluate", os.path.join(os.path.dirname(os.path.abspath(__file__)), "evaluate.py"))
    evaluate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(evaluate)
    ev = evaluate.evaluate_files(est_path, gt_path, fmt="kitti")
    loops = ([(a, b) for a, b, _ in system.loop_closer.loop_edges]
             if system.loop_closer else [])
    print(json.dumps({
        "frames": n,
        "device": str(system.device),
        "tracked_pct": 100.0 * (n - lost) / n,
        "ate_rmse_m": float(ev["ate_rmse_m"]),
        "fps": n / dt,
        "kf_highwater": kf_hw,
        "pt_highwater": pt_hw,
        "loop_edges": loops,
        "seg_seconds_per_100": seg_times,
        "compactions": system.tracker.metrics.get("compactions", 0),
        "drift_pct": float(ev["drift_pct"]),
        "gt_path_length_m": float(ev["gt_path_length_m"]),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
