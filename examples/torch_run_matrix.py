"""Reference-scale accuracy matrix of the PyTorch/CUDA port.

ORB-SLAM2 proves itself by running its dataset binaries over TUM, KITTI
and EuRoC and scoring the ATE with external evaluators.  Without the
datasets this is the substitute: every sensor at both of the reference's
operating points, with the production options (chunked tracking, async
mapping, local BA, fuse, global BA and loop closing on), 500 frames or
more around a closed loop, scored against the rendered ground truth.

Cells: sensor in {mono, stereo, rgbd} x (640x480, 1000 features: the TUM
fr1/fr2 point; 1241x376, 2000 features: the KITTI stereo point).

Prints one JSON line per cell and writes them all to ``--out`` (a JSON
list; a cell already there is not run again).  ``examples/run_matrix.py``
is the JAX package's version; its results are ``REFSCALE_r05.json``.

  python examples/torch_run_matrix.py --cells rgbd_640 --workers 7   # the GPU
  python examples/torch_run_matrix.py --frames 80 --cells mono_640 --device cpu
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
# The repository (the package) and this directory (this module, for the
# render processes to import by name when it is not run as a script).
sys.path[:0] = [os.path.join(HERE, ".."), HERE]

CELLS = {
    # name: (sensor, width, height, features)
    "mono_640": ("mono", 640, 480, 1000),
    "stereo_640": ("stereo", 640, 480, 1000),
    "rgbd_640": ("rgbd", 640, 480, 1000),
    "mono_1241": ("mono", 1241, 376, 2000),
    "stereo_1241": ("stereo", 1241, 376, 2000),
    "rgbd_1241": ("rgbd", 1241, 376, 2000),
}


def cell_settings(width, height, features):
    """(settings, circle radius, room half-size, points) of a cell."""
    from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings

    if width >= 1000:
        # KITTI00-02.yaml's operating point.
        fx = 718.856
        cam_kw = dict(fx=fx, fy=fx, cx=607.1928, cy=185.2157, bf=386.1448, th_depth=35.0)
        radius, room, n_pts = 40.0, 70.0, 12000
    else:
        # TUM1.yaml's operating point, on a circle small enough in a room
        # dense enough that corner-facing views keep their landmarks.
        cam_kw = dict(fx=517.306, fy=516.469, cx=318.643, cy=255.314, bf=40.0, th_depth=40.0)
        radius, room, n_pts = 2.5, 5.0, 10000
    settings = Settings(
        camera=CameraSettings(width=width, height=height, **cam_kw),
        orb=OrbSettings(n_features=features, n_levels=8),
        tpu=TpuSettings(max_keypoints=2048 if features > 1024 else 1024,
                        max_keyframes=256, max_points=65536),
    )
    return settings, radius, room, n_pts


def render_frames(spec, frames):
    """Frames ``frames`` of ``make_loop_sequence`` at ``spec`` (seed 5),
    as it renders them (``synthetic.render_loop_frame``)."""
    from orbslam2_tpu_torch.utils import synthetic

    cam = spec["settings"].camera_model()
    room = dict(half_x=spec["room"], half_z=spec["room"])
    world = synthetic.make_room_world(n_points=spec["n_pts"], seed=5, **room)
    poses = synthetic.loop_poses(spec["n_frames"], spec["radius"], 1.25)
    images, depths = [], []
    for f in frames:
        out = synthetic.render_loop_frame(world, poses, f, cam, 5, spec["with_depth"],
                                          spec["baseline"], **room)
        if spec["with_depth"]:
            images.append(out[0])
            depths.append(out[1])
        else:
            images.append(out)
    return images, depths


def load_or_render(name, sensor, settings, radius, room, n_pts, n_frames, cache_dir, workers):
    """(images, ground-truth poses, depths or None), rendered in ``workers``
    processes and cached in ``cache_dir``."""
    import numpy as np

    from orbslam2_tpu_torch.utils import synthetic

    cache = os.path.join(cache_dir, f"torch_matrix_{name}_{n_frames}.npz")
    if os.path.exists(cache):
        data = np.load(cache)
        return data["images"], data["poses"], (data["depths"] if "depths" in data else None)
    t0 = time.time()
    spec = dict(settings=settings, radius=radius, room=room, n_pts=n_pts, n_frames=n_frames,
                baseline=(settings.camera.bf / settings.camera.fx if sensor == "stereo" else 0.0),
                with_depth=(sensor == "rgbd"))
    parts = [range(k, n_frames, workers) for k in range(workers)]
    if workers > 1:
        spawn = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=spawn) as pool:
            done = list(pool.map(render_frames, [spec] * workers, parts))
    else:
        done = [render_frames(spec, parts[0])]
    order = np.argsort(np.concatenate([list(p) for p in parts]))
    images = np.stack([im for ims, _ in done for im in ims])[order]
    depths = np.stack([d for _, ds in done for d in ds])[order] if spec["with_depth"] else None
    poses = synthetic.loop_poses(n_frames, radius, 1.25)
    kw = dict(images=images, poses=poses)
    if depths is not None:
        kw["depths"] = depths
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(cache, **kw)
    print(f"[{name}] rendered {images.shape} in {time.time() - t0:.0f} s ({workers} processes)",
          flush=True)
    return images, poses, depths


def run_cell(name, sensor, width, height, features, n_frames, cache_dir, workers, device):
    import numpy as np

    from orbslam2_tpu_torch.models.system import SlamSystem
    from orbslam2_tpu_torch.ops.bow import train_vocabulary
    from orbslam2_tpu_torch.ops.extractor import OrbExtractor
    from orbslam2_tpu_torch.utils import synthetic

    settings, radius, room, n_pts = cell_settings(width, height, features)
    images, poses_gt, depths = load_or_render(name, sensor, settings, radius, room, n_pts,
                                              n_frames, cache_dir, workers)
    n = images.shape[0]
    ex = OrbExtractor(settings.orb, settings.tpu, device=device)

    def descriptors(i):
        f = ex(images[i][0] if sensor == "stereo" else images[i])
        return f.desc.cpu().numpy()[f.valid.cpu().numpy()].view(np.uint32)

    descs = np.concatenate([descriptors(i) for i in range(0, n, max(1, n // 24))])
    vocab = train_vocabulary(descs, k=10, levels=4, seed=0)

    system = SlamSystem(settings, sensor, vocabulary=vocab, chunk=8, async_mapping=True,
                        enable_loop_closing=True, device=device)
    n_ok = lost = 0
    t0 = time.perf_counter()
    for i in range(n):
        if sensor == "stereo":
            system.track_stereo(images[i][0], images[i][1], i / 10.0)
        elif sensor == "rgbd":
            system.track_rgbd(images[i], depths[i], i / 10.0)
        else:
            system.track_monocular(images[i], i / 10.0)
        st = system.tracking_state()
        lost += int(st == 2)
        n_ok += int(st == 1)
        if (i + 1) % 100 == 0:
            print(f"[{name}] frame {i + 1}/{n} lost={lost}", flush=True)
    system.shutdown()
    dt = time.perf_counter() - t0

    est = system.poses_wc()
    ate = synthetic.ate_rmse(est, poses_gt, with_scale=(sensor == "mono"))
    gt_len = float(np.linalg.norm(np.diff(poses_gt[:, :3, 3], axis=0), axis=1).sum())
    loops = ([(int(a), int(b)) for a, b, _ in system.loop_closer.loop_edges]
             if system.loop_closer else [])
    return {
        "cell": name,
        "sensor": sensor,
        "resolution": f"{width}x{height}",
        "features": features,
        "frames": n,
        "device": str(system.device),
        "tracked_pct": 100.0 * n_ok / n,
        "ate_rmse_m": float(ate),
        "ate_alignment": "sim3" if sensor == "mono" else "se3",
        "drift_pct": 100.0 * float(ate) / max(gt_len, 1e-9),
        "gt_path_length_m": gt_len,
        "fps": n / dt,
        "kf_highwater": int(system.map.n_kf),
        "loop_edges": loops,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--cache-dir", default=tempfile.gettempdir())
    ap.add_argument("--workers", type=int, default=1, help="render processes")
    ap.add_argument("--device", default="cuda", help="torch device (default: the GPU)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "refscale_torch.json"),
                    help="summary JSON path")
    args = ap.parse_args(argv)
    results = []
    cells = list(args.cells)
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {r["cell"] for r in results}
        cells = [c for c in cells if c not in done]
        print(f"resuming: {sorted(done)} done, running {cells}", flush=True)
    for name in cells:
        sensor, w, h, feats = CELLS[name]
        r = run_cell(name, sensor, w, h, feats, args.frames, args.cache_dir, args.workers,
                     args.device)
        print(json.dumps(r), flush=True)
        results.append(r)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"matrix written to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
