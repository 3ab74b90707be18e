"""The reference's trajectory error on ``chip_smoke.py``'s sequences.

    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py            # RGB-D
    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py --stereo   # stereo

Runs the JAX tracker with its LocalMapper (loop closing and the BoW
database off), the configuration ``chip_smoke.py`` drives the port in, and
prints one JSON line: the ATE with mapping on, the keyframes created and
the per-frame states.  ``chip_smoke.py``'s ATE limits are derived from it.

* RGB-D: the smoke run's bench settings (640x480, 1000 features, 8 levels,
  128 keyframes, 16384 points) on its 24-frame sequence (seed 0).
* ``--stereo``: the KITTI operating point of ``examples/run_matrix.py``
  (1241x376, fx 718.856, bf 386.1448, th_depth 35, 2000 features, 8
  levels, 2048 keypoints, 256 keyframes, 65536 points) on the smoke run's
  24-frame stereo sequence (baseline bf / fx).
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings  # noqa: E402
from orbslam2_tpu.models.local_mapping import LocalMapper  # noqa: E402
from orbslam2_tpu.models.tracking import Tracker  # noqa: E402
from orbslam2_tpu.utils import synthetic  # noqa: E402

N_FRAMES = 24
# chip_smoke.py's stereo sequence (STEREO_SEQ there).
STEREO_SEQ = dict(n_points=3000, seed=1, radius=0.4, forward=0.8)


def smoke_settings():
    """chip_smoke.py's bench_settings, in the reference's types."""
    return Settings(
        camera=CameraSettings(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                              width=640, height=480, bf=40.0, th_depth=40.0),
        orb=OrbSettings(n_features=1000, n_levels=8),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=128, max_points=16384),
    )


def kitti_settings():
    """chip_smoke.py's kitti_settings, in the reference's types."""
    return Settings(
        camera=CameraSettings(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                              width=1241, height=376, bf=386.1448, th_depth=35.0),
        orb=OrbSettings(n_features=2000, n_levels=8),
        tpu=TpuSettings(max_keypoints=2048, max_keyframes=256, max_points=65536),
    )


def main():
    jax.config.update("jax_platforms", "cpu")
    stereo = "--stereo" in sys.argv[1:]
    s = kitti_settings() if stereo else smoke_settings()
    cam = s.camera_model()
    if stereo:
        seq = synthetic.make_sequence(cam, n_frames=N_FRAMES,
                                      stereo_baseline=s.camera.bf / s.camera.fx, **STEREO_SEQ)
    else:
        seq = synthetic.make_sequence(cam, n_frames=N_FRAMES, n_points=1500, with_depth=True,
                                      seed=0, radius=0.25, forward=0.5)
    tr = Tracker(s, local_mapper=LocalMapper(s, sensor="stereo" if stereo else "rgbd"),
                 database=None, loop_closer=None)
    states = []
    for i in range(N_FRAMES):
        if stereo:
            tr.track_stereo(seq.images[i][0], seq.images[i][1], seq.timestamps[i])
        else:
            tr.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        states.append(int(tr.state))
    poses = tr.poses_wc()
    print(json.dumps({
        "ate_m": float(synthetic.ate_rmse(poses, seq.poses_wc)),
        "keyframes_created": tr.metrics["keyframes_created"],
        "n_kf": int(np.asarray(tr.map.n_kf)),
        "states": states,
    }))


if __name__ == "__main__":
    main()
