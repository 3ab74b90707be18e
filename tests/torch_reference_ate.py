"""The reference's trajectory error on ``chip_smoke.py``'s sequence.

    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py

Runs the JAX tracker with its LocalMapper (loop closing and the BoW
database off), the configuration ``chip_smoke.py`` drives the port in, at
the smoke run's settings (640x480, 1000 features, 8 levels, 128 keyframes,
16384 points) on its 24-frame synthetic sequence (seed 0), and prints one
JSON line: the ATE with mapping on, the keyframes created and the per-frame
states.  ``chip_smoke.py``'s mapping-slice ATE limit is derived from it.
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


def smoke_settings():
    """chip_smoke.py's bench_settings, in the reference's types."""
    return Settings(
        camera=CameraSettings(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                              width=640, height=480, bf=40.0, th_depth=40.0),
        orb=OrbSettings(n_features=1000, n_levels=8),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=128, max_points=16384),
    )


def main():
    jax.config.update("jax_platforms", "cpu")
    s = smoke_settings()
    seq = synthetic.make_sequence(s.camera_model(), n_frames=N_FRAMES, n_points=1500,
                                  with_depth=True, seed=0, radius=0.25, forward=0.5)
    tr = Tracker(s, local_mapper=LocalMapper(s, sensor="rgbd"), database=None,
                 loop_closer=None)
    states = []
    for i in range(N_FRAMES):
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
