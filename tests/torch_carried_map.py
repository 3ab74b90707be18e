"""A map built by the reference tracker, for the port's mapping tests.

``carried_map()`` runs the JAX tracker (mapping, loop closing and the BoW
database off) over a short synthetic RGB-D sequence at 320x240 with small
pools, and returns the reference settings, the port's settings, the map as
numpy arrays and the id of its newest keyframe.
"""

import jax
import numpy as np

from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu.models.tracking import Tracker
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert


def small_settings():
    return Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0,
                              width=320, height=240, bf=32.0, th_depth=40.0),
        orb=OrbSettings(n_features=500, n_levels=4),
        tpu=TpuSettings(max_keypoints=512, max_keyframes=16, max_points=4096),
    )


def carried_map(n_frames=8):
    s = small_settings()
    seq = jsyn.make_sequence(s.camera_model(), n_frames=n_frames, n_points=400,
                             with_depth=True, seed=11)
    tr = Tracker(s, local_mapper=None, database=None, loop_closer=None)
    for i in range(n_frames):
        tr.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
    m = jax.tree.map(np.array, tr.map)
    return s, convert.settings_from_reference(s), m, int(m.n_kf) - 1
