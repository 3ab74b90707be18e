"""System facade — the public API.

Port of ``orbslam2_tpu/models/system.py`` (``System``, src/System.cc) for
stereo and RGB-D tracking with synchronous local mapping, relocalization
and loop closing: ``track_stereo``, ``track_rgbd``, the localization-only
mode switches, the metrics snapshot and the three trajectory savers
(SaveTrajectoryTUM ≈270, SaveKeyFrameTrajectoryTUM ≈330,
SaveTrajectoryKITTI ≈370).  Options the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item, rather than being ignored.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import Settings
from ..ops.bow import Vocabulary, train_vocabulary_arrays, vocabulary_from_arrays
from .kf_database import KeyframeDatabase
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .tracking import Tracker


class Sensor:
    MONOCULAR = "mono"
    STEREO = "stereo"
    RGBD = "rgbd"


@functools.lru_cache(maxsize=4)
def _default_vocabulary_arrays(seed: int):
    rng = np.random.default_rng(seed)
    train = rng.integers(0, 2**32, (6000, 8), dtype=np.uint32)
    return train_vocabulary_arrays(train, k=10, levels=3, seed=seed)


def _default_vocabulary(seed: int = 0) -> Vocabulary:
    """The reference's small built-in vocabulary (k=10, L=3: 1000 words)
    trained on seeded random descriptors, as CPU tensors (trained once per
    process).  Real datasets want a vocabulary built from representative
    data or converted from ORBvoc.txt (``utils/vocab.py``)."""
    return vocabulary_from_arrays(*_default_vocabulary_arrays(seed), levels=3)


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class SlamSystem:
    """``SlamSystem(settings, "rgbd")`` then ``track_rgbd`` per frame, or
    ``SlamSystem(settings, "stereo")`` then ``track_stereo``;
    ``enable_mapping`` (default True) runs local mapping after each
    keyframe and ``enable_loop_closing`` (default True) the loop closer
    after it, with the scale fixed (stereo and RGB-D observe it).  Every
    system builds a keyframe database on ``vocabulary`` (by default the
    built-in 1000-word one, ``_default_vocabulary``), which relocalizes
    LOST frames and proposes loop candidates, as the reference does.

    The signature and defaults are the reference's; every option this port
    lacks raises.  ``device`` is where tracking and mapping run: the card
    unless the caller asks for "cpu".
    """

    def __init__(
        self,
        settings: Settings,
        sensor: str = Sensor.MONOCULAR,
        enable_mapping: bool = True,
        vocabulary=None,
        enable_loop_closing: bool = True,
        pipeline: bool = False,
        chunk: int = 0,
        async_mapping: bool = False,
        mapping_device=None,
        mesh=None,
        device="cuda",
    ):
        if sensor == Sensor.MONOCULAR:
            raise _not_ported("monocular tracking", 13)
        if sensor not in (Sensor.STEREO, Sensor.RGBD):
            raise ValueError(f"unknown sensor {sensor!r}")
        if vocabulary is not None and not isinstance(vocabulary, Vocabulary):
            raise TypeError(f"SlamSystem(vocabulary=...) takes this package's Vocabulary "
                            f"(ops/bow.py, utils/vocab.py), not {type(vocabulary).__name__}")
        if chunk or pipeline:
            raise _not_ported("the chunked and pipelined trackers (chunk, pipeline)", 11)
        if async_mapping or mapping_device is not None:
            raise _not_ported("async mapping (async_mapping, mapping_device)", 10)
        if mesh is not None:
            raise _not_ported("multi-device solvers (mesh)", 17)
        self.settings = settings
        self.sensor = sensor
        self.device = torch.device(device)
        # Synchronous local mapping after each keyframe (the reference's
        # LocalMapping thread; async mapping is item 10).
        self.local_mapper = LocalMapper(settings, sensor=sensor) if enable_mapping else None
        self.vocabulary = vocabulary if vocabulary is not None else _default_vocabulary()
        self.database = KeyframeDatabase(self.vocabulary, settings.tpu.max_keyframes,
                                         device=self.device)
        self.loop_closer = (
            LoopCloser(settings, self.database, fix_scale=(sensor != Sensor.MONOCULAR),
                       device=self.device)
            if enable_loop_closing else None
        )
        self.tracker = Tracker(settings, local_mapper=self.local_mapper,
                               database=self.database, loop_closer=self.loop_closer,
                               device=self.device)
        self.localization_only = False
        self.timestamps = []

    # -- per-frame API (System::TrackStereo / TrackRGBD) -----------------

    def track_stereo(self, image_left, image_right, timestamp: float):
        self.timestamps.append(timestamp)
        return self.tracker.track_stereo(image_left, image_right, timestamp)

    def track_rgbd(self, image, depth, timestamp: float):
        self.timestamps.append(timestamp)
        return self.tracker.track_rgbd(image, depth, timestamp)

    # -- modes (System::ActivateLocalizationMode) -------------------------

    def activate_localization_mode(self):
        """Tracking only: local mapping and keyframe insertion pause (the
        reference stops LocalMapping and sets mbOnlyTracking); motion-model
        tracking leans on temporary VO points through unmapped regions."""
        self.localization_only = True
        self.tracker.local_mapper = None
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.local_mapper = self.local_mapper
        self.tracker.localization_only = False

    # -- state inspection --------------------------------------------------

    @property
    def map(self):
        return self.tracker.map

    def tracking_state(self) -> int:
        return self.tracker.state

    def metrics(self) -> dict:
        """Counters + map size (the reference's status prints as data)."""
        m = dict(self.tracker.metrics)
        m["n_keyframes"] = int(self.map.kf_valid.sum())
        m["n_points"] = int(self.map.pt_valid.sum())
        m["n_loop_closures"] = len(self.loop_closer.loop_edges) if self.loop_closer else 0
        return m

    def poses_wc(self) -> np.ndarray:
        return self.tracker.poses_wc()

    # -- trajectory savers -------------------------------------------------

    def save_trajectory_tum(self, path: str):
        """TUM format: 'timestamp tx ty tz qx qy qz qw' per frame
        (System::SaveTrajectoryTUM)."""
        poses = self.poses_wc()
        with open(path, "w") as f:
            for i, T in enumerate(poses):
                ts = self.timestamps[i] if i < len(self.timestamps) else float(i)
                f.write(_tum_line(ts, T))

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only TUM trajectory (System::SaveKeyFrameTrajectoryTUM)."""
        m = self.map
        n = int(m.n_kf)
        kf_poses = m.kf_pose_cw[:n].cpu().numpy()
        kf_frames = m.kf_frame_id[:n].cpu().numpy()
        kf_ok = m.kf_valid[:n].cpu().numpy()
        with open(path, "w") as f:
            for i in range(n):
                if not kf_ok[i]:
                    continue
                fid = int(kf_frames[i])
                ts = self.timestamps[fid] if fid < len(self.timestamps) else float(fid)
                f.write(_tum_line(ts, np.linalg.inv(kf_poses[i])))

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 12 numbers (3x4 row-major Twc) per frame
        (System::SaveTrajectoryKITTI)."""
        poses = self.poses_wc()
        with open(path, "w") as f:
            for T in poses:
                f.write(" ".join(f"{x:.9e}" for x in T[:3, :4].reshape(-1)) + "\n")


def _tum_line(ts: float, T: np.ndarray) -> str:
    t = T[:3, 3]
    q = _rot_to_quat(T[:3, :3])
    return (
        f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
    )


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM order."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])
