"""System facade — the public API.

Port of ``orbslam2_tpu/models/system.py`` (``System``, src/System.cc):
mono, stereo and RGB-D tracking with local mapping, relocalization and
loop closing: ``track_monocular``, ``track_stereo``, ``track_rgbd``, the
per-frame, pipelined and chunked tracking drivers, synchronous or
asynchronous mapping (a worker
thread on map snapshots, the reference's LocalMapping and LoopClosing
threads), the localization-only mode switches, ``reset`` and
``shutdown``, the metrics snapshot and the three trajectory savers
(SaveTrajectoryTUM ≈270, SaveKeyFrameTrajectoryTUM ≈330,
SaveTrajectoryKITTI ≈370).  ``mesh`` shards the map optimizers over the
ranks of a process group (``parallel/``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import Settings
from ..ops.bow import Vocabulary, train_vocabulary_arrays, vocabulary_from_arrays
from .async_pipeline import AsyncMappingPipeline
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


class SlamSystem:
    """``SlamSystem(settings)`` (mono, the default) then ``track_monocular``
    per frame, ``SlamSystem(settings, "rgbd")`` then ``track_rgbd``, or
    ``SlamSystem(settings, "stereo")`` then ``track_stereo``;
    ``enable_mapping`` (default True) runs local mapping after each
    keyframe and ``enable_loop_closing`` (default True) the loop closer
    after it, with the scale fixed for stereo and RGB-D (they observe it)
    and free for mono, whose loop corrections carry a Sim3 scale.  Mono
    initializes from two views, frame by frame, and then runs whichever
    driver and mapping mode was chosen, as the other sensors do.  Every
    system builds a keyframe database on ``vocabulary`` (by default the
    built-in 1000-word one, ``_default_vocabulary``), which relocalizes
    LOST frames and proposes loop candidates, as the reference does.

    ``pipeline`` and ``chunk`` choose the tracker's driver (see
    ``Tracker``).  ``async_mapping`` runs local mapping and loop closing in
    a worker thread on map snapshots, adopted at later frame boundaries, so
    tracking does not wait for them; adoption depends on wall-clock time,
    so runs that must repeat exactly map synchronously (the default).
    ``mapping_device`` runs the local mapper there (default: the tracker's
    device); the snapshot goes there and the result comes back.  The loop
    closer runs on the tracker's device, beside the keyframe database.

    The signature and defaults are the reference's.  ``mesh``, a
    ``parallel/mesh.make_mesh`` DeviceMesh of several ranks, shards local
    BA, the joint GBA and the essential graph over them: every rank builds
    its system with the mesh and feeds it the same frames, tracking runs
    whole on each, and the ranks' maps stay equal bit for bit.  They equal
    a one-process run's bit for bit too (the sharded local BA and joint GBA
    are the single-device solvers'), until a loop is corrected: the
    distributed essential graph agrees with one device's within 2e-3.  A
    mesh of one is ignored.  It refuses ``async_mapping``, whose adoptions
    would follow each rank's own clock.
    ``device`` is where tracking and mapping run: the card unless the
    caller asks for "cpu".
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
        if sensor not in (Sensor.MONOCULAR, Sensor.STEREO, Sensor.RGBD):
            raise ValueError(f"unknown sensor {sensor!r}")
        if vocabulary is not None and not isinstance(vocabulary, Vocabulary):
            raise TypeError(f"SlamSystem(vocabulary=...) takes this package's Vocabulary "
                            f"(ops/bow.py, utils/vocab.py), not {type(vocabulary).__name__}")
        from ..parallel.mesh import check_mesh

        self.mesh = check_mesh(mesh, "SlamSystem")
        if self.mesh is not None and async_mapping:
            raise ValueError("SlamSystem(mesh=..., async_mapping=True): every rank must map "
                             "the same keyframes at the same frames, and async adoption "
                             "follows each rank's wall clock")
        self.settings = settings
        self.sensor = sensor
        self.device = torch.device(device)
        self.local_mapper = (LocalMapper(settings, sensor=sensor, mesh=self.mesh)
                             if enable_mapping else None)
        self.vocabulary = vocabulary if vocabulary is not None else _default_vocabulary()
        self.enable_loop_closing = enable_loop_closing
        self.pipeline = pipeline
        self.chunk = chunk
        self.async_mapping = async_mapping
        self.mapping_device = None if mapping_device is None else torch.device(mapping_device)
        self._build()
        self.localization_only = False
        self.timestamps = []

    def _build(self):
        """A fresh keyframe database, loop closer, mapping pipeline and
        tracker."""
        self.database = KeyframeDatabase(self.vocabulary, self.settings.tpu.max_keyframes,
                                         device=self.device)
        self.loop_closer = (
            LoopCloser(self.settings, self.database,
                       fix_scale=(self.sensor != Sensor.MONOCULAR), mesh=self.mesh,
                       device=self.device)
            if self.enable_loop_closing else None
        )
        self.mapping_pipeline = self._make_mapping_pipeline()
        self.tracker = Tracker(self.settings, local_mapper=self.local_mapper,
                               database=self.database, loop_closer=self.loop_closer,
                               pipeline=self.pipeline, chunk=self.chunk,
                               mapping_pipeline=self.mapping_pipeline, device=self.device)

    def _make_mapping_pipeline(self):
        if not self.async_mapping or self.local_mapper is None:
            return None
        return AsyncMappingPipeline(self.local_mapper, self.loop_closer,
                                    device=self.mapping_device)

    # -- per-frame API (System::TrackMonocular / TrackStereo / TrackRGBD) --

    def track_monocular(self, image, timestamp: float):
        self.timestamps.append(timestamp)
        return self.tracker.track_mono(image, timestamp)

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
        self._set_ctx_only_tracking(True)

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.local_mapper = self.local_mapper
        self.tracker.localization_only = False
        self._set_ctx_only_tracking(False)

    def _set_ctx_only_tracking(self, value: bool):
        # The chained context of the pipelined and chunked drivers.
        if self.tracker._next_ctx is not None:
            self.tracker._next_ctx = self.tracker._next_ctx._replace(only_tracking=value)

    # -- lifecycle (System::Reset, System::Shutdown) ------------------------

    def reset(self):
        """Drop the map and start over: the mapping job in flight is
        drained and discarded, and the keyframe database, the loop closer,
        the mapping pipeline and the tracker are built afresh.  (The
        reference keeps its loop closer and clears its database, edges and
        streaks; a fresh one also restarts its RANSAC draws and its last
        loop keyframe, so that a run after ``reset`` repeats a fresh
        system's.)"""
        if self.mapping_pipeline is not None:
            self.mapping_pipeline.wait()
        self._build()
        self.timestamps = []

    def shutdown(self):
        """Resolve the frames in flight and drain the mapping worker and its
        keyframe queue (``Tracker.flush``); the worker thread has ended
        when it returns."""
        self.tracker.flush()

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
