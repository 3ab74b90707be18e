"""The unfused tracker (``Tracker(use_fused=False)``: the Track() chain
step by step on the host) against the reference's on the CPU, and against
the port's own fused chain: RGB-D on ``tests/test_track_fused.py``'s
sequence (``small_settings(bf=160)``, ``make_sequence(seed=3)``), its
first 10 of 24 frames, mapping on, loop closing off, ``use_fused`` set on
both trackers after construction, as that test sets it.  Stereo and mono:
``tests/test_torch_unfused_sensors.py``.

Per call: state, path, relocalization and keyframe counts equal; the
keyframes' frame ids, the trajectory's frames and lost flags equal; poses
within the drivers' 2e-4 m and rad (``torch_drivers``); |dATE| <= 1e-3 m.
The port's unfused RGB-D run against its fused run on the same frames in
the reference's shape (``test_track_fused.py::
test_rgbd_fused_matches_unfused``): same keyframe count and frames lost,
|dATE| < 0.02 m.
"""

import numpy as np
import pytest

from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.models.tracking import Tracker

from test_slam_e2e import small_settings
from torch_drivers import check_pair, make_pair, run_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 10


def _unfused(*systems):
    for s in systems:
        s.tracker.use_fused = False


@pytest.fixture(scope="module")
def rgbd():
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=24, with_depth=True, seed=3)
    ref, port = make_pair(s, enable_loop_closing=False)
    _unfused(ref, port)
    syncs = []

    def before(j, i):
        syncs.append(port.tracker.metrics["host_syncs"])

    logs = run_pair(ref, port, seq.images, seq.depths, range(N), before=before)
    return dict(s=s, seq=seq, ref=ref, port=port, logs=logs, syncs=syncs)


def test_rgbd_matches_the_reference(rgbd):
    check_pair(rgbd["ref"], rgbd["port"], rgbd["logs"], rgbd["seq"].poses_wc[:N])
    paths = {p for _, p, _, _ in rgbd["logs"]["port"][1:]}
    assert "motion" in paths, paths
    assert rgbd["logs"]["port"][-1][3] >= 2  # keyframes made on the unfused path


def test_rgbd_counts_its_host_reads(rgbd):
    # Every tracked frame reads the motion-model counts, the local-map
    # count, the keyframe policy and the pose log.
    d = np.diff(rgbd["syncs"])
    assert d[1:].min() >= 5, d


def test_port_unfused_matches_port_fused(rgbd):
    s = convert.settings_from_reference(rgbd["s"])
    seq = rgbd["seq"]
    fused = SlamSystem(s, "rgbd", enable_loop_closing=False, device="cpu")
    assert fused.tracker.use_fused
    for i in range(N):
        fused.track_rgbd(seq.images[i], seq.depths[i], float(i))
    fused.shutdown()
    unfused = rgbd["port"]
    ate_f = jsyn.ate_rmse(fused.poses_wc(), seq.poses_wc[:N], with_scale=False)
    ate_u = jsyn.ate_rmse(unfused.poses_wc(), seq.poses_wc[:N], with_scale=False)
    assert abs(ate_f - ate_u) < 0.02, (ate_f, ate_u)
    assert int(fused.map.n_kf) == int(unfused.map.n_kf)
    assert fused.tracker.metrics["frames_lost"] == unfused.tracker.metrics["frames_lost"]


def test_use_fused_is_the_default_and_an_argument():
    s = convert.settings_from_reference(small_settings(bf=160.0))
    assert Tracker(s, device="cpu").use_fused
    assert not Tracker(s, use_fused=False, device="cpu").use_fused
