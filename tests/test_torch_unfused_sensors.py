"""The unfused tracker (``Tracker(use_fused=False)``) against the
reference's on the CPU, for the stereo and mono sensors
(``tests/test_torch_unfused.py`` holds RGB-D):

  * stereo: the first 10 of ``tests/test_torch_stereo_slice.py``'s 12
    pairs, both trackers built with ``use_fused=False`` and a synchronous
    local mapper;
  * mono: ``tests/test_slam_e2e.py``'s ``mono_seq``, its first 10 frames:
    two-view initialization and the frames tracked after it, the
    reference's RANSAC samples drawn, ``use_fused`` set after
    construction.

Per call: state, path and keyframe counts equal; keyframe frame ids equal;
poses within the drivers' 2e-4 m and rad (``torch_drivers``); |dATE| <=
1e-3 m.
"""

import numpy as np
import pytest

from orbslam2_tpu.models.local_mapping import LocalMapper as JLocalMapper
from orbslam2_tpu.models.tracking import Tracker as JTracker
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.local_mapping import LocalMapper
from orbslam2_tpu_torch.models.tracking import Tracker

from test_slam_e2e import small_settings
from torch_drivers import POS_TOL_M, ROT_TOL_RAD, check_pair, make_pair, rot_angle, run_pair
from torch_mono_drivers import mono_sequence
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 10


@pytest.fixture(scope="module")
def stereo():
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=12, n_points=400, stereo_baseline=0.5,
                             seed=13, radius=0.4, forward=0.8)
    ref = JTracker(s, local_mapper=JLocalMapper(s, sensor="stereo"), use_fused=False)
    ps = convert.settings_from_reference(s)
    port = Tracker(ps, local_mapper=LocalMapper(ps, sensor="stereo"), use_fused=False,
                   device="cpu")
    logs = {"ref": [], "port": []}
    for i in range(N):
        left, right = seq.images[i]
        for name, tr in (("ref", ref), ("port", port)):
            tr.track_stereo(left, right, float(i))
            m = tr.metrics
            logs[name].append((int(tr.state), m["track_path"], m["keyframes_created"]))
    return dict(seq=seq, ref=ref, port=port, logs=logs)


def test_stereo_matches_the_reference(stereo):
    ref, port = stereo["ref"], stereo["port"]
    assert stereo["logs"]["port"] == stereo["logs"]["ref"]
    assert all(st == 1 for st, _, _ in stereo["logs"]["ref"])
    assert stereo["logs"]["ref"][-1][2] >= 2
    for a, b in ((ref.map.kf_frame_id, port.map.kf_frame_id), (ref.map.kf_valid, port.map.kf_valid)):
        assert np.array_equal(np.asarray(a), b.numpy())
    out, want = port.poses_wc(), ref.poses_wc()
    assert out.shape == want.shape == (N, 4, 4)
    dt = np.abs(out[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    dr = [rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(out, want)]
    assert dt.max() <= POS_TOL_M, dt
    assert max(dr) <= ROT_TOL_RAD, dr
    gt = stereo["seq"].poses_wc[:N]
    assert abs(jsyn.ate_rmse(out, gt) - jsyn.ate_rmse(want, gt)) <= 1e-3


def test_mono_matches_the_reference():
    s, seq = mono_sequence()
    ref, port = make_pair(s, sensor="mono")
    for system in (ref, port):
        system.tracker.use_fused = False
    logs = run_pair(ref, port, seq.images, None, range(N))
    check_pair(ref, port, logs, seq.poses_wc[:N], with_scale=True)
    init = next(j for j, rec in enumerate(logs["port"]) if rec[0] == 1)
    assert init < N - 3, logs["port"]
    after = logs["port"][init + 1:]
    assert all(st == 1 for st, _, _, _ in after), logs["port"]
    assert sum(p == "motion" for _, p, _, _ in after) >= len(after) // 2, logs["port"]
