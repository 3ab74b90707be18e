"""The stereo slice end to end: stereo tracking with synchronous local
mapping, the JAX tracker with its LocalMapper (loop closing and the BoW
database off) against the port's ``SlamSystem(sensor="stereo",
enable_mapping=True)`` on the CPU, frame by frame, on the sequence and
settings of ``tests/test_slam_e2e.py::TestStereoSlam`` (320x240, 800
features, 4 levels, bf 160, baseline 0.5, 12 frames, seed 13, radius 0.4,
forward 0.8).

Tolerances, those of ``tests/test_torch_mapping_slice.py``: per-frame
state, tracking path and keyframe count exact; the final map's integer and
boolean fields exact; per-frame positions within POS_TOL_M and rotations
within ROT_TOL_RAD (local BA's float32 sums run in another order), and
|ATE_port - ATE_ref| <= 1e-3 m.
"""

import numpy as np
import pytest

from orbslam2_tpu.models.local_mapping import LocalMapper
from orbslam2_tpu.models.tracking import Tracker
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert, kernels
from orbslam2_tpu_torch.models.system import SlamSystem
from tests.test_slam_e2e import small_settings
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

POS_TOL_M = 2e-4
ROT_TOL_RAD = 2e-4
ATE_TOL_M = 1e-3
N_FRAMES = 12


def _rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _record(tracker):
    m = tracker.metrics
    return (tracker.state, m["track_path"], m["keyframes_created"])


@pytest.fixture(scope="module")
def runs():
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=N_FRAMES, n_points=400,
                             stereo_baseline=0.5, seed=13, radius=0.4, forward=0.8)
    ref = Tracker(s, local_mapper=LocalMapper(s, sensor="stereo"), database=None,
                  loop_closer=None)
    port = SlamSystem(convert.settings_from_reference(s), "stereo", enable_mapping=True,
                      enable_loop_closing=False, device="cpu")
    kernels.reset_launch_counts()
    ref_log, port_log = [], []
    for i in range(N_FRAMES):
        left, right = seq.images[i]
        ref.track_stereo(left, right, seq.timestamps[i])
        port.track_stereo(left, right, seq.timestamps[i])
        ref_log.append(_record(ref))
        port_log.append(_record(port.tracker))
    return dict(seq=seq, ref=ref, port=port, ref_log=ref_log, port_log=port_log,
                launches=dict(kernels.LAUNCHES))


def test_per_frame_state_path_and_keyframes(runs):
    assert runs["port_log"] == runs["ref_log"]
    assert all(state == 1 for state, _, _ in runs["ref_log"])
    assert runs["ref_log"][-1][2] >= 2  # the mapper ran on several keyframes


def test_per_frame_poses_and_ate(runs):
    ref = runs["ref"].poses_wc()
    out = runs["port"].poses_wc()
    assert out.shape == ref.shape == (N_FRAMES, 4, 4)
    dt = np.abs(out[:, :3, 3] - ref[:, :3, 3]).max(axis=1)
    dr = [_rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(out, ref)]
    assert dt.max() <= POS_TOL_M, dt
    assert max(dr) <= ROT_TOL_RAD, dr
    gt = runs["seq"].poses_wc
    assert abs(jsyn.ate_rmse(out, gt) - jsyn.ate_rmse(ref, gt)) <= ATE_TOL_M


def test_final_map(runs):
    ref_map, port = runs["ref"].map, runs["port"]
    for name in ("kf_valid", "kf_point", "kf_kp_valid", "kf_level", "pt_valid", "kf_parent",
                 "n_kf", "n_pt"):
        np.testing.assert_array_equal(getattr(port.map, name).numpy(),
                                      np.asarray(getattr(ref_map, name)), err_msg=name)
    np.testing.assert_allclose(port.map.kf_pose_cw.numpy(), np.asarray(ref_map.kf_pose_cw),
                               atol=POS_TOL_M)
    m = port.metrics()
    assert m["frames_lost"] == 0
    assert m["n_keyframes"] == int(np.asarray(ref_map.kf_valid).sum())


def test_cpu_run_launches_no_kernel(runs):
    assert set(runs["launches"].values()) == {0}
