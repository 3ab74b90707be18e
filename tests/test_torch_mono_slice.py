"""The mono slice end to end: ``SlamSystem(settings, "mono")`` with the
reference's defaults (synchronous local mapping, the loop closer built
with the scale free, the per-frame driver), the JAX package's and the
port's, on ``tests/test_slam_e2e.py``'s ``mono_seq`` (320x240,
``make_sequence(n_frames=16, n_points=400, seed=7)``) on the CPU.

The port draws the reference's RANSAC samples
(``torch_carried_tracker.JaxSampler``: the two-view initialization's and
each relocalization's, key split by key split).  The reference initializes
at frame 1 (F), tracks frames 2-9, relocalizes at frame 9 and is lost from
frame 10 on; the loop closer closes nothing.

* From frame 0: the frame that initializes, the per-frame states, paths
  and keyframe counts are the reference's; every pose within POS_TOL_M
  (measured 8.7e-6 m) and the Sim3-aligned |dATE| within ATE_TOL_M.
* Carried from the reference's state after frame 0 (``carry_tracker``,
  which carries mono initialization's reference frame): frames 1-3 give
  the reference's initialization (keyframes, bindings and the map's
  integer fields equal) and poses within POS_TOL_M.
* ``TestMonoSlam.test_map_grows_and_saves``, on the port.
"""

import numpy as np
import pytest

from orbslam2_tpu.models.system import Sensor, SlamSystem as JSlamSystem
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem

from test_slam_e2e import small_settings
from torch_carried_tracker import JaxSampler, carry_tracker
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

POS_TOL_M = 1e-4
ROT_TOL_RAD = 1e-4
ATE_TOL_M = 1e-3
N_FRAMES = 16
CARRY_AT = 1  # after frame 0: the reference holds its initialization frame
CARRIED_TO = 4


def _rot_angle(R):
    R = np.asarray(R, np.float64)
    return float(np.arctan2(np.linalg.norm(R - R.T) / np.sqrt(2.0), np.trace(R) - 1.0))


def _record(system):
    tr = system.tracker
    return (int(tr.state), tr.metrics["track_path"], tr.metrics["keyframes_created"],
            int(np.asarray(tr.map.n_kf)))


@pytest.fixture(scope="module")
def runs():
    s = small_settings()
    seq = jsyn.make_sequence(s.camera_model(), n_frames=N_FRAMES, n_points=400, seed=7)
    ts = convert.settings_from_reference(s)
    ref = JSlamSystem(s, Sensor.MONOCULAR)
    port = SlamSystem(ts, "mono", device="cpu")
    port.tracker._ransac_samples = JaxSampler(ref.tracker.init_key)
    carried = SlamSystem(ts, "mono", device="cpu")
    logs = {"ref": [], "port": [], "carried": []}
    carried_T = []
    for i in range(N_FRAMES):
        if i == CARRY_AT:
            carry_tracker(ref, carried)
            assert carried.tracker.init_ref is not None
        for name, system in (("ref", ref), ("port", port)) + (
                (("carried", carried),) if CARRY_AT <= i < CARRIED_TO else ()):
            system.track_monocular(seq.images[i], seq.timestamps[i])
            logs[name].append(_record(system))
        if CARRY_AT <= i < CARRIED_TO:
            carried_T.append((np.asarray(ref.tracker.last_T), carried.tracker.last_T.numpy()))
    return dict(seq=seq, ref=ref, port=port, carried=carried, logs=logs, carried_T=carried_T)


def test_the_reference_initializes_and_tracks(runs):
    states = [r[0] for r in runs["logs"]["ref"]]
    assert states.index(1) == 1 and all(st == 1 for st in states[1:10])
    assert runs["ref"].loop_closer.fix_scale is False
    assert not runs["ref"].loop_closer.loop_edges


def test_from_frame_0_states_paths_keyframes(runs):
    ref, port = runs["logs"]["ref"], runs["logs"]["port"]
    assert port == ref
    assert port.index(next(r for r in port if r[0] == 1)) == 1  # the initializing frame
    assert runs["port"].tracker._ransac_samples.calls >= 2  # the init and a relocalization
    assert runs["port"].metrics()["n_loop_closures"] == 0
    assert runs["port"].loop_closer.fix_scale is False


def test_from_frame_0_poses_and_ate(runs):
    a, b = runs["ref"].poses_wc(), runs["port"].poses_wc()
    assert a.shape == b.shape == (N_FRAMES, 4, 4)
    dt = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
    dr = max(_rot_angle(x[:3, :3].T @ y[:3, :3]) for x, y in zip(a, b))
    assert dt <= POS_TOL_M and dr <= ROT_TOL_RAD, (dt, dr)
    gt = runs["seq"].poses_wc
    first = 1  # the frames from initialization on (mono has no scale)
    d_ate = abs(jsyn.ate_rmse(b[first:], gt[first:], with_scale=True)
                - jsyn.ate_rmse(a[first:], gt[first:], with_scale=True))
    assert d_ate <= ATE_TOL_M, d_ate
    for name in ("kf_valid", "kf_point", "kf_parent", "kf_frame_id", "n_kf", "pt_valid"):
        np.testing.assert_array_equal(getattr(runs["port"].map, name).numpy(),
                                      np.asarray(getattr(runs["ref"].map, name)), err_msg=name)


def test_carried_initialization(runs):
    assert runs["logs"]["carried"] == runs["logs"]["ref"][CARRY_AT:CARRIED_TO]
    for T_ref, T_port in runs["carried_T"]:
        a, b = np.linalg.inv(T_ref), np.linalg.inv(T_port)
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= POS_TOL_M
        assert _rot_angle(a[:3, :3].T @ b[:3, :3]) <= ROT_TOL_RAD
    assert runs["carried"].tracker._ransac_samples.calls >= 1


def test_map_grows_and_saves(runs, tmp_path):
    """TestMonoSlam.test_map_grows_and_saves on the port's run."""
    system, seq = runs["port"], runs["seq"]
    m = system.map
    assert int(m.n_kf) >= 2
    assert int(m.pt_valid.sum()) > 50
    p = tmp_path / "traj.txt"
    system.save_trajectory_tum(str(p))
    lines = p.read_text().strip().split("\n")
    assert len(lines) == seq.images.shape[0]
    assert len(lines[0].split()) == 8
    pk = tmp_path / "kf.txt"
    system.save_keyframe_trajectory_tum(str(pk))
    assert len(pk.read_text().strip().split("\n")) >= 2
    pkitti = tmp_path / "kitti.txt"
    system.save_trajectory_kitti(str(pkitti))
    assert len(pkitti.read_text().strip().split("\n")[0].split()) == 12
