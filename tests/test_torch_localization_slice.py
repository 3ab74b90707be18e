"""Localization-only mode end to end (``TestLocalizationMode`` of
``tests/test_aux.py`` in miniature): the JAX ``SlamSystem`` and the port's
on the CPU, 7 RGB-D frames of SLAM, then ``activate_localization_mode()``
and 7 more, on ``tests/test_slam_e2e.py``'s sequence (320x240, seed 11,
bf 32) with the close-depth threshold at 8 m, so that the last frame's
keypoints serve as temporary VO sources.  Then the visual-odometry path
(path 3) on the reference's carried state with most map points gone.

Tolerances: per-frame states, paths and keyframe counts exact; no keyframe
or point added in localization mode by either; per-frame positions and
rotations within 2e-4 (float32 pose optimization in another order);
|ATE_port - ATE_ref| <= 1e-3 m; on the carried VO frame, flags and
bindings exact and the pose within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.models.system import Sensor, SlamSystem as JSlamSystem
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.models.track_fused import _fused_track

from test_slam_e2e import small_settings
from torch_carried_tracker import carry_tracker
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

POS_TOL_M = 2e-4
ROT_TOL_RAD = 2e-4
ATE_TOL_M = 1e-3
N_SLAM = 7


def _rot_angle(R):
    """Angle of a rotation, in float64 (the arccos of a float32 trace cannot
    resolve angles below ~5e-4 rad)."""
    R = np.asarray(R, np.float64)
    return float(np.arctan2(np.linalg.norm(R - R.T) / np.sqrt(2.0), np.trace(R) - 1.0))


def _record(system):
    tr = system.tracker
    return (int(tr.state), tr.metrics["track_path"], tr.metrics["keyframes_created"],
            int(np.asarray(system.map.n_kf)), int(np.asarray(system.map.pt_valid).sum()))


@pytest.fixture(scope="module")
def runs():
    s = small_settings(bf=32.0, th_depth=80.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=14, n_points=400, with_depth=True,
                             seed=11)
    ref = JSlamSystem(s, Sensor.RGBD, enable_loop_closing=False)
    port = SlamSystem(convert.settings_from_reference(s), "rgbd", enable_loop_closing=False,
                      device="cpu")
    ref_log, port_log, snap = [], [], None
    for i in range(14):
        if i == N_SLAM:
            ref.activate_localization_mode()
            port.activate_localization_mode()
        if i == 13:
            snap = jax.tree.map(np.array, (ref.tracker.map, ref.tracker._make_ctx()))
        ref.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        port.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        ref_log.append(_record(ref))
        port_log.append(_record(port))
    return dict(s=s, seq=seq, ref=ref, port=port, ref_log=ref_log, port_log=port_log, snap=snap)


def test_states_paths_and_frozen_map(runs):
    ref_log, port_log = runs["ref_log"], runs["port_log"]
    assert port_log == ref_log
    assert all(r[0] == 1 for r in ref_log)
    frozen = ref_log[N_SLAM - 1][2:]
    assert all(r[2:] == frozen for r in ref_log[N_SLAM:]), "localization mode grew the map"
    assert runs["port"].localization_only and runs["port"].tracker.local_mapper is None


def test_poses_and_ate(runs):
    ref, out = runs["ref"].poses_wc(), runs["port"].poses_wc()
    assert out.shape == ref.shape == (14, 4, 4)
    dt = np.abs(out[:, :3, 3] - ref[:, :3, 3]).max(axis=1)
    dr = [_rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(out, ref)]
    assert dt.max() <= POS_TOL_M, dt
    assert max(dr) <= ROT_TOL_RAD, dr
    gt = runs["seq"].poses_wc
    assert abs(jsyn.ate_rmse(out, gt) - jsyn.ate_rmse(ref, gt)) <= ATE_TOL_M


def test_deactivate_restores_mapping(runs):
    port = SlamSystem(convert.settings_from_reference(runs["s"]), "rgbd",
                      enable_loop_closing=False, device="cpu")
    port.activate_localization_mode()
    assert port.tracker.local_mapper is None and port.tracker.localization_only
    port.deactivate_localization_mode()
    assert port.tracker.local_mapper is port.local_mapper
    assert not port.localization_only and not port.tracker.localization_only


def test_visual_odometry_frame_on_the_carried_state(runs):
    """Frame 13 with 90% of the map points gone: the map-anchored chain
    fails and the motion model's temporary sources carry the frame (path
    3), in both packages."""
    ref, port, seq = runs["ref"].tracker, runs["port"].tracker, runs["seq"]
    m, ctx = runs["snap"]
    assert bool(ctx.only_tracking)
    pt_valid = m.pt_valid.copy()
    live = np.nonzero(pt_valid)[0]
    pt_valid[live[len(live) // 10:]] = False
    m = m._replace(pt_valid=pt_valid)
    out_ref = ref._get_fused_step("rgbd")(jnp.asarray(seq.images[13]), jnp.asarray(seq.depths[13]),
                                          *jax.tree.map(jnp.asarray, (m, ctx)))
    flags = np.asarray(out_ref.flags)
    assert flags[0] == 1 and flags[3] == 3, flags  # OK through the VO path
    frame = convert.frame_from_numpy(jax.tree.map(np.array, out_ref.frame), "cpu")
    tpu = port.settings.tpu
    out = _fused_track(convert.map_state_from_numpy(m, "cpu"), frame,
                       convert.track_ctx_from_numpy(ctx, "cpu"), port.cam, port.scale_factors,
                       port.inv_sigma2, port._th_depth(), local_window=tpu.local_window,
                       kf_max_gap=tpu.kf_max_gap, kf_busy_frames=tpu.kf_busy_frames)
    np.testing.assert_array_equal(out.flags.numpy(), flags)
    np.testing.assert_array_equal(out.bindings.numpy(), np.asarray(out_ref.bindings))
    np.testing.assert_allclose(out.T_cw.numpy(), np.asarray(out_ref.T_cw), atol=1e-4)


def test_carry_tracker_round_trip(runs):
    """The carried tracker continues exactly where the reference stands."""
    port = SlamSystem(convert.settings_from_reference(runs["s"]), "rgbd",
                      enable_loop_closing=False, device="cpu")
    carry_tracker(runs["ref"], port)
    np.testing.assert_allclose(port.poses_wc(), runs["ref"].poses_wc(), atol=1e-6)
    assert port.tracker.ref_kf == runs["ref"].tracker.ref_kf
