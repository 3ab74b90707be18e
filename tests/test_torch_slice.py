"""The RGB-D tracking slice end to end: the JAX tracker with mapping, loop
closing and the BoW database off, against the port on the CPU, frame by
frame, on a 10-frame synthetic sequence at 320x240.

Tolerances: per-frame state, tracking path and keyframe count exact;
per-frame poses within 1e-3 m and 1e-3 rad (float32 pose optimization
summed in another order; measured under 1e-5 m).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu.models.tracking import Tracker
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.models.track_fused import _fused_track

POS_TOL_M = 1e-3
ROT_TOL_RAD = 1e-3


def small_settings():
    return Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0,
                              width=320, height=240, bf=32.0, th_depth=40.0),
        orb=OrbSettings(n_features=500, n_levels=4),
        tpu=TpuSettings(max_keypoints=512, max_keyframes=16, max_points=4096),
    )


def _rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _record(tracker):
    m = tracker.metrics
    return (tracker.state, m["track_path"], m["keyframes_created"])


@pytest.fixture(scope="module")
def runs():
    s = small_settings()
    seq = jsyn.make_sequence(s.camera_model(), n_frames=10, n_points=800,
                             with_depth=True, seed=0, radius=0.25, forward=0.5)
    ref = Tracker(s, local_mapper=None, database=None, loop_closer=None)
    port = SlamSystem(convert.settings_from_reference(s), "rgbd",
                      enable_mapping=False, enable_loop_closing=False, device="cpu")
    ref_log, port_log = [], []
    for i in range(len(seq.images)):
        ref.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        port.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        ref_log.append(_record(ref))
        port_log.append(_record(port.tracker))
    return dict(seq=seq, ref=ref, port=port, ref_log=ref_log, port_log=port_log)


def test_per_frame_state_path_and_keyframes(runs):
    assert runs["port_log"] == runs["ref_log"]
    assert all(state == 1 for state, _, _ in runs["ref_log"])
    assert runs["ref_log"][-1][2] >= 1  # the slice inserts keyframes


def test_per_frame_poses(runs):
    ref = runs["ref"].poses_wc()
    out = runs["port"].poses_wc()
    assert out.shape == ref.shape == (10, 4, 4)
    dt = np.abs(out[:, :3, 3] - ref[:, :3, 3]).max(axis=1)
    dr = [_rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(out, ref)]
    assert dt.max() <= POS_TOL_M, dt
    assert max(dr) <= ROT_TOL_RAD, dr
    gt = runs["seq"].poses_wc
    assert jsyn.ate_rmse(out, gt) < 0.02
    assert abs(jsyn.ate_rmse(out, gt) - jsyn.ate_rmse(ref, gt)) < 1e-3


def test_map_and_metrics(runs):
    ref_map, port = runs["ref"].map, runs["port"]
    assert int(port.map.n_kf) == int(ref_map.n_kf)
    assert int(port.map.pt_valid.sum()) == int(np.asarray(ref_map.pt_valid).sum())
    m = port.metrics()
    assert m["frames"] == 9 and m["frames_lost"] == 0
    assert m["n_keyframes"] == int(ref_map.n_kf)
    assert 0 < m["host_syncs"] <= 6 * 10


def test_fused_track_on_the_carried_state(runs):
    """One more frame through both Track() chains, the port's started from
    the reference tracker's state carried across by convert.py (its map,
    its frame and its context)."""
    ref, seq = runs["ref"], runs["seq"]
    step = ref._get_fused_step("rgbd")  # the reference's compiled program
    state = jax.tree.map(np.array, (ref.map, ref._make_ctx()))
    out_ref = step(jnp.asarray(seq.images[-1]), jnp.asarray(seq.depths[-1]),
                   *jax.tree.map(jnp.asarray, state))
    port = runs["port"].tracker
    m = convert.map_state_from_numpy(state[0], "cpu")
    ctx = convert.track_ctx_from_numpy(state[1], "cpu")
    own = port._make_ctx()
    for name in ("last_bindings", "last_level"):
        np.testing.assert_array_equal(getattr(ctx, name).numpy(), getattr(own, name).numpy())
    for name in ("last_xy", "last_angle", "T_last", "velocity"):
        np.testing.assert_allclose(getattr(ctx, name).numpy(), getattr(own, name).numpy(),
                                   atol=1e-4)
    assert (ctx.ref_kf, ctx.weak, ctx.frames_since_kf, ctx.has_velocity) == (
        own.ref_kf, own.weak, own.frames_since_kf, own.has_velocity)
    frame = convert.frame_from_numpy(jax.tree.map(np.array, out_ref.frame), "cpu")
    tpu = port.settings.tpu
    out = _fused_track(m, frame, ctx, port.cam, port.scale_factors, port.inv_sigma2,
                       port._th_depth(), local_window=tpu.local_window,
                       kf_max_gap=tpu.kf_max_gap, kf_busy_frames=tpu.kf_busy_frames)
    np.testing.assert_array_equal(out.flags.numpy(), np.asarray(out_ref.flags))
    np.testing.assert_array_equal(out.bindings.numpy(), np.asarray(out_ref.bindings))
    np.testing.assert_array_equal(out.m.pt_visible.numpy(), np.asarray(out_ref.m.pt_visible))
    np.testing.assert_array_equal(out.m.pt_found.numpy(), np.asarray(out_ref.m.pt_found))
    for name in ("T_cw", "T_cr", "velocity"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(out_ref, name)),
                                   atol=1e-4)


def test_a_localization_only_context_is_refused(runs):
    ctx = jax.tree.map(np.array, runs["ref"]._make_ctx())
    convert.track_ctx_from_numpy(ctx, "cpu")
    with pytest.raises(NotImplementedError, match="localization-only"):
        convert.track_ctx_from_numpy(ctx._replace(only_tracking=np.array(True)), "cpu")


def test_trajectory_savers(runs, tmp_path):
    port = runs["port"]
    poses = port.poses_wc()
    port.save_trajectory_tum(str(tmp_path / "traj.txt"))
    port.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    port.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    tum = np.loadtxt(tmp_path / "traj.txt")
    assert tum.shape == (10, 8)
    np.testing.assert_allclose(tum[:, 1:4], poses[:, :3, 3], atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:], axis=1), 1.0, atol=1e-5)
    kitti = np.loadtxt(tmp_path / "kitti.txt")
    np.testing.assert_allclose(kitti.reshape(10, 3, 4), poses[:, :3, :4], atol=1e-6)
    kf = np.loadtxt(tmp_path / "kf.txt", ndmin=2)
    assert kf.shape == (int(port.map.n_kf), 8)
