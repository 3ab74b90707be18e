"""Tracking-step parity: the port's pose optimizer, map updates and
tracking functions against the JAX reference, on a map that the JAX
tracker built and ``convert.py`` carried across.

Tolerances:
* poses: 1e-4 absolute per matrix entry — float32 LM over 40 iterations
  with reductions summed in another order (measured ~1e-6).
* integer outputs (bindings, local point ids, match and inlier counts,
  visibility counters): exact, since the poses agree far below any gate.
* map floats (positions, normals, scale bands): 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.models import tracking as jtr
from orbslam2_tpu.models.frame import build_rgbd_frame
from orbslam2_tpu.solvers import pose_opt as jpo
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import map_state as tms
from orbslam2_tpu_torch.models import tracking as ttr
from orbslam2_tpu_torch.solvers import pose_opt as tpo

T_ATOL = 1e-4


def small_settings():
    return Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0,
                              width=320, height=240, bf=32.0, th_depth=40.0),
        orb=OrbSettings(n_features=500, n_levels=4),
        tpu=TpuSettings(max_keypoints=512, max_keyframes=16, max_points=4096),
    )


def _np_tree(x):
    return jax.tree.map(np.array, x)


@pytest.fixture(scope="module")
def run():
    """Track frames 0-3 with the JAX tracker (mapping off), keeping numpy
    snapshots of the state after each frame and the JAX frame of each."""
    s = small_settings()
    cam = s.camera_model()
    seq = jsyn.make_sequence(cam, n_frames=10, n_points=800, with_depth=True, seed=0,
                             radius=0.25, forward=0.5)
    tr = jtr.Tracker(s, local_mapper=None, database=None, loop_closer=None)
    frames, snaps = [], []
    for i in range(4):
        frames.append(_np_tree(build_rgbd_frame(seq.images[i], seq.depths[i],
                                                tr.extractor, tr.cam, 1.0)))
        tr.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        snaps.append(dict(
            map=_np_tree(tr.map), last_frame=_np_tree(tr.last_frame),
            last_bindings=np.array(tr.last_bindings), last_T=np.array(tr.last_T),
            velocity=None if tr.velocity is None else np.array(tr.velocity),
            ref_kf=tr.ref_kf,
        ))
    port = ttr.Tracker(convert.settings_from_reference(s), device="cpu")
    return dict(s=s, tr=tr, port=port, frames=frames, snaps=snaps)


def _jmap(d):
    return jms.MapState(*[jnp.asarray(x) for x in d])


def _jframe(d):
    return type(d)(*[jnp.asarray(x) for x in d])


def _t(x):
    return convert.tensor_from_numpy(x, "cpu")


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def test_pose_optimization():
    rng = np.random.default_rng(3)
    n = 300
    cam = small_settings().camera_model()
    pcam = convert.settings_from_reference(small_settings()).camera_model()
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.05, -0.02, 0.1]
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 8, n)], -1).astype(np.float32)
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([320 * pc[:, 0] / pc[:, 2] + 160, 320 * pc[:, 1] / pc[:, 2] + 120], -1)
    ur = uv[:, 0] - 32.0 / pc[:, 2]
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    uv[:40] += rng.uniform(-30, 30, (40, 2)).astype(np.float32)  # outliers
    ur = np.where(rng.uniform(size=n) > 0.3, ur, -1.0).astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    T0 = np.eye(4, dtype=np.float32)
    arrays = (X, uv, ur, inv_s2, valid)
    ref = jpo.pose_optimization(jnp.asarray(T0), jpo.PoseObs(*map(jnp.asarray, arrays)), cam)
    out = tpo.pose_optimization(torch.from_numpy(T0), tpo.PoseObs(*map(torch.from_numpy, arrays)),
                                pcam)
    np.testing.assert_allclose(out.T_cw.numpy(), np.asarray(ref.T_cw), atol=T_ATOL)
    _eq(out.inlier, ref.inlier)
    assert int(out.n_inliers) == int(ref.n_inliers) >= 200
    np.testing.assert_allclose(out.chi2.numpy()[np.asarray(ref.inlier)],
                               np.asarray(ref.chi2)[np.asarray(ref.inlier)], rtol=1e-3, atol=1e-3)


def test_initial_map_from_depth(run):
    """The stereo-initialization map: unproject, add_points, insert_keyframe,
    update_point_stats — every pool array against the reference."""
    tr, port = run["tr"], run["port"]
    jf = _jframe(run["frames"][0])
    T0 = jnp.eye(4)
    m = jms.make_empty_map(16, 4096, 512)
    pos, ok = jtr.unproject_frame_depth(jf, T0, tr.cam)
    m, pids = jtr.add_points(m, pos, jf.desc, ok, jnp.int32(0), reverse=True)
    m, _ = jtr.insert_keyframe(m, jf, T0, jnp.int32(0), jnp.where(ok, pids, -1), jnp.int32(-1))
    m = jms.update_point_stats(m, jnp.asarray(tr.scale_factors))

    tf = convert.frame_from_numpy(run["frames"][0], "cpu")
    tm = tms.make_empty_map(16, 4096, 512, device="cpu")
    tpos, tok = ttr.unproject_frame_depth(tf, torch.eye(4), port.cam)
    tm, tpids = ttr.add_points(tm, tpos, tf.desc, tok, 0, reverse=True)
    tm, _ = ttr.insert_keyframe(tm, tf, torch.eye(4), 0, torch.where(tok, tpids, -1), -1)
    tm = tms.update_point_stats(tm, port.scale_factors)

    _eq(tpids, pids)
    ref = convert.map_state_from_numpy(_np_tree(m), "cpu")
    for name in tms.MapState._fields:
        a, b = getattr(tm, name), getattr(ref, name)
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            _eq(a, b)


def test_track_reference_keyframe(run):
    tr, port = run["tr"], run["port"]
    snap, jf = run["snaps"][0], _jframe(run["frames"][1])
    ref = jtr.track_reference_keyframe(
        _jmap(snap["map"]), jf, jnp.int32(snap["ref_kf"]), jnp.asarray(snap["last_T"]),
        jnp.asarray(tr.inv_sigma2), tr.cam)
    out = ttr.track_reference_keyframe(
        convert.map_state_from_numpy(snap["map"], "cpu"),
        convert.frame_from_numpy(run["frames"][1], "cpu"), snap["ref_kf"],
        _t(snap["last_T"]), port.inv_sigma2, port.cam)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=T_ATOL)
    for o, r in zip(out[1:], ref[1:]):
        _eq(o, r)
    assert int(ref[2]) >= 10  # passes the reference-KF tracking gate


def _motion_args(run, k):
    """Reference and port arguments of the motion model for frame k+1."""
    tr, port, snap = run["tr"], run["port"], run["snaps"][k]
    lf = snap["last_frame"]
    T_pred = snap["velocity"] @ snap["last_T"]
    common = dict(T_last=snap["last_T"], last_angle=lf.angle)
    jargs = (_jmap(snap["map"]), _jframe(run["frames"][k + 1]), jnp.asarray(T_pred),
             jnp.asarray(lf.xy), jnp.asarray(snap["last_bindings"]), jnp.asarray(lf.level),
             tr.cam, jnp.asarray(tr.scale_factors), jnp.asarray(tr.inv_sigma2))
    targs = (convert.map_state_from_numpy(snap["map"], "cpu"),
             convert.frame_from_numpy(run["frames"][k + 1], "cpu"), _t(T_pred),
             _t(lf.xy), _t(snap["last_bindings"]), _t(lf.level), port.cam,
             port.scale_factors, port.inv_sigma2)
    jkw = {k_: jnp.asarray(v) for k_, v in common.items()}
    tkw = {k_: _t(v) for k_, v in common.items()}
    temp = dict(last_depth=lf.depth, last_desc=lf.desc, last_valid=lf.valid)
    return jargs, targs, jkw, tkw, temp, tr._th_depth()


@pytest.mark.parametrize("gated_temp_sources", [False, True])
@pytest.mark.parametrize("radius", [7.0, 14.0])
def test_track_motion_model(run, gated_temp_sources, radius):
    # Frame 3 finds few matches in the 7 px window, so the tracker retries
    # at 14 px (the doubled window); both are compared.  The reference's
    # RGB-D chain also hands it the last frame's temporary VO sources,
    # gated off outside localization-only mode (which the port does not
    # have yet): with the gate off it must give the port's result.
    jargs, targs, jkw, tkw, temp, th_depth = _motion_args(run, 2)
    if gated_temp_sources:
        jkw.update({k: jnp.asarray(v) for k, v in temp.items()},
                   temp_depth_cap=th_depth, use_temp=jnp.asarray(False))
    cam = run["tr"].cam
    ref = jtr.track_motion_model(*jargs, jnp.float32(radius), baseline=cam.bf / cam.fx, **jkw)
    out = ttr.track_motion_model(*targs, radius, baseline=run["port"].cam.baseline, **tkw)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=T_ATOL)
    for o, r in zip(out[1:], ref[1:]):
        _eq(o, r)
    assert int(ref[3]) >= (20 if radius > 7.0 else 1)


def test_gather_local_points_and_track_local_map(run):
    tr, port, snap = run["tr"], run["port"], run["snaps"][2]
    jargs, targs, jkw, tkw, _, _ = _motion_args(run, 2)
    cam = tr.cam
    T, b, *_ = jtr.track_motion_model(*jargs, jnp.float32(14.0), baseline=cam.bf / cam.fx, **jkw)
    T, b = np.array(T), np.array(b)
    jm, tm = jargs[0], targs[0]
    ids, valid = jtr.gather_local_points(jm, jnp.asarray(b), n_local_kfs=80)
    tids, tvalid = ttr.gather_local_points(tm, _t(b), n_local_kfs=80)
    _eq(tids, ids)
    _eq(tvalid, valid)
    assert int(np.asarray(valid).sum()) > 100
    for rmult in (1.0, 2.0):
        ref = jtr.track_local_map(jm, jargs[1], jnp.asarray(T), jnp.asarray(b), ids, valid,
                                  cam, jnp.asarray(tr.scale_factors),
                                  jnp.asarray(tr.inv_sigma2), jnp.float32(rmult))
        out = ttr.track_local_map(tm, targs[1], _t(T), _t(b), tids, tvalid, port.cam,
                                  port.scale_factors, port.inv_sigma2, rmult)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=T_ATOL)
        _eq(out[1], ref[1])
        _eq(out[2], ref[2])
        _eq(out[3].pt_visible, ref[3].pt_visible)
        _eq(out[3].pt_found, ref[3].pt_found)
