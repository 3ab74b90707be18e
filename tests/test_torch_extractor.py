"""Extractor-stage parity against the JAX reference: settings, camera,
Lie ops, pyramid, blur, and the whole ORB extractor on a rendered bench
frame.

Tolerances:
* settings: equal field by field.
* camera / Lie ops: 1e-5 absolute (float32 arithmetic in another order);
  1e-3 px after the 8 fixed-point undistortion steps or a projection.
* mono frame (320x240): keypoints and descriptors exact, undistorted
  xy within 1e-4 px.
* pyramid levels: 2e-3 absolute on 0-255 intensities.  The reference's
  compiled resize sums the filter taps in another order than the port's
  two matmuls and the difference compounds level to level (measured max
  5.5e-4 at level 4 of the bench frame).
* blur: 1e-4 absolute (the reference's compiled tap loop rounds the
  multiply-adds differently; measured 4.6e-5).
* extractor: keypoints and descriptors bit for bit except where a
  pyramid difference tips a near-tie in keypoint ranking or in a BRIEF
  comparison; at most 1% of the 1000 keypoints may differ (measured 2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu.models import frame as jframe
from orbslam2_tpu.ops import extractor as jext
from orbslam2_tpu.ops import pyramid as jpyr
from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu.utils import camera as jcam
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import frame as tframe
from orbslam2_tpu_torch.ops import extractor as text
from orbslam2_tpu_torch.ops import pyramid as tpyr
from orbslam2_tpu_torch.solvers import lie as tlie
from orbslam2_tpu_torch.utils import camera as tcam
from orbslam2_tpu_torch.utils import synthetic as tsyn
from tests.test_camera_config import MATRIX_YAML, TUM1_YAML


def bench_settings():
    return Settings(
        camera=CameraSettings(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                              width=640, height=480, bf=40.0, th_depth=40.0),
        orb=OrbSettings(n_features=1000, n_levels=8),
        tpu=TpuSettings(max_keypoints=1024, max_keyframes=128, max_points=16384),
    )


@pytest.fixture(scope="module")
def bench_frame():
    cam = bench_settings().camera_model()
    world = jsyn.make_world(n_points=1500, seed=0)
    pose = jsyn.make_trajectory(24, radius=0.25, forward=0.5, seed=1)[5]
    return jsyn.render_frame(world, pose, cam, seed=105)


@pytest.mark.parametrize("yaml_text", [TUM1_YAML, MATRIX_YAML])
def test_settings_parse_like_the_reference(yaml_text):
    # The port's numpy copy of the settings parses a reference YAML to the
    # same values, and a reference Settings converts to the same object.
    ref = jconfig.Settings.from_yaml(yaml_text, sensor="rgbd")
    out = tconfig.Settings.from_yaml(yaml_text, sensor="rgbd")
    conv = convert.settings_from_reference(ref)
    for name in ("camera", "orb", "tpu"):
        want = dataclasses.asdict(getattr(ref, name))
        assert dataclasses.asdict(getattr(out, name)) == want
        assert dataclasses.asdict(getattr(conv, name)) == want
    assert out.sensor == conv.sensor == ref.sensor
    assert (out.rectification is None) == (ref.rectification is None)
    for k, v in (ref.rectification or {}).items():
        np.testing.assert_array_equal(out.rectification[k], v)
    assert out.camera_model() == conv.camera_model()


def test_camera_model_and_undistortion():
    dist = np.array([0.12, -0.05, 0.001, -0.002, 0.01], np.float32)
    jc = jcam.make_camera(400.0, 410.0, 320.0, 240.0, dist=dist, bf=30.0, width=640, height=480)
    tc = tcam.make_camera(400.0, 410.0, 320.0, 240.0, dist=dist, bf=30.0, width=640, height=480)
    for f in ("min_x", "max_x", "min_y", "max_y", "fx", "bf"):
        assert abs(float(getattr(jc, f)) - getattr(tc, f)) <= 1e-5 * max(1.0, abs(getattr(tc, f)))
    uv = np.random.default_rng(0).uniform(0, 480, (200, 2)).astype(np.float32)
    ref = np.asarray(jcam.undistort_points(jc, jnp.asarray(uv)))
    out = tcam.undistort_points(tc, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)  # pixels, 8 fixed-point steps
    inside = tcam.in_image(tc, torch.from_numpy(out)).numpy()
    np.testing.assert_array_equal(inside, np.asarray(jcam.in_image(jc, jnp.asarray(out))))
    depth = np.random.default_rng(1).uniform(0.5, 8.0, 200).astype(np.float32)
    p = tcam.backproject(tc, torch.from_numpy(out), torch.from_numpy(depth))
    np.testing.assert_allclose(
        p.numpy(), np.asarray(jcam.backproject(jc, jnp.asarray(out), jnp.asarray(depth))),
        atol=1e-5)
    np.testing.assert_allclose(tcam.project(tc, p).numpy(),
                               np.asarray(jcam.project(jc, jnp.asarray(p.numpy()))), atol=1e-3)
    np.testing.assert_allclose(tcam.project(tc, p).numpy(), out, atol=1e-3)


def test_mono_frame():
    cam = jcam.make_camera(320.0, 320.0, 160.0, 120.0, bf=32.0, width=320, height=240)
    img = jsyn.render_frame(jsyn.make_world(n_points=400, seed=3),
                            jsyn.make_trajectory(4, seed=4)[1], cam, seed=5)
    s = Settings(orb=OrbSettings(n_features=500, n_levels=4),
                 tpu=TpuSettings(max_keypoints=512))
    ps = convert.settings_from_reference(s)
    ref = jframe.build_mono_frame(img, jext.OrbExtractor(s.orb, s.tpu), cam)
    out = tframe.build_mono_frame(img, text.OrbExtractor(ps.orb, ps.tpu, device="cpu"),
                                  tcam.make_camera(320.0, 320.0, 160.0, 120.0, bf=32.0,
                                                   width=320, height=240))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.desc.numpy(), np.asarray(ref.desc).view(np.int32))
    np.testing.assert_allclose(out.xy.numpy(), np.asarray(ref.xy), atol=1e-4)
    assert (out.ur.numpy() == -1).all() and (out.depth.numpy() == -1).all()


def test_lie_ops():
    rng = np.random.default_rng(1)
    xi = (rng.normal(0, 0.3, (32, 6))).astype(np.float32)
    xi[0] = 0.0  # the small-angle branch
    T = np.array(jlie.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(tlie.se3_exp(torch.from_numpy(xi)).numpy(), T, atol=1e-5)
    np.testing.assert_allclose(tlie.se3_inverse(torch.from_numpy(T)).numpy(),
                               np.asarray(jlie.se3_inverse(jnp.asarray(T))), atol=1e-5)
    p = rng.normal(0, 2, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.se3_apply(torch.from_numpy(T), torch.from_numpy(p)).numpy(),
                               np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(p))),
                               atol=1e-5)
    drift = T.copy()
    drift[:, :3, :3] *= 1.001
    np.testing.assert_allclose(tlie.orthonormalize_se3(torch.from_numpy(drift)).numpy(),
                               np.asarray(jlie.orthonormalize_se3(jnp.asarray(drift))),
                               atol=1e-5)


def test_pyramid_and_blur(bench_frame):
    ref = jpyr.build_pyramid(jnp.asarray(bench_frame), 8, 1.2)
    out = tpyr.build_pyramid(torch.from_numpy(bench_frame), 8, 1.2)
    assert [tuple(o.shape) for o in out] == [tuple(r.shape) for r in ref]
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-3)
        np.testing.assert_allclose(
            tpyr.gaussian_blur(torch.from_numpy(np.array(r))).numpy(),
            np.asarray(jpyr.gaussian_blur(r)), atol=1e-4)
    assert tpyr.features_per_level(1000, 8, 1.2) == jpyr.features_per_level(1000, 8, 1.2)


def test_extractor_matches_on_the_bench_frame(bench_frame):
    s = bench_settings()
    ref = jext.OrbExtractor(s.orb, s.tpu)(bench_frame)
    ps = convert.settings_from_reference(s)
    out = text.OrbExtractor(ps.orb, ps.tpu, device="cpu")(bench_frame)

    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    np.testing.assert_array_equal(out.level.numpy(), np.asarray(ref.level))
    xy_diff = (out.xy.numpy() != np.asarray(ref.xy)).any(-1)
    desc_diff = (out.desc.numpy() != np.asarray(ref.desc).view(np.int32)).any(-1)
    n_bad = int((xy_diff | desc_diff)[valid].sum())
    assert valid.sum() == 1000
    assert n_bad <= 10, f"{n_bad} of 1000 keypoints differ"
    same = ~(xy_diff | desc_diff)
    np.testing.assert_allclose(out.angle.numpy()[same], np.asarray(ref.angle)[same], atol=1e-4)


def test_synthetic_copy_renders_the_same():
    cam_j = jcam.make_camera(320.0, 320.0, 160.0, 120.0, bf=32.0, width=320, height=240)
    cam_t = tcam.make_camera(320.0, 320.0, 160.0, 120.0, bf=32.0, width=320, height=240)
    ref = jsyn.make_sequence(cam_j, n_frames=3, n_points=200, with_depth=True, seed=2)
    out = tsyn.make_sequence(cam_t, n_frames=3, n_points=200, with_depth=True, seed=2)
    np.testing.assert_array_equal(out.images, ref.images)
    np.testing.assert_array_equal(out.depths, ref.depths)
    np.testing.assert_array_equal(out.poses_wc, ref.poses_wc)
