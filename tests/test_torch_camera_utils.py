"""The port's camera functions against the reference's on the CPU:
``distort_normalized``, ``project`` with and without ``distort`` and
``project_stereo`` on seeded points through TUM1's distorted camera (rtol
1e-6, atol 1e-4 px), and the reference's ``TestCamera`` cases on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import Settings as JSettings
from orbslam2_tpu.utils import camera as jcam
from orbslam2_tpu_torch.config import Settings
from orbslam2_tpu_torch.utils import camera as cam_mod
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# TUM1.yaml, as tests/test_camera_config.py's TUM1_YAML.
TUM1_YAML = """%YAML:1.0
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _cams(dist=True):
    """The same camera in both packages."""
    out = []
    for settings, mod in ((JSettings, jcam), (Settings, cam_mod)):
        c = settings.from_yaml(TUM1_YAML).camera
        d = np.array([c.k1, c.k2, c.p1, c.p2, c.k3], np.float32) if dist else None
        out.append(mod.make_camera(c.fx, c.fy, c.cx, c.cy, dist=d, bf=c.bf, width=c.width,
                                   height=c.height))
    return out


def _points(n=257, seed=0):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                  rng.uniform(0.5, 6.0, n)], -1).astype(np.float32)
    p[0] = [0.0, 0.0, 1.0]
    return p


@pytest.mark.parametrize("dist", [True, False], ids=["distorted", "pinhole"])
def test_distort_normalized_matches_the_reference(dist):
    ref, port = _cams(dist)
    xn = np.random.default_rng(1).uniform(-0.6, 0.6, (300, 2)).astype(np.float32)
    want = np.asarray(jcam.distort_normalized(ref, jnp.asarray(xn)))
    got = cam_mod.distort_normalized(port, torch.from_numpy(xn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("distort", [True, False])
def test_project_matches_the_reference(distort):
    ref, port = _cams()
    p = _points()
    want = np.asarray(jcam.project(ref, jnp.asarray(p), distort=distort))
    got = cam_mod.project(port, torch.from_numpy(p), distort=distort).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    if not distort:
        # The default is the undistorted projection, as before.
        assert torch.equal(cam_mod.project(port, torch.from_numpy(p)), torch.from_numpy(got))


def test_project_stereo_matches_the_reference():
    ref, port = _cams(dist=False)
    p = _points(seed=2)
    want = np.asarray(jcam.project_stereo(ref, jnp.asarray(p)))
    got = cam_mod.project_stereo(port, torch.from_numpy(p)).numpy()
    assert got.shape == (len(p), 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


class TestCamera:
    """``tests/test_camera_config.py::TestCamera`` on the port."""

    def _cam(self, dist=True):
        return _cams(dist)[1]

    def test_project_backproject(self):
        cam = self._cam(dist=False)
        p = torch.tensor([[0.3, -0.2, 2.0], [0.0, 0.0, 1.0]])
        uv = cam_mod.project(cam, p)
        p2 = cam_mod.backproject(cam, uv, p[:, 2])
        np.testing.assert_allclose(p.numpy(), p2.numpy(), atol=1e-4)

    def test_undistort_roundtrip(self):
        cam = self._cam(dist=True)
        xn = torch.tensor([[0.1, 0.05], [-0.2, 0.15], [0.0, 0.0]])
        xd = cam_mod.distort_normalized(cam, xn)
        uv_dist = torch.stack([cam.fx * xd[:, 0] + cam.cx, cam.fy * xd[:, 1] + cam.cy], -1)
        uv_undist = cam_mod.undistort_points(cam, uv_dist, iters=20)
        uv_true = torch.stack([cam.fx * xn[:, 0] + cam.cx, cam.fy * xn[:, 1] + cam.cy], -1)
        np.testing.assert_allclose(uv_undist.numpy(), uv_true.numpy(), atol=0.1)

    def test_stereo_projection(self):
        cam = self._cam(dist=False)
        uvr = cam_mod.project_stereo(cam, torch.tensor([[0.5, 0.1, 2.0]]))
        assert uvr.shape == (1, 3)
        np.testing.assert_allclose(float(uvr[0, 0] - uvr[0, 2]), cam.bf / 2.0, rtol=1e-5)

    def test_image_bounds_no_distortion(self):
        cam = self._cam(dist=False)
        assert float(cam.min_x) == 0.0
        assert float(cam.max_x) == 640.0
