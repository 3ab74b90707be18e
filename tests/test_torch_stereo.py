"""Stereo matching and the stereo frame against the JAX package, on a
rendered pair of ``tests/test_slam_e2e.py::TestStereoSlam``'s sequence
(320x240, 800 features, 4 levels, bf 160, baseline 0.5, seed 13).

The JAX extractor's left and right ``Features`` are carried into the port,
so extraction near-ties stay out of the matching comparison.

Tolerances:
* ``compute_stereo_matches``: the matched sets may differ in at most 1%
  of the left keypoints (measured: none differ on frames 0-2); where both
  match, ur within 1e-3 px and depth within 1e-3 (measured 3.1e-05 px):
  the SAD sums run in another order.
* ``_subpixel_refine`` at seeded positions near the image border, where
  the bilinear clamps apply: within 1e-4 px.
* ``build_stereo_frame`` with each package's own extractor: keypoints and
  descriptors bit for bit except near-ties, at most 1% of the keypoints
  (``tests/test_torch_extractor.py``'s bound); ur as above on the
  keypoints that agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import frame as jframe
from orbslam2_tpu.ops import extractor as jext
from orbslam2_tpu.ops import pyramid as jpyr
from orbslam2_tpu.ops import stereo as jstereo
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert, kernels
from orbslam2_tpu_torch.models import frame as tframe
from orbslam2_tpu_torch.ops import extractor as text
from orbslam2_tpu_torch.ops import stereo as tstereo
from tests.test_slam_e2e import small_settings
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

UR_TOL_PX = 1e-3
REFINE_TOL_PX = 1e-4


@pytest.fixture(scope="module")
def setup():
    s = small_settings(bf=160.0)
    cam = s.camera_model()
    seq = jsyn.make_sequence(cam, n_frames=3, n_points=400, stereo_baseline=0.5, seed=13,
                             radius=0.4, forward=0.8)
    sf = np.asarray(jpyr.scale_factors(s.orb.n_levels, s.orb.scale_factor), np.float32)
    return dict(s=s, cam=cam, seq=seq, sf=sf, ext=jext.OrbExtractor(s.orb, s.tpu))


def _features(f):
    return text.Features(**{k: convert.tensor_from_numpy(np.asarray(v), "cpu")
                            for k, v in f._asdict().items()})


def _compare_ur(ur_out, ur_ref, depth_out, depth_ref, n_keypoints):
    m_out, m_ref = ur_out >= 0, ur_ref >= 0
    assert (m_out != m_ref).sum() <= 0.01 * n_keypoints
    both = m_out & m_ref
    assert both.sum() >= 100
    np.testing.assert_allclose(ur_out[both], ur_ref[both], atol=UR_TOL_PX)
    np.testing.assert_allclose(depth_out[both], depth_ref[both], atol=1e-3)
    assert (depth_out[~m_out] == -1).all()


@pytest.mark.parametrize("f", [0, 1, 2])
def test_compute_stereo_matches(setup, f):
    left, right = setup["seq"].images[f]
    fl, fr = setup["ext"](jnp.asarray(left)), setup["ext"](jnp.asarray(right))
    ur_ref, d_ref = (np.asarray(x) for x in jstereo.compute_stereo_matches(
        fl, fr, jnp.asarray(left), jnp.asarray(right), setup["sf"], setup["cam"].bf))
    kernels.reset_launch_counts()
    ur, depth = tstereo.compute_stereo_matches(
        _features(fl), _features(fr), torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(setup["sf"]), float(setup["cam"].bf))
    assert set(kernels.LAUNCHES.values()) == {0}
    _compare_ur(ur.numpy(), ur_ref, depth.numpy(), d_ref, int(np.asarray(fl.valid).sum()))


def test_subpixel_refine_near_the_border(setup):
    left, right = setup["seq"].images[0]
    h, w = left.shape
    rng = np.random.default_rng(5)
    n = 256
    near = rng.uniform(-4, 10, n)
    xl = np.where(rng.uniform(size=n) < 0.5, near, w - 1 - near).astype(np.float32)
    yl = np.where(rng.uniform(size=n) < 0.5, rng.uniform(-4, 10, n),
                  rng.uniform(0, h - 1, n)).astype(np.float32)
    xr0 = (xl - rng.uniform(0, 30, n)).astype(np.float32)
    step = setup["sf"][rng.integers(0, len(setup["sf"]), n)]
    ref = np.asarray(jstereo._subpixel_refine(jnp.asarray(left), jnp.asarray(right),
                                              *(jnp.asarray(a) for a in (xl, yl, xr0, step))))
    out = tstereo._subpixel_refine(torch.from_numpy(left), torch.from_numpy(right),
                                   *(torch.from_numpy(a) for a in (xl, yl, xr0, step)))
    np.testing.assert_allclose(out.numpy(), ref, atol=REFINE_TOL_PX)


def test_build_stereo_frame(setup):
    s, cam = setup["s"], setup["cam"]
    left, right = setup["seq"].images[1]
    ref = jframe.build_stereo_frame(left, right, setup["ext"], cam, setup["sf"])
    ps = convert.settings_from_reference(s)
    out = tframe.build_stereo_frame(
        torch.from_numpy(left), torch.from_numpy(right),
        text.OrbExtractor(ps.orb, ps.tpu, device="cpu"), ps.camera_model(),
        torch.from_numpy(setup["sf"]))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    np.testing.assert_array_equal(out.level.numpy(), np.asarray(ref.level))
    same = ((out.xy.numpy() == np.asarray(ref.xy)).all(-1)
            & (out.desc.numpy() == np.asarray(ref.desc).view(np.int32)).all(-1))
    assert (~same)[valid].sum() <= 0.01 * valid.sum()
    keep = same & valid
    _compare_ur(out.ur.numpy()[keep], np.asarray(ref.ur)[keep],
                out.depth.numpy()[keep], np.asarray(ref.depth)[keep], int(valid.sum()))
