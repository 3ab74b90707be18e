"""K1 parity: the port's plain FAST-9 + NMS (the CPU side of
csrc/fast_nms.cu) against the JAX reference, one level at a time and as
``fast_score_nms_levels`` over a pyramid with the extractor's threshold.

Tolerance: exact.  The score is built only from float32 subtraction,
negation, min and max, so every implementation must give the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import fast as jfast
from orbslam2_tpu.ops.pallas_kernels import fast_score_nms_pallas
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu.utils.camera import make_camera
from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.ops import fast as tfast
from orbslam2_tpu_torch.ops import pyramid as tpyr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _port(img: np.ndarray) -> np.ndarray:
    return tfast.fast_score_nms(torch.from_numpy(img)).numpy()


def _xla(img: np.ndarray) -> np.ndarray:
    return np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img))))


def _noise(h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


@pytest.mark.parametrize("hw", [(240, 320), (134, 179), (33, 129), (37, 130), (7, 7)])
def test_matches_both_reference_paths_on_noise(hw):
    img = _noise(*hw, seed=sum(hw))
    out = _port(img)
    np.testing.assert_array_equal(out, _xla(img))
    np.testing.assert_array_equal(out, np.asarray(fast_score_nms_pallas(jnp.asarray(img),
                                                                         interpret=True)))


def test_matches_both_reference_paths_on_a_rendered_pyramid():
    cam = make_camera(320.0, 320.0, 160.0, 120.0, bf=32.0, width=320, height=240)
    img = jsyn.render_frame(jsyn.make_world(n_points=400, seed=3),
                            jsyn.make_trajectory(4, seed=4)[1], cam, seed=5)
    levels = tpyr.build_pyramid(torch.from_numpy(img), 4, 1.2)
    n_corners = 0
    for lvl in levels:
        x = np.ascontiguousarray(lvl.numpy())
        out = _port(x)
        np.testing.assert_array_equal(out, _xla(x))
        np.testing.assert_array_equal(
            out, np.asarray(fast_score_nms_pallas(jnp.asarray(x), interpret=True)))
        n_corners += int((out > 0).sum())
    assert n_corners > 500


@pytest.mark.parametrize("seed", [0, 1])
def test_integer_images_follow_the_plain_nms_rule(seed):
    # Integer-valued images tie often.  The port (and its CUDA kernel)
    # follows ops/fast.nms3x3: a maximum is suppressed only by an EARLIER
    # neighbour that is itself a maximum of its own window.  The Pallas
    # kernel suppresses on any earlier equal neighbour, so it drops a few
    # extra corners here (recorded in ROADMAP Queue 3).
    img = np.random.default_rng(seed).integers(0, 256, (64, 96)).astype(np.float32)
    out = _port(img)
    np.testing.assert_array_equal(out, _xla(img))
    pallas = np.asarray(fast_score_nms_pallas(jnp.asarray(img), interpret=True))
    assert ((pallas > 0) & (out == 0)).sum() == 0  # Pallas keeps a subset


def test_zero_image():
    assert (_port(np.zeros((64, 128), np.float32)) == 0).all()


@pytest.fixture(scope="module")
def pyramid_and_references():
    """An 8-level pyramid of a rendered 320x240 frame and, per level, the
    JAX reference's unthresholded score by both of its paths."""
    cam = make_camera(320.0, 320.0, 160.0, 120.0, bf=32.0, width=320, height=240)
    img = jsyn.render_frame(jsyn.make_world(n_points=400, seed=3),
                            jsyn.make_trajectory(4, seed=4)[2], cam, seed=6)
    levels = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    refs = []
    for lvl in levels:
        x = np.ascontiguousarray(lvl.numpy())
        refs.append((_xla(x), np.asarray(fast_score_nms_pallas(jnp.asarray(x), interpret=True))))
    return levels, refs


@pytest.mark.parametrize("min_th", [0.0, 7.0])
def test_levels_in_one_call_match_the_plain_calls_and_both_reference_paths(
        pyramid_and_references, min_th):
    levels, refs = pyramid_and_references
    kernels.reset_launch_counts()
    out = tfast.fast_score_nms_levels(levels, min_th)
    assert kernels.LAUNCHES["fast_score_nms"] == 0
    assert len(out) == len(levels) == 8
    n_corners = n_cut = 0
    for lvl, got, (xla, pallas) in zip(levels, out, refs):
        plain = tfast.nms3x3(tfast.fast_score(lvl))
        plain = torch.where(plain >= min_th, plain, torch.zeros_like(plain))
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), np.where(xla >= min_th, xla, 0))
        np.testing.assert_array_equal(got.numpy(), np.where(pallas >= min_th, pallas, 0))
        n_corners += int((got > 0).sum())
        n_cut += int(((xla > 0) & (xla < min_th)).sum())
    assert n_corners > 500
    assert (n_cut > 0) == (min_th > 0)  # the threshold removes weak corners


def test_levels_of_any_shape_in_one_call_match_one_level_calls():
    # The card check's odd inputs, alone and mixed into one call.
    imgs = [_noise(33, 129, 1), _noise(7, 7, 2), _noise(48, 64, 3),
            np.random.default_rng(4).integers(0, 256, (40, 50)).astype(np.float32)]
    xs = [torch.from_numpy(x) for x in imgs]
    for min_th in (0.0, 7.0):
        mixed = tfast.fast_score_nms_levels(xs, min_th)
        for x, got in zip(xs, mixed):
            alone = tfast.fast_score_nms_levels([x], min_th)[0]
            assert torch.equal(got, alone)
        assert torch.equal(mixed[0], torch.where(tfast.fast_score_nms(xs[0]) >= min_th,
                                                 tfast.fast_score_nms(xs[0]), 0.0))


def test_more_levels_than_one_launch_takes_raise():
    x = torch.zeros(16, 16)
    assert len(tfast.fast_score_nms_levels([x] * kernels.FAST_MAX_LEVELS)) == 16
    for n in (0, kernels.FAST_MAX_LEVELS + 1, 32):
        with pytest.raises(ValueError, match="levels"):
            tfast.fast_score_nms_levels([x] * n)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fast_score_nms_levels_cuda([x])
    with pytest.raises(ValueError, match="meta"):
        tfast.fast_score_nms_levels([x, x.to("meta")])


def test_the_level_limit_is_the_kernels():
    src = (kernels._CSRC / "fast_nms.cu").read_text()
    assert f"constexpr int MAX_LEVELS = {kernels.FAST_MAX_LEVELS};" in src
