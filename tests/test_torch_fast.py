"""K1 parity: the port's plain FAST-9 + NMS (the CPU side of
csrc/fast_nms.cu) against the JAX reference.

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
from orbslam2_tpu_torch.ops import fast as tfast
from orbslam2_tpu_torch.ops import pyramid as tpyr


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
