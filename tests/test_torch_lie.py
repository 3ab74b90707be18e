"""SO(3) / SE(3) logs of ``orbslam2_tpu_torch.solvers.lie`` against
``orbslam2_tpu.solvers.lie`` on the CPU, and ``TestSO3`` / ``TestSE3`` of
``tests/test_lie.py`` on the port.

Tolerances: ``vee`` exact; logs and the inverse left Jacobian within 1e-5
of the reference (float32 trigonometry in another library; near pi the
axis is defined up to sign, and the angle is compared instead).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu_torch.solvers import lie
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def random_rotations(n, rng, max_angle=np.pi - 0.2):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-max_angle, max_angle, size=(n, 1))
    return axis * angle


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_vee_is_the_reference(rng):
    M = rng.normal(size=(16, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(lie.vee(_t(M)).numpy(), np.asarray(jlie.vee(jnp.asarray(M))))


@pytest.mark.parametrize("max_angle", [1e-5, 0.5, np.pi - 0.2])
def test_so3_log_and_left_jacobian_inv(rng, max_angle):
    phi = random_rotations(64, rng, max_angle).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    np.testing.assert_allclose(lie.so3_log(_t(R)).numpy(), np.asarray(jlie.so3_log(jnp.asarray(R))),
                               atol=TOL)
    np.testing.assert_allclose(lie._left_jacobian_inv(_t(phi)).numpy(),
                               np.asarray(jlie._left_jacobian_inv(jnp.asarray(phi))), atol=TOL)


def test_so3_log_near_pi_and_identity():
    phi = np.array([[np.pi - 1e-5, 0, 0], [0, np.pi - 2e-4, 0], [0, 0, 0], [1e-9, 0, 0]],
                   np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    ref = np.asarray(jlie.so3_log(jnp.asarray(R)))
    out = lie.so3_log(_t(R)).numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), np.linalg.norm(ref, axis=-1), atol=TOL)
    np.testing.assert_allclose(np.abs(out), np.abs(ref), atol=TOL)


def test_se3_log_is_the_reference(rng):
    xi = np.concatenate([rng.normal(size=(32, 3)), random_rotations(32, rng, 2.5)],
                        -1).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(lie.se3_log(_t(T)).numpy(), np.asarray(jlie.se3_log(jnp.asarray(T))),
                               atol=TOL)


# -- TestSO3 / TestSE3 of tests/test_lie.py on the port ----------------------


class TestSO3:
    def test_exp_log_roundtrip(self, rng):
        phi = _t(random_rotations(64, rng))
        np.testing.assert_allclose(lie.so3_log(lie.so3_exp(phi)).numpy(), phi.numpy(), atol=2e-4)

    def test_orthonormal(self, rng):
        R = lie.so3_exp(_t(random_rotations(16, rng))).numpy()
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (16, 1, 1)),
                                   atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)

    def test_small_angle(self):
        R = lie.so3_exp(_t([[1e-9, 0, 0], [0.0, 0.0, 0.0]]))
        np.testing.assert_allclose(R[1].numpy(), np.eye(3), atol=1e-7)
        assert torch.isfinite(lie.so3_log(R)).all()

    def test_near_pi(self):
        phi2 = lie.so3_log(lie.so3_exp(_t([[np.pi - 1e-5, 0.0, 0.0]])))
        np.testing.assert_allclose(float(torch.linalg.norm(phi2)), np.pi - 1e-5, atol=1e-3)


class TestSE3:
    def test_exp_log_roundtrip(self, rng):
        xi = _t(np.concatenate([rng.normal(size=(32, 3)), random_rotations(32, rng, 2.5)], -1))
        np.testing.assert_allclose(lie.se3_log(lie.se3_exp(xi)).numpy(), xi.numpy(), atol=5e-4)

    def test_inverse(self, rng):
        T = lie.se3_exp(_t(rng.normal(size=(8, 6)) * 0.5))
        np.testing.assert_allclose((T @ lie.se3_inverse(T)).numpy(), np.tile(np.eye(4), (8, 1, 1)),
                                   atol=1e-5)

    def test_apply(self):
        T = lie.se3_exp(_t([1.0, 2.0, 3.0, 0, 0, 0]))
        np.testing.assert_allclose(lie.se3_apply(T, _t([1.0, 1.0, 1.0])).numpy(), [2.0, 3.0, 4.0],
                                   atol=1e-6)
