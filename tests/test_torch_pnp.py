"""PnP RANSAC and Horn's closed form: ``orbslam2_tpu_torch.ops.pnp`` /
``ops.sim3_solve`` against ``orbslam2_tpu.ops.pnp`` / ``ops.sim3_solve`` on
the CPU.

The RANSAC samples are the reference's: ``jax.random.choice`` with the
reference's weights, drawn here from the same key and passed to the port
through ``samples``.  Tolerances: the best hypothesis's inlier mask, its
inlier count and ``ok`` exact; its pose within T_TOL = 1e-4 (Jacobi
rotations where the reference calls ``eigh``, SVD and the Durand-Kerner
iteration in another library); Horn's R, t and s within 1e-5.

P3P's quartic often has a near-double root, where float32 rounding
(XLA fuses multiply-adds, torch does not) moves the root by about the
square root of the rounding: minimal-sample poses then agree within
P3P_TOL = 1e-3 (measured 3.9e-4) and, on a planar scene, the best
hypothesis within RAW_TOL = 5e-3 (measured 4.4e-3) with the same inliers.
What relocalization uses is that hypothesis after the pose polish: polished
from either, the poses agree within T_TOL.  The rest mirrors ``TestPnp`` of
``tests/test_loop_components.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import pnp as jpnp
from orbslam2_tpu.ops import sim3_solve as jsim3
from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu.utils.camera import make_camera as jmake_camera
from orbslam2_tpu_torch.ops import pnp as tpnp
from orbslam2_tpu_torch.ops import sim3_solve as tsim3
from orbslam2_tpu_torch.utils.camera import make_camera
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T_TOL = 1e-4
P3P_TOL = 1e-3
RAW_TOL = 5e-3
JCAM = jmake_camera(320.0, 320.0, 160.0, 120.0, width=320, height=240)
CAM = make_camera(320.0, 320.0, 160.0, 120.0, width=320, height=240)


@functools.partial(jax.jit, static_argnames=("iters", "k"))
def jax_samples(key, valid, iters, k):
    """The reference's draw (pnp.py: p3p_ransac / pnp_ransac)."""
    w = valid.astype(jnp.float32)
    p = w / jnp.maximum(w.sum(), 1.0)
    return jax.random.choice(key, valid.shape[0], shape=(iters, k), replace=True, p=p)


def scene(rng, n=200, outliers=0.3, planar=False):
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  np.full(n, 6.0) if planar else rng.uniform(4, 9, n)], -1).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray([0.3, -0.2, 0.4, 0.1, -0.15, 0.05], jnp.float32)))
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([320 * pc[:, 0] / pc[:, 2] + 160, 320 * pc[:, 1] / pc[:, 2] + 120], -1)
    uv = (uv + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    idx = rng.choice(n, int(n * outliers), replace=False)
    uv[idx] += rng.uniform(30, 100, (len(idx), 2)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    inv_s2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], n).astype(np.float32)
    return uv, X, valid, inv_s2, T, idx


def _compare(out, ref, atol=T_TOL):
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.n_inliers) == int(ref.n_inliers)
    assert bool(out.ok) == bool(ref.ok)
    np.testing.assert_allclose(out.T_cw.numpy(), np.asarray(ref.T_cw), atol=atol)


def _polish(T, uv, X, valid, inv_s2):
    from orbslam2_tpu_torch.solvers.pose_opt import PoseObs, pose_optimization

    obs = PoseObs(points_w=torch.from_numpy(X), uv=torch.from_numpy(uv),
                  ur=torch.full((len(uv),), -1.0), inv_sigma2=torch.from_numpy(inv_s2),
                  valid=torch.from_numpy(valid))
    return pose_optimization(torch.as_tensor(np.asarray(T)), obs, CAM).T_cw.numpy()


def _run_both(fn_j, fn_t, k, uv, X, valid, inv_s2, seed, iters):
    key = jax.random.PRNGKey(seed)
    ref = fn_j(jnp.asarray(uv), jnp.asarray(X), jnp.asarray(valid), jnp.asarray(inv_s2), JCAM,
               key, iters=iters)
    samples = torch.from_numpy(np.array(jax_samples(key, jnp.asarray(valid), iters, k)))
    out = fn_t(torch.from_numpy(uv), torch.from_numpy(X), torch.from_numpy(valid),
               torch.from_numpy(inv_s2), CAM, iters=iters, samples=samples)
    return ref, out


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_p3p_ransac_with_the_reference_samples(planar, seed):
    uv, X, valid, inv_s2, _, _ = scene(np.random.default_rng(seed), planar=planar)
    ref, out = _run_both(jpnp.p3p_ransac, tpnp.p3p_ransac, 4, uv, X, valid, inv_s2, seed, 256)
    assert bool(ref.ok)
    _compare(out, ref, RAW_TOL if planar else T_TOL)
    np.testing.assert_allclose(_polish(out.T_cw, uv, X, valid, inv_s2),
                               _polish(ref.T_cw, uv, X, valid, inv_s2), atol=T_TOL)


@pytest.mark.parametrize("seed", [0, 2])
def test_pnp_ransac_with_the_reference_samples(seed):
    uv, X, valid, inv_s2, _, _ = scene(np.random.default_rng(seed), outliers=0.15)
    ref, out = _run_both(jpnp.pnp_ransac, tpnp.pnp_ransac, 6, uv, X, valid, inv_s2, seed, 128)
    assert bool(ref.ok)
    _compare(out, ref)


@pytest.mark.parametrize("fn, k", [("p3p_ransac", 4), ("pnp_ransac", 6)])
def test_no_valid_correspondence_gives_not_ok(fn, k):
    uv, X, _, inv_s2, _, _ = scene(np.random.default_rng(3))
    valid = np.zeros(len(uv), bool)
    ref, out = _run_both(getattr(jpnp, fn), getattr(tpnp, fn), k, uv, X, valid, inv_s2, 3, 64)
    assert not bool(ref.ok) and not bool(out.ok)
    assert int(out.n_inliers) == int(ref.n_inliers) == 0
    # Drawn from the port's own generator: no error, index 0 everywhere.
    g = torch.Generator().manual_seed(0)
    res = getattr(tpnp, fn)(torch.from_numpy(uv), torch.from_numpy(X), torch.from_numpy(valid),
                            torch.from_numpy(inv_s2), CAM, generator=g, iters=64)
    assert not bool(res.ok)
    assert torch.equal(tpnp.draw_samples(torch.from_numpy(valid), 64, k, g),
                       torch.zeros(64, k, dtype=torch.int64))


def test_draw_samples_takes_valid_entries_only():
    valid = torch.from_numpy(np.random.default_rng(0).uniform(size=500) > 0.7)
    g = torch.Generator().manual_seed(0)
    s = tpnp.draw_samples(valid, 4096, 4, g)
    assert s.shape == (4096, 4) and s.dtype == torch.int64
    assert bool(valid[s].all())
    # Every valid entry is reachable and the draw is uniform-ish.
    counts = torch.bincount(s.reshape(-1), minlength=500)[valid]
    assert int((counts > 0).sum()) == int(valid.sum())
    again = tpnp.draw_samples(valid, 4096, 4, torch.Generator().manual_seed(0))
    assert torch.equal(s, again)
    one = torch.zeros(500, dtype=torch.bool)
    one[123] = True
    assert bool((tpnp.draw_samples(one, 32, 4, g) == 123).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p3p_poses_on_minimal_samples(seed):
    rng = np.random.default_rng(seed)
    uv, X, _, _, _, _ = scene(rng, n=4, outliers=0.0)
    xn = np.stack([(uv[:, 0] - 160) / 320, (uv[:, 1] - 120) / 320], -1).astype(np.float32)
    Ts_r, ok_r, err_r = jpnp._p3p_poses(jnp.asarray(xn), jnp.asarray(X))
    Ts_p, ok_p, err_p = tpnp._p3p_poses(torch.from_numpy(xn)[None], torch.from_numpy(X)[None])
    np.testing.assert_array_equal(ok_p[0].numpy(), np.asarray(ok_r))
    ok = np.asarray(ok_r)
    assert ok.any()
    np.testing.assert_allclose(Ts_p[0].numpy()[ok], np.asarray(Ts_r)[ok], atol=P3P_TOL)
    assert int(np.argmin(np.asarray(err_r))) == int(torch.argmin(err_p[0]))


def test_quartic_roots():
    rng = np.random.default_rng(0)
    coeffs = rng.normal(size=(64, 5)).astype(np.float32)
    ref = np.asarray(jpnp._quartic_roots_dk(jnp.asarray(coeffs)))
    out = tpnp._quartic_roots_dk(torch.from_numpy(coeffs)).numpy()
    assert out.dtype == np.complex64
    # The same roots in the same slots (the start points are the same).
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    p = np.polynomial.polynomial.polyval
    resid = np.abs([p(out[i], coeffs[i, ::-1].astype(np.complex128)) for i in range(64)])
    assert resid.max() < 1e-3 * np.abs(coeffs).max()


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3(fix_scale):
    rng = np.random.default_rng(4)
    p2 = np.stack([rng.uniform(-2, 2, 80), rng.uniform(-2, 2, 80),
                   rng.uniform(3, 8, 80)], -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.3, -0.2], jnp.float32)))
    p1 = (1.4 * p2 @ R.T + np.array([0.5, -0.3, 0.8]) + rng.normal(0, 0.01, (80, 3)))
    p1 = p1.astype(np.float32)
    Rr, tr, sr = jsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), fix_scale=fix_scale)
    Rp, tp, sp = tsim3.horn_sim3(torch.from_numpy(p1), torch.from_numpy(p2), fix_scale)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tr), atol=1e-5)
    np.testing.assert_allclose(float(sp), float(sr), atol=1e-5)
    # Batched: each problem solved on its own.
    Rb, tb, sb = tsim3.horn_sim3(torch.from_numpy(np.stack([p1, p1[::-1].copy()])),
                                 torch.from_numpy(np.stack([p2, p2[::-1].copy()])), fix_scale)
    np.testing.assert_allclose(Rb[1].numpy(), Rp.numpy(), atol=1e-5)


# -- TestPnp of tests/test_loop_components.py on the port --------------------


class TestPnp:
    def test_recovers_pose_with_outliers(self, rng):
        uv, X, _, _, T_gt, out_idx = scene(rng)
        res = tpnp.pnp_ransac(torch.from_numpy(uv), torch.from_numpy(X),
                              torch.ones(len(uv), dtype=torch.bool), torch.ones(len(uv)), CAM,
                              generator=torch.Generator().manual_seed(0))
        assert bool(res.ok)
        d = res.T_cw.numpy() @ np.linalg.inv(T_gt)
        rot = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        assert rot < 2.0 and np.linalg.norm(d[:3, 3]) < 0.1, (rot, d[:3, 3])
        assert res.inliers.numpy()[out_idx].mean() < 0.15

    def test_p3p_recovers_a_planar_pose(self, rng):
        uv, X, _, _, T_gt, out_idx = scene(rng, planar=True)
        res = tpnp.p3p_ransac(torch.from_numpy(uv), torch.from_numpy(X),
                              torch.ones(len(uv), dtype=torch.bool), torch.ones(len(uv)), CAM,
                              generator=torch.Generator().manual_seed(0))
        assert bool(res.ok)
        d = res.T_cw.numpy() @ np.linalg.inv(T_gt)
        assert np.linalg.norm(d[:3, 3]) < 0.1
        assert res.inliers.numpy()[out_idx].mean() < 0.15

    def test_degenerate_fails_gracefully(self, rng):
        uv = torch.from_numpy(rng.uniform(0, 300, (50, 2)).astype(np.float32))
        X = torch.from_numpy(rng.uniform(-3, 3, (50, 3)).astype(np.float32))
        res = tpnp.pnp_ransac(uv, X, torch.zeros(50, dtype=torch.bool), torch.ones(50), CAM,
                              generator=torch.Generator().manual_seed(1))
        assert not bool(res.ok)


def test_overflowing_samples_are_rejected_without_error():
    # Points far enough out that the P3P arithmetic overflows: Horn's
    # matrix is not finite for those samples, the reference's eigh returns
    # NaN and so do the port's Jacobi rotations, without an error, and both
    # reject the hypotheses.
    uv, X, valid, inv_s2, _, _ = scene(np.random.default_rng(5), n=64)
    X[::3] *= np.float32(1e19)
    ref, out = _run_both(jpnp.p3p_ransac, tpnp.p3p_ransac, 4, uv, X, valid, inv_s2, 5, 256)
    assert bool(out.ok) == bool(ref.ok)
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    N = torch.full((2, 3, 3), float("inf"))
    R, t, s = tsim3.horn_sim3(N, torch.ones(2, 3, 3), fix_scale=True)
    assert R.shape == (2, 3, 3) and torch.isnan(R).all()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_top_eigenvector_sym4_is_eighs(scale):
    rng = np.random.default_rng(int(scale * 10) + 1)
    M = rng.normal(size=(4096, 4, 4)) * scale
    A = (M + M.transpose(0, 2, 1)).astype(np.float32)
    w, V = np.linalg.eigh(A.astype(np.float64))
    v = tsim3.top_eigenvector_sym4(torch.from_numpy(A)).numpy()
    sep = (w[:, -1] - w[:, -2]) > 1e-2 * scale
    err = np.minimum(np.abs(v - V[..., -1]).max(-1), np.abs(v + V[..., -1]).max(-1))
    assert err[sep].max() < 1e-4
    Av = np.einsum("nij,nj->ni", A.astype(np.float64), v)
    np.testing.assert_allclose(np.einsum("ni,ni->n", v, Av), w[:, -1], rtol=1e-5, atol=1e-5 * scale)
    # Equal eigenvalues: the first coordinate vector.
    eye = tsim3.top_eigenvector_sym4(torch.eye(4).expand(3, 4, 4) * 2.0)
    assert torch.equal(eye, torch.tensor([1.0, 0, 0, 0]).expand(3, 4))
