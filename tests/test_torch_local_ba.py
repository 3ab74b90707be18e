"""Local bundle adjustment of the port on the CPU against the reference.

The map is carried across from the reference tracker (14 frames, 10
keyframes; ``torch_carried_map``).  The reference's CPU path builds its
blocks with einsums, the port's with K4/K5's plain versions and the packed
scatter tail, so sums are taken in another order: poses agree within
POSE_TOL (measured: 3.3e-5) and points within PT_TOL + PT_RTOL |X|
(measured: 1.6e-3 m at 7.7 m, a far point with a short baseline that BA
moved by 0.75 m), and the inlier masks, hence the outlier unbinding in
``kf_point``, are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import local_mapping as jlm
from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu.solvers import local_ba as jlb
from orbslam2_tpu.utils.camera import make_camera as j_make_camera
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import local_mapping as tlm
from orbslam2_tpu_torch.solvers import lie as tlie
from orbslam2_tpu_torch.solvers import local_ba as tlb
from orbslam2_tpu_torch.utils.camera import make_camera
from torch_carried_map import carried_map

POSE_TOL = 1e-4
PT_TOL = 1e-3
PT_RTOL = 1e-3

# (n_local, n_fixed): the mapper's window on this map (C = 16, which lists
# the current keyframe twice: it has 9 covisible keyframes for 15 slots),
# and a window that the covisible keyframes fill (C = 8).
WINDOWS = {"mapper_16": (8, 8), "filled_8": (4, 4)}


@pytest.fixture(scope="module")
def carried():
    s, ps, m, kf = carried_map(14)
    jmapper = jlm.LocalMapper(s, sensor="rgbd")
    tmapper = tlm.LocalMapper(ps, sensor="rgbd")
    return dict(m=m, kf=kf, jmapper=jmapper, tmapper=tmapper)


@pytest.fixture(scope="module")
def solved(carried):
    """Both packages' local BA on the carried map, per window."""
    m, kf = carried["m"], carried["kf"]
    jm = jax.tree.map(jnp.asarray, m)
    tm = convert.map_state_from_numpy(m, "cpu")
    out = {}
    for name, (n_local, n_fixed) in WINDOWS.items():
        pt_cap = max(2, n_local // 2) * m.kf_xy.shape[1]
        ref = jlb.local_bundle_adjustment(
            jm, jnp.int32(kf), carried["jmapper"].cam, carried["jmapper"].inv_sigma2,
            n_local=n_local, n_fixed=n_fixed, pt_cap=pt_cap)
        got = tlb.local_bundle_adjustment(
            tm, kf, carried["tmapper"].cam, carried["tmapper"].tables("cpu")[2],
            n_local=n_local, n_fixed=n_fixed, pt_cap=pt_cap)
        out[name] = (jax.tree.map(np.asarray, ref), got)
    return out


@pytest.mark.parametrize("window", list(WINDOWS))
def test_gather_problem(carried, window):
    n_local, n_fixed = WINDOWS[window]
    jm = jax.tree.map(jnp.asarray, carried["m"])
    ref = jlb._gather_problem(jm, jnp.int32(carried["kf"]), n_local, n_fixed)
    got = tlb._gather_problem(convert.map_state_from_numpy(carried["m"], "cpu"),
                              carried["kf"], n_local, n_fixed)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("window", list(WINDOWS))
def test_local_bundle_adjustment(carried, solved, window):
    ref, got = solved[window]
    m = carried["m"]
    np.testing.assert_array_equal(got.kf_point.numpy(), ref.kf_point)
    np.testing.assert_allclose(got.kf_pose_cw.numpy(), ref.kf_pose_cw, atol=POSE_TOL)
    np.testing.assert_allclose(got.pt_pos.numpy(), ref.pt_pos, atol=PT_TOL, rtol=PT_RTOL)
    assert np.abs(ref.pt_pos - m.pt_pos).max() > 10 * PT_TOL, "points did not move"


def test_a_repeated_keyframe_writes_its_old_row_back(carried, solved):
    """The mapper's window lists the current keyframe twice; its later,
    unused copy wins the write-back (the reference's scatter), so that
    keyframe's pose and bindings come out as they went in, while the rest
    of the window moved."""
    m, kf = carried["m"], carried["kf"]
    cam_ids, _, used = tlb._gather_problem(convert.map_state_from_numpy(m, "cpu"), kf, 8, 8)
    assert int((cam_ids == kf).sum()) == 2 and not used[1:][cam_ids[1:] == kf].any()
    ref, got = solved["mapper_16"]
    np.testing.assert_array_equal(ref.kf_pose_cw[kf], m.kf_pose_cw[kf])
    np.testing.assert_array_equal(got.kf_pose_cw[kf].numpy(), m.kf_pose_cw[kf])
    np.testing.assert_array_equal(got.kf_point[kf].numpy(), m.kf_point[kf])
    others = cam_ids[1:][used[1:]].numpy()
    assert np.abs(ref.kf_pose_cw[others] - m.kf_pose_cw[others]).max() > 10 * POSE_TOL
    # In the window the covisible keyframes fill, kf_id is listed once and
    # its pose is optimized.
    ref8, got8 = solved["filled_8"]
    assert np.abs(ref8.kf_pose_cw[kf] - m.kf_pose_cw[kf]).max() > 10 * POSE_TOL
    np.testing.assert_allclose(got8.kf_pose_cw[kf].numpy(), ref8.kf_pose_cw[kf], atol=POSE_TOL)


def _synthetic_problem(seed=1, C=5, N=96, P=150):
    rng = np.random.default_rng(seed)
    pts_true = (rng.normal(size=(P, 3)) * [1.0, 0.7, 0.5] + [0, 0, 4.0]).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    poses[:, :3, 3] = np.stack([np.linspace(-0.3, 0.3, C), np.zeros(C), np.zeros(C)], 1)
    pid = np.stack([rng.choice(P, N, replace=False) for _ in range(C)]).astype(np.int32)
    pid[:, -3] = pid[:, 0]  # a repeated (camera, point) observation
    pc = pts_true[pid] + poses[:, None, :3, 3]
    uv = np.stack([320 * pc[..., 0] / pc[..., 2] + 160, 320 * pc[..., 1] / pc[..., 2] + 120], -1)
    uv = (uv + rng.normal(scale=0.5, size=uv.shape)).astype(np.float32)
    uv[:, 5] += 40.0  # gross outliers
    ur = np.where(rng.random((C, N)) < 0.5, uv[..., 0] - 32.0 / pc[..., 2], -1.0).astype(np.float32)
    inv_s2 = np.ones((C, N), np.float32)
    obs_ok = rng.random((C, N)) < 0.95
    noisy = poses.copy()
    noisy[1:, :3, 3] += rng.normal(scale=0.02, size=(C - 1, 3)).astype(np.float32)
    pts0 = (pts_true + rng.normal(scale=0.02, size=pts_true.shape)).astype(np.float32)
    is_fixed = np.zeros(C, bool)
    is_fixed[0] = True
    used = np.ones(C, bool)
    used[-1] = False
    return noisy, pts0, uv, ur, inv_s2, pid, obs_ok, is_fixed, used


def test_schur_ba_core_on_a_synthetic_problem():
    args = _synthetic_problem()
    kw = dict(bf=32.0, width=320, height=240)
    ref = jlb.schur_ba_core(*(jnp.asarray(a) for a in args),
                            j_make_camera(320.0, 320.0, 160.0, 120.0,
                                          dist=np.zeros(5, np.float32), **kw))
    got = tlb.schur_ba_core(*(torch.from_numpy(a) for a in args),
                            make_camera(320.0, 320.0, 160.0, 120.0, **kw))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=POSE_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=PT_TOL, rtol=PT_RTOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert not np.asarray(ref[2])[:, 5].any()  # the outliers were pruned
    assert np.abs(np.asarray(ref[0]) - args[0]).max() > 1e-3


def test_inv3x3_and_blockdiag():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A[0] = 0.0  # the determinant floor
    np.testing.assert_allclose(tlie.inv3x3(torch.from_numpy(A)).numpy(),
                               np.asarray(jlie.inv3x3(jnp.asarray(A))), rtol=1e-5, atol=1e-5)
    B = rng.normal(size=(5, 6, 6)).astype(np.float32)
    np.testing.assert_array_equal(tlb._blockdiag(torch.from_numpy(B)).numpy(),
                                  np.asarray(jlb._blockdiag(jnp.asarray(B))))
