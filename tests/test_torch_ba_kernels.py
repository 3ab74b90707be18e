"""K4 and K5 of the port on the CPU (their plain versions) against the
reference's Pallas kernels in interpret mode and against its einsum
formulation (``local_ba._residuals``).

Problems: the reference test's (C=4, N=256, P=512, seed 3) and a ragged one
(C=3, N=77) with a seventh of its points behind the cameras, so the 1e9
chi2 sentinel and its share of the sums are exercised.  Tolerances are the
reference test's (tests/test_ba_kernels.py): plane-scaled 1e-4 for the
blocks, 1e-3 for the chi2 row, 1e-5 relative for the per-camera sums; the
sums are taken in another order than the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.solvers import local_ba as jlb
from orbslam2_tpu.solvers.ba_kernels import ba_chi2 as j_chi2
from orbslam2_tpu.solvers.ba_kernels import ba_normal_equations as j_ne
from orbslam2_tpu.utils.camera import make_camera as j_make_camera
from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.solvers import ba_kernels as tbk
from orbslam2_tpu_torch.solvers import local_ba as tlb
from orbslam2_tpu_torch.utils.camera import make_camera
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TRIU3 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _problem(C, N, P, seed, behind_every):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (C, 1, 1))
    poses[:, :3, 3] = rng.normal(scale=0.1, size=(C, 3))
    pts = (rng.normal(size=(P, 3)) + np.array([0, 0, 5.0])).astype(np.float32)
    if behind_every:
        pts[::behind_every, 2] = -2.0
    pid = rng.integers(0, P, (C, N)).astype(np.int32)
    uv = (rng.random((C, N, 2)) * np.array([320, 240])).astype(np.float32)
    ur = np.where(rng.random((C, N)) < 0.5, rng.random((C, N)) * 320, -1.0).astype(np.float32)
    inv_s2 = (rng.random((C, N)) + 0.5).astype(np.float32)
    mask = rng.random((C, N)) < 0.9
    return dict(poses=poses, pts=pts, pid=pid, uv=uv, ur=ur, inv_s2=inv_s2, mask=mask)


PROBLEMS = {
    "reference": dict(C=4, N=256, P=512, seed=3, behind_every=0),
    "ragged_behind": dict(C=3, N=77, P=60, seed=5, behind_every=7),
}


@pytest.fixture(scope="module")
def cams():
    kw = dict(bf=32.0, width=320, height=240)
    return (j_make_camera(320.0, 320.0, 160.0, 120.0, dist=np.zeros(5, np.float32), **kw),
            make_camera(320.0, 320.0, 160.0, 120.0, **kw))


def _inputs(p):
    """The kernels' N-minor inputs, as numpy."""
    X = np.swapaxes(p["pts"][p["pid"]], 1, 2).copy()
    uvT = np.swapaxes(p["uv"], 1, 2).copy()
    return p["poses"], X, uvT, p["ur"], p["inv_s2"], p["mask"]


def _port(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0))


def _reference_blocks(cam, p, robust):
    """The reference's einsum formulation (tests/test_ba_kernels.py)."""
    poses, pts, pid = jnp.asarray(p["poses"]), jnp.asarray(p["pts"]), jnp.asarray(p["pid"])
    uv, ur, inv_s2, mask = (jnp.asarray(p[k]) for k in ("uv", "ur", "inv_s2", "mask"))
    r, J_cam, J_pt, behind = jlb._residuals(poses, pts, uv, ur, pid, mask, cam)
    w = inv_s2 * mask.astype(jnp.float32) * (~behind).astype(jnp.float32)
    if robust:
        chi2_th = jnp.where(ur >= 0, jlb.CHI2_STEREO, jlb.CHI2_MONO)
        rn = jnp.sqrt(jnp.sum(r * r, -1) * inv_s2 + 1e-12)
        w = w * jnp.minimum(1.0, jnp.sqrt(chi2_th) / jnp.maximum(rn, 1e-12))
    chi2 = jnp.where(behind, 1e9, jnp.sum(r * r, -1) * inv_s2)
    return dict(
        H=jnp.einsum("cnij,cn,cnik->cjk", J_cam, w, J_cam),
        b=jnp.einsum("cnij,cn,cni->cj", J_cam, w, r),
        Hpp=jnp.einsum("cnij,cn,cnik->cnjk", J_pt, w, J_pt),
        bp=jnp.einsum("cnij,cn,cni->cnj", J_pt, w, r),
        G=jnp.einsum("cnij,cn,cnik->cnjk", J_cam, w, J_pt),
        chi2=chi2, err=jnp.sum(jnp.where(mask, chi2, 0.0), axis=1), w=w,
    )


def _check_pack(pack, ref):
    pack = np.asarray(pack)
    for r_, (a, b) in enumerate(TRIU3):
        assert _rel(pack[:, r_], ref["Hpp"][..., a, b]) < 1e-4, r_
    for k in range(3):
        assert _rel(pack[:, 6 + k], ref["bp"][..., k]) < 1e-4, k
    for i in range(6):
        for j in range(3):
            assert _rel(pack[:, 9 + i * 3 + j], ref["G"][..., i, j]) < 1e-4, (i, j)
    assert _rel(pack[:, 27], ref["chi2"]) < 1e-3  # 1e9 sentinels included
    assert _rel(pack[:, 28], ref["w"]) < 1e-4
    assert np.all(pack[:, 29:] == 0)


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_normal_equations_match_the_pallas_kernel(cams, name, robust):
    jcam, cam = cams
    p = _problem(**PROBLEMS[name])
    arrays = _inputs(p)
    Hk, bk, pack, chi2k = j_ne(*(jnp.asarray(a) for a in arrays), jcam, robust, interpret=True)
    H, b, tpack, tchi2 = tbk.ba_normal_equations(*_port(arrays), cam, robust)
    assert _rel(H, Hk) < 1e-4
    np.testing.assert_array_equal(H.numpy(), H.numpy().transpose(0, 2, 1))
    assert _rel(b, bk) < 1e-4
    for r_ in range(29):
        bound = 1e-3 if r_ == 27 else 1e-4
        assert _rel(tpack[:, r_], np.asarray(pack)[:, r_]) < bound, r_
    chi2k = np.asarray(chi2k)
    assert np.max(np.abs(tchi2.numpy() - chi2k) / np.maximum(chi2k, 1.0)) < 1e-5


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_normal_equations_match_the_einsums(cams, name, robust):
    jcam, cam = cams
    p = _problem(**PROBLEMS[name])
    ref = _reference_blocks(jcam, p, robust)
    H, b, pack, chi2_sum = tbk.ba_normal_equations(*_port(_inputs(p)), cam, robust)
    assert _rel(H, ref["H"]) < 1e-4
    assert _rel(b, ref["b"]) < 1e-4
    _check_pack(pack, ref)
    err = np.asarray(ref["err"])
    assert np.max(np.abs(chi2_sum.numpy() - err) / np.maximum(err, 1.0)) < 1e-5


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_chi2_matches_the_pallas_kernel_and_the_einsums(cams, name):
    jcam, cam = cams
    p = _problem(**PROBLEMS[name])
    arrays = _inputs(p)
    jobs, jsum = j_chi2(*(jnp.asarray(a) for a in arrays), jcam, interpret=True)
    obs, total = tbk.ba_chi2(*_port(arrays), cam)
    ref = _reference_blocks(jcam, p, False)
    for want_obs, want_sum in ((jobs, jsum), (ref["chi2"], ref["err"])):
        want_obs, want_sum = np.asarray(want_obs), np.asarray(want_sum)
        assert np.max(np.abs(obs.numpy() - want_obs) / (want_obs + 1.0)) < 1e-4
        assert np.max(np.abs(total.numpy() - want_sum) / np.maximum(want_sum, 1.0)) < 1e-5


def test_the_sentinel_counts_in_the_sums(cams):
    """Points behind a camera carry chi2 1e9 and add it to the camera's
    masked sum, with weight 0 in the blocks."""
    _, cam = cams
    p = _problem(**PROBLEMS["ragged_behind"])
    poses, X, uvT, ur, inv_s2, mask = _port(_inputs(p))
    _, _, pack, chi2_sum = tbk.ba_normal_equations(poses, X, uvT, ur, inv_s2, mask, cam, True)
    behind = (X[:, 2] + poses[:, 2, 3, None]) <= 1e-6  # identity rotations
    assert behind.any() and (behind & mask).any()
    assert torch.all(pack[:, 27][behind] == 1e9)
    assert torch.all(pack[:, 28][behind] == 0)
    n_sent = (behind & mask).sum(1).to(torch.float64)
    assert torch.all(chi2_sum.to(torch.float64) >= 1e9 * n_sent * (1 - 1e-6))
    _, k5_sum = tbk.ba_chi2(poses, X, uvT, ur, inv_s2, mask, cam)
    assert torch.allclose(k5_sum, chi2_sum, rtol=1e-6)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_residuals_match(cams, name):
    jcam, cam = cams
    p = _problem(**PROBLEMS[name])
    ref = jlb._residuals(*(jnp.asarray(p[k]) for k in ("poses", "pts", "uv", "ur", "pid")),
                         jnp.asarray(p["mask"]), jcam)
    out = tlb._residuals(*(torch.from_numpy(p[k]) for k in ("poses", "pts", "uv", "ur", "pid")),
                         cam)
    for got, want in zip(out[:3], ref[:3]):
        assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


def test_cpu_tensors_launch_no_kernel(cams):
    _, cam = cams
    p = _problem(**PROBLEMS["ragged_behind"])
    kernels.reset_launch_counts()
    tbk.ba_normal_equations(*_port(_inputs(p)), cam, True)
    tbk.ba_chi2(*_port(_inputs(p)), cam)
    assert kernels.LAUNCHES["ba_normal_equations"] == 0
    assert kernels.LAUNCHES["ba_chi2"] == 0
