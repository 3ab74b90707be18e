"""The cluster split of K4 and K5 (``csrc/ba_kernels.cu``) on the CPU.

``kernels.ba_split(C, N)`` chooses the blocks S over which the kernels
split each camera's observations; it must be a pure function of the shape,
reach the block target at the main path's windows and leave no block
empty.  ``_kernel_order_sums`` is a plain copy of the kernels' reduction
order: block r of S takes observations [r N // S, (r + 1) N // S), thread t
of BA_THREADS adds its observations t, t + BA_THREADS, ... of that chunk in
order, a shuffle-down tree sums each warp (K4's reduce-scatter pairs the
lanes the same way), the warps are added in order,
then the blocks' totals in rank order.  Fed the plain versions' own
per-observation terms, it must agree with ``_ba_normal_equations_plain``
and ``_ba_chi2_plain`` within chip_smoke's limits: blocks plane-scaled
1e-4, per-camera chi2 sums (1e9 sentinels included) 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.solvers import ba_kernels as bk
from orbslam2_tpu_torch.utils.camera import make_camera
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WARP = 32
# (C, N): the split chosen.  The windows below; a ragged shape; one
# observation; S = 8 with few observations; chunks not a multiple of the
# block; more cameras than the block target needs; N smaller than S.
SPLITS = {(16, 1024): 8, (16, 2048): 8, (48, 1024): 4, (3, 77): 8, (1, 1): 1, (1, 130): 8,
          (5, 1000): 8, (64, 2048): 2, (1, 3): 2, (200, 5): 1}
# The local-BA windows of the main path: RGB-D and stereo at 16 cameras,
# the 32 + 16 window.
WINDOWS = [(16, 1024), (16, 2048), (48, 1024)]
MODEL_SHAPES = [(16, 1024), (48, 1024), (3, 77), (1, 1)]
TRIU6 = [(i, j) for i in range(6) for j in range(i, 6)]


@pytest.mark.parametrize("C,N", list(SPLITS))
def test_split_is_a_power_of_two_that_leaves_no_block_empty(C, N):
    S = kernels.ba_split(C, N)
    assert S == SPLITS[(C, N)]
    assert S in (1, 2, 4, 8) and S <= kernels.BA_MAX_SPLIT
    assert S == kernels.ba_split(C, N)
    assert S <= N
    bounds = [r * N // S for r in range(S + 1)]
    assert bounds[0] == 0 and bounds[-1] == N
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
    # The smallest S that reaches the target, unless the cluster limit or
    # N stops it first.
    if C * S < kernels.BA_BLOCKS:
        assert S == min(kernels.BA_MAX_SPLIT, 1 << (N.bit_length() - 1))
    elif S > 1:
        assert C * (S // 2) < kernels.BA_BLOCKS


@pytest.mark.parametrize("C,N", WINDOWS)
def test_split_fills_the_block_target_at_the_windows(C, N):
    S = kernels.ba_split(C, N)
    assert S > 1 and C * S >= kernels.BA_BLOCKS
    # At 16 x 1024 every thread of the 128 blocks takes one observation.
    if (C, N) == (16, 1024):
        assert C * S == 128 and N // S == kernels.BA_THREADS


def _problem(C, N, seed):
    """Seeded numpy inputs in the kernels' N-minor layout: poses near the
    identity, points 3-7 m ahead with every seventh behind the cameras,
    half the observations stereo, a tenth masked out."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    poses[:, :3, 3] = (rng.random((C, 3)) - 0.5) * 0.2
    X = np.stack([(rng.random((C, N)) - 0.5) * 4, (rng.random((C, N)) - 0.5) * 3,
                  3 + 4 * rng.random((C, N))], 1).astype(np.float32)
    X[:, 2, ::7] = -2.0
    uv = np.stack([rng.random((C, N)) * 640, rng.random((C, N)) * 480], 1).astype(np.float32)
    ur = np.where(rng.random((C, N)) < 0.5, uv[:, 0] - 40 * rng.random((C, N)),
                  -1.0).astype(np.float32)
    inv_s2 = (rng.random((C, N)) + 0.5).astype(np.float32)
    mask = rng.random((C, N)) < 0.9
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (poses, X, uv, ur, inv_s2, mask)]


def _per_observation(args):
    """The same problem with each observation a camera of its own: the
    plain versions' sums over one observation are its terms."""
    poses, X, uv, ur, inv_s2, mask = args
    C, _, N = X.shape
    return (poses.repeat_interleave(N, 0), X.transpose(1, 2).reshape(C * N, 3, 1),
            uv.transpose(1, 2).reshape(C * N, 2, 1), ur.reshape(C * N, 1),
            inv_s2.reshape(C * N, 1), mask.reshape(C * N, 1))


def _kernel_order_sums(terms, S):
    """(C, N, K) float32 terms -> (C, K) sums in the kernels' order."""
    C, N, K = terms.shape
    T, W = kernels.BA_THREADS, kernels.BA_THREADS // WARP
    total = np.zeros((C, K), np.float32)
    for r in range(S):
        lo, hi = r * N // S, (r + 1) * N // S
        steps = -(-(hi - lo) // T)
        chunk = np.zeros((C, steps * T, K), np.float32)
        chunk[:, :hi - lo] = terms[:, lo:hi]
        acc = np.zeros((C, T, K), np.float32)
        for i in range(steps):
            acc = acc + chunk[:, i * T:(i + 1) * T]
        lanes = acc.reshape(C, W, WARP, K)
        off = WARP // 2
        while off:
            lanes = lanes[:, :, :off] + lanes[:, :, off:2 * off]
            off //= 2
        block = np.zeros((C, K), np.float32)
        for w in range(W):
            block = block + lanes[:, w, 0]
        total = total + block
    return total


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0))


def _sum_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


@pytest.fixture(scope="module")
def cam():
    return make_camera(517.3, 516.5, 318.6, 255.3, bf=40.0, width=640, height=480)


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("C,N", MODEL_SHAPES)
def test_k4_reduction_order_matches_the_plain_version(cam, C, N, robust):
    args = _problem(C, N, seed=C * 7919 + N)
    H, b, _, chi2_sum = bk._ba_normal_equations_plain(*args, cam, robust)
    Ho, bo, _, so = bk._ba_normal_equations_plain(*_per_observation(args), cam, robust)
    terms = torch.cat([torch.stack([Ho[:, i, j] for i, j in TRIU6], -1), bo, so[:, None]], -1)
    sums = _kernel_order_sums(terms.reshape(C, N, 28).numpy(), kernels.ba_split(C, N))
    Hm = np.zeros((C, 6, 6), np.float32)
    for k, (i, j) in enumerate(TRIU6):
        Hm[:, i, j] = Hm[:, j, i] = sums[:, k]
    assert _scaled(Hm, H) < 1e-4
    assert _scaled(sums[:, 21:27], b) < 1e-4
    assert _sum_rel(sums[:, 27], chi2_sum) < 1e-5
    # The sentinels are in the sums.
    behind = (args[1][:, 2] + args[0][:, 2, 3, None] <= 1e-6) & args[5]
    assert np.all(sums[:, 27] >= 1e9 * behind.sum(1).numpy() * (1 - 1e-6))


@pytest.mark.parametrize("C,N", MODEL_SHAPES)
def test_k5_reduction_order_matches_the_plain_version(cam, C, N):
    args = _problem(C, N, seed=C * 104729 + N)
    chi2, total = bk._ba_chi2_plain(*args, cam)
    terms = (args[5].to(torch.float32) * chi2).reshape(C, N, 1).numpy()
    sums = _kernel_order_sums(terms, kernels.ba_split(C, N))
    assert _sum_rel(sums[:, 0], total) < 1e-5
