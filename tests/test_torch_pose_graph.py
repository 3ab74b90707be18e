"""Covisibility and the essential graph: ``orbslam2_tpu_torch.models.
map_state.observation_matrix`` / ``covisibility`` and ``solvers.pose_graph``
against ``orbslam2_tpu`` on the CPU.

* ``observation_matrix`` and ``covisibility`` exact on a map built by the
  reference tracker (``torch_carried_map``).
* ``edges_from_map``: endpoints and validity exact, S_ji within 1e-5.
* ``optimize_essential_graph`` on a drifted circle closed by one loop edge,
  scale fixed and free: the dense (7K, 7K) solve at K = 24 and the
  matrix-free PCG at K = 600 (7K > 4096, 5 iterations).  Poses within
  POSE_TOL = 1e-4, scales within SCALE_TOL = 1e-5 (the node sums run in the reference's
  order; the dense solve is LU in another library).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu.solvers import pose_graph as jpg
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import map_state as tms
from orbslam2_tpu_torch.solvers import pose_graph as tpg
from torch_carried_map import carried_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

POSE_TOL = 1e-4
SCALE_TOL = 1e-5


@pytest.fixture(scope="module")
def carried():
    _, _, m, kf = carried_map(n_frames=30)
    return m, kf


def _jmap(m):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in m._asdict().items()})


def test_observation_matrix_exact(carried):
    m, _ = carried
    ref = np.asarray(jms.observation_matrix(_jmap(m)))
    out = tms.observation_matrix(convert.map_state_from_numpy(m, "cpu")).numpy()
    assert ref.sum() > 100
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("chunk", [16384, 1000])
def test_covisibility_exact(carried, chunk):
    m, _ = carried
    ref = np.asarray(jms.covisibility(_jmap(m), chunk=chunk))
    out = tms.covisibility(convert.map_state_from_numpy(m, "cpu"), chunk=chunk).numpy()
    assert out.dtype == np.int32 and ref.max() > 50
    np.testing.assert_array_equal(out, ref)


def test_edges_from_map(carried):
    m, kf = carried
    tm = convert.map_state_from_numpy(m, "cpu")
    W = np.asarray(jms.covisibility(_jmap(m)))
    S_loop = np.asarray(jlie.sim3_exp(jnp.asarray([[0.01, -0.02, 0.03, 0.01, 0.0, -0.01, 0.02]],
                                                  jnp.float32)))
    args = dict(loop_i=[0], loop_j=[kf], loop_S_ji=S_loop, loop_valid=[True])
    ref = jpg.edges_from_map(jnp.asarray(m.kf_pose_cw), jnp.asarray(m.kf_valid),
                             jnp.asarray(m.kf_parent), jnp.asarray(W),
                             *(jnp.asarray(args[k]) for k in args), min_covis_weight=50)
    out = tpg.edges_from_map(tm.kf_pose_cw, tm.kf_valid, tm.kf_parent, torch.from_numpy(W),
                             *(torch.as_tensor(np.asarray(args[k])) for k in args),
                             min_covis_weight=50)
    assert np.asarray(ref.valid).sum() > 10
    for name in ("i", "j", "valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(out.S_ji.numpy(), np.asarray(ref.S_ji), atol=1e-5)
    np.testing.assert_array_equal(out.weight.numpy(), np.asarray(ref.weight))


def drifted_circle(K, fix_scale, seed=0):
    """Ground truth on a circle of radius 3 m (T_cw), an estimate chained
    from the true steps with a small rotation and translation error (and,
    with the scale free, a 1% scale drift per step), the spanning tree i-1
    -> i, covisibility 150 between neighbours up to 2 apart and 100-199
    between random pairs (so that the graph is well conditioned and the
    PCG converges within its 100 steps), and a loop edge (0, K-1) carrying
    the true relative pose."""
    rng = np.random.default_rng(seed)
    gt = []
    for i in range(K):
        a = 2 * np.pi * i / K
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([3 * np.sin(a), 0.1 * np.sin(3 * a), -3 * np.cos(a)])
        T_wc = np.eye(4)
        T_wc[:3, :3], T_wc[:3, 3] = R, pos
        gt.append(np.linalg.inv(T_wc))
    gt = np.stack(gt)
    est = [gt[0]]
    for i in range(1, K):
        step = gt[i] @ np.linalg.inv(gt[i - 1])
        err = np.asarray(jlie.se3_exp(jnp.asarray(
            np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.004, 3)]).astype(np.float32))),
            np.float64)
        step = err @ step
        if not fix_scale:
            step[:3, 3] *= 1.01
        est.append(step @ est[-1])
    est = np.stack(est).astype(np.float32)
    idx = np.arange(K)
    covis = np.where((np.abs(idx[:, None] - idx[None]) <= 2) & (idx[:, None] != idx[None]),
                     150, 0).astype(np.int32)
    a, b = rng.integers(0, K, (2, 4 * K))
    w = rng.integers(100, 200, 4 * K)
    covis[a, b] = covis[b, a] = np.where(a != b, w, 0)
    parent = (idx - 1).astype(np.int32)
    S_loop = (gt[K - 1] @ np.linalg.inv(gt[0])).astype(np.float32)[None]
    return gt, est, covis, parent, S_loop


@pytest.mark.parametrize("K, iters", [(24, 20), (600, 5)], ids=["dense", "pcg"])
@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_essential_graph(K, iters, fix_scale):
    gt, est, covis, parent, S_loop = drifted_circle(K, fix_scale)
    valid = np.ones(K, bool)
    valid[K // 3] = False  # a culled keyframe: its edges drop out
    fixed = np.zeros(K, bool)
    fixed[0] = True
    loop = dict(loop_i=np.array([0]), loop_j=np.array([K - 1]), loop_S_ji=S_loop,
                loop_valid=np.array([True]))
    jedges = jpg.edges_from_map(jnp.asarray(est), jnp.asarray(valid), jnp.asarray(parent),
                                jnp.asarray(covis), *(jnp.asarray(v) for v in loop.values()))
    T_ref, s_ref = jpg.optimize_essential_graph(jnp.asarray(est), jnp.asarray(valid), jedges,
                                                jnp.asarray(fixed), iters=iters,
                                                fix_scale=fix_scale)
    tedges = tpg.edges_from_map(torch.from_numpy(est), torch.from_numpy(valid),
                                torch.from_numpy(parent), torch.from_numpy(covis),
                                *(torch.from_numpy(v) for v in loop.values()))
    T_out, s_out = tpg.optimize_essential_graph(torch.from_numpy(est), torch.from_numpy(valid),
                                                tedges, torch.from_numpy(fixed), iters=iters,
                                                fix_scale=fix_scale)
    T_ref, s_ref = np.asarray(T_ref), np.asarray(s_ref)
    # The loop edge moves the chain.
    assert np.abs(T_ref[valid] - est[valid]).max() > 1e-3
    np.testing.assert_allclose(T_out.numpy()[valid], T_ref[valid], atol=POSE_TOL)
    np.testing.assert_allclose(s_out.numpy()[valid], s_ref[valid], atol=SCALE_TOL)
