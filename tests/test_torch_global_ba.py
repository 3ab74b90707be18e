"""Global BA and the loop-edge guard: ``orbslam2_tpu_torch.solvers.
global_ba`` and ``models.loop_closing.loop_edge_residuals`` /
``loop_edges_still_closed`` against ``orbslam2_tpu`` on the CPU.

The map is carried across from the reference tracker (14 frames, 10
keyframes; ``torch_carried_map``), then drifted: every keyframe but the
first moved by a small SE3 step growing with its id, the points jittered,
and a few observations bound to wrong points so that the outlier pruning
has something to unbind.  Both packages refine it with the joint Schur GBA
(the three segments of the loop closer's schedule, and one full (5, 10)
run) and with the alternation.  Poses within POSE_TOL = 1e-4, points
within PT_TOL + PT_RTOL |X| (1e-3 m + 1e-3 |X|, the rule of
``test_torch_local_ba.py`` for the same Schur engine, whose landmark sums
run in another order: measured 6.9e-3 m on a point 120 m away and 2.1e-3 m
on one within 30 m, far points whose depth a short baseline barely fixes),
``kf_point`` after the unbinding exact.  The guard functions are host
numpy in both packages: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import loop_closing as jlc
from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.solvers import global_ba as jgba
from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import loop_closing as tlc
from orbslam2_tpu_torch.models import map_state as tms
from orbslam2_tpu_torch.solvers import global_ba as tgba
from torch_carried_map import carried_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

POSE_TOL = 1e-4
PT_TOL = 1e-3
PT_RTOL = 1e-3


@pytest.fixture(scope="module")
def drifted():
    s, ps, m, _ = carried_map(14)
    rng = np.random.default_rng(0)
    m = m._replace(**{k: np.array(v) for k, v in m._asdict().items()})
    ids = np.nonzero(m.kf_valid)[0]
    for k in ids[1:]:
        xi = np.concatenate([rng.normal(0, 0.004, 3), rng.normal(0, 0.002, 3)]) * (1 + k / 4)
        m.kf_pose_cw[k] = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32))) @ m.kf_pose_cw[k]
    pv = m.pt_valid
    m.pt_pos[pv] += rng.normal(0, 0.01, (pv.sum(), 3)).astype(np.float32)
    # Wrong associations: 30 bound slots of the last keyframes rebound to
    # random live points.
    live = np.nonzero(pv)[0]
    for k in ids[-3:]:
        slots = np.nonzero(m.kf_point[k] >= 0)[0]
        pick = rng.choice(slots, 10, replace=False)
        m.kf_point[k, pick] = rng.choice(live, 10)
    jmapper_cam = s.camera_model()
    from orbslam2_tpu.ops import pyramid as jpyr

    inv_s2 = (1.0 / jpyr.level_sigma2(s.orb.n_levels, s.orb.scale_factor)).astype(np.float32)
    return dict(m=m, jcam=jmapper_cam, cam=ps.camera_model(), inv_s2=inv_s2)


def compare(out, ref):
    ref = jax.tree.map(np.asarray, ref)
    kv = ref.kf_valid
    np.testing.assert_allclose(out.kf_pose_cw.numpy()[kv], ref.kf_pose_cw[kv], atol=POSE_TOL)
    pv = ref.pt_valid
    X = ref.pt_pos[pv]
    err = np.abs(out.pt_pos.numpy()[pv] - X).max(-1)
    assert (err <= PT_TOL + PT_RTOL * np.linalg.norm(X, axis=-1)).all(), err.max()
    np.testing.assert_array_equal(out.kf_point.numpy(), ref.kf_point)


@pytest.mark.parametrize("segment", ["robust_prune", "plain", "full"])
def test_joint_global_ba(drifted, segment):
    phase_iters, prune = {"robust_prune": ((5, 0), 6.0), "plain": ((0, 5), 0.0),
                          "full": ((5, 10), 0.0)}[segment]
    m = drifted["m"]
    ref = jgba.run_joint_global_ba(jax.tree.map(jnp.asarray, m), drifted["jcam"],
                                   jnp.asarray(drifted["inv_s2"]), phase_iters=phase_iters,
                                   initial_prune=prune)
    out = tgba.run_joint_global_ba(convert.map_state_from_numpy(m, "cpu"), drifted["cam"],
                                   torch.from_numpy(drifted["inv_s2"]), phase_iters=phase_iters,
                                   initial_prune=prune)
    # The solve moved the poses and unbound some of the wrong associations.
    assert np.abs(np.asarray(ref.kf_pose_cw) - m.kf_pose_cw).max() > 1e-4
    assert (np.asarray(ref.kf_point) != m.kf_point).sum() > 0
    compare(out, ref)


def test_joint_global_ba_leaves_a_tiny_map_alone(drifted):
    m = drifted["m"]
    one = m._replace(kf_valid=np.arange(m.kf_valid.shape[0]) == 0)
    tm = convert.map_state_from_numpy(one, "cpu")
    assert tgba.run_joint_global_ba(tm, drifted["cam"], torch.from_numpy(drifted["inv_s2"])) is tm
    tm = convert.map_state_from_numpy(m, "cpu")
    assert tgba.run_joint_global_ba(tm, drifted["cam"], torch.from_numpy(drifted["inv_s2"]),
                                    max_cams=4) is tm


@pytest.mark.parametrize("rounds", [2, 6])
def test_alternation_global_ba(drifted, rounds):
    m = drifted["m"]
    ref = jgba.global_bundle_adjustment(jax.tree.map(jnp.asarray, m), drifted["jcam"],
                                        jnp.asarray(drifted["inv_s2"]), rounds=rounds)
    out = tgba.global_bundle_adjustment(convert.map_state_from_numpy(m, "cpu"), drifted["cam"],
                                        torch.from_numpy(drifted["inv_s2"]), rounds=rounds)
    assert np.abs(np.asarray(ref.pt_pos) - m.pt_pos).max() > 1e-4
    compare(out, ref)


@pytest.mark.parametrize("case", ["kept", "reopened", "rotated", "two_edges"])
def test_loop_edge_guard(case):
    """TestGlobalBA.test_loop_edge_guard's cases, and a second edge."""
    T0 = np.eye(4, dtype=np.float32)
    T9 = np.asarray(jlie.se3_exp(jnp.asarray([0.4, 0.0, 1.0, 0.0, 0.3, 0.0], jnp.float32)))
    poses = np.stack([T0, T9])
    edges = [(0, 1, T9 @ np.linalg.inv(T0))]
    step = {"kept": [0.001, 0, 0, 0, 0, 0], "reopened": [0.3, 0, 0.2, 0, 0, 0],
            "rotated": [0, 0, 0, 0, 0.05, 0], "two_edges": [0.01, 0, 0, 0, 0.002, 0]}[case]
    T9b = np.asarray(jlie.se3_exp(jnp.asarray(step, jnp.float32))) @ T9
    if case == "two_edges":
        edges.append((1, 0, np.asarray(jlie.sim3_inverse_mat(jnp.asarray(edges[0][2])))))
    after = np.stack([T0, T9b])
    r0j, r1j = jlc.loop_edge_residuals(poses, edges), jlc.loop_edge_residuals(after, edges)
    r0t, r1t = tlc.loop_edge_residuals(poses, edges), tlc.loop_edge_residuals(after, edges)
    assert r0t == r0j and r1t == r1j
    for scale in (1.0, 0.05):
        assert (tlc.loop_edges_still_closed(r0t, r1t, scene_scale=scale)
                == jlc.loop_edges_still_closed(r0j, r1j, scene_scale=scale))


def test_points_seen_and_covisible_group_on_the_drifted_map(drifted):
    """The loop closer's group reads (``points_seen_by`` over a covisible
    group) equal the reference's on the drifted map."""
    m = drifted["m"]
    jm = jax.tree.map(jnp.asarray, m)
    tm = convert.map_state_from_numpy(m, "cpu")
    W = np.asarray(jms.covisibility(jm))
    group = (W[0] > 0) | (np.arange(W.shape[0]) == 0)
    np.testing.assert_array_equal(tms.points_seen_by(tm, torch.from_numpy(group)).numpy(),
                                  np.asarray(jms.points_seen_by(jm, jnp.asarray(group))))
