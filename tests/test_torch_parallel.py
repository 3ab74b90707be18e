"""The port's multi-device solvers (``orbslam2_tpu_torch/parallel/``) on
CPU ranks, against the JAX package's on its virtual CPU mesh.

One group of 2 gloo ranks runs every job of ``tests/torch_parallel_ranks``
once for the module, one group of 4 the BA jobs; the JAX goldens come
from ``make_mesh(2)`` (and ``make_mesh(4)`` for the one-step BA) on the 8
virtual devices of ``tests/conftest.py``.  The cases mirror ``tests/test_parallel.py``'s ten
(its three ``slow`` ones at its own sizes, which fit here), with these
limits:

  * the sharded local BA and joint GBA equal the port's single-device
    solvers bit for bit on every rank; against the JAX package's sharded
    solvers the reference test's own limits (poses 2e-4, bindings equal,
    points 1e-2).  For the local BA a point may also lie as far from the
    JAX package's 2-device result as the JAX package's own results on 1, 2
    and 4 devices lie from each other: on this map two points seen by two
    keyframes each, which LM leaves where the order of the float32 sums
    puts them, spread by up to 0.124 m in the JAX package alone (2 against
    4 devices), and the port's lands 0.116 m from the 2-device result
    (0.0082 m from the 4-device one, 0.0023 m from the 8-device one);
  * the one-iteration step: every rank the same bits; within the
    reference's 1e-3 (its own limit for the step on 8 devices against 1)
    of the JAX package's step on the mesh of the same size and of the
    port's one-device step, after one step (the JAX package's own steps on
    1, 2, 4 and 8 devices differ by up to 3.0e-4 in the poses and 3.9e-4
    in the points), and the reference's convergence gates after ten;
  * the essential graph: within 1e-4 of the JAX package's distributed
    solve on the same mesh size, within the reference's 2e-3 of the port's
    single-device solver, and its drift gate;
  * ``SlamSystem(rgbd, mesh=...)`` on 8 frames at 320x240 with mapping:
    each rank's trajectory and map equal the single-process run's bit for
    bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu.parallel import dist_ba as j_dist_ba
from orbslam2_tpu.parallel import dist_pose_graph as j_dpg
from orbslam2_tpu.parallel import mesh as j_mesh
from orbslam2_tpu.solvers import local_ba as j_local_ba
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.parallel import dist_ba, dist_pose_graph
from orbslam2_tpu_torch.parallel.distributed import KF_FIELDS, initialize_distributed
from orbslam2_tpu_torch.solvers import pose_graph
from orbslam2_tpu_torch.utils.camera import make_camera

from test_parallel import make_pose_graph, make_problem, make_slam_map, mean_reproj_err
from test_slam_e2e import small_settings
from torch_parallel_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_SLAM = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_problem(prob):
    return dist_ba.ShardedBAProblem(*(None if x is None else _t(x) for x in prob))


def _port_cam(cam):
    return make_camera(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                       bf=float(cam.bf), width=cam.width, height=cam.height)


def _live_settings(n_features):
    return Settings(
        camera=CameraSettings(fx=300.0, fy=300.0, cx=128.0, cy=96.0, width=256, height=192),
        orb=OrbSettings(n_features=n_features, n_levels=4),
        tpu=TpuSettings(max_keypoints=96, max_keyframes=16, max_points=512),
    )


@pytest.fixture(scope="module")
def golden():
    """The problems (the reference tests' fixtures) and the port's payload."""
    prob, _, _, cam = make_problem(n_cams=8, seed=3)
    prob_s, _, _, cam_s = make_problem(n_cams=8, stereo=True)
    gt, est, kf_valid, edges, fixed = make_pose_graph(K=12)
    m, poses_gt, _, slam_cam = make_slam_map(np.random.default_rng(0), K=16)
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=24, with_depth=True, seed=3)
    payload = {
        "prob": _port_problem(prob), "cam": _port_cam(cam),
        "prob_stereo": _port_problem(prob_s), "cam_stereo": _port_cam(cam_s),
        "pose_graph": (_t(est), _t(kf_valid), pose_graph.PoseGraphEdges(
            *(_t(x) for x in edges)), _t(fixed)),
        "slam_map": convert.map_state_from_numpy(jax.tree.map(np.array, m), "cpu"),
        "slam_cam": _port_cam(slam_cam),
        "mapper_settings": convert.settings_from_reference(_live_settings(128)),
        "live_settings": convert.settings_from_reference(_live_settings(96)),
        "slam_settings": convert.settings_from_reference(s),
        "slam_frames": (seq.images[:N_SLAM], seq.depths[:N_SLAM]),
    }
    return dict(prob=prob, cam=cam, prob_s=prob_s, cam_s=cam_s, gt=gt, est=est,
                kf_valid=kf_valid, edges=edges, fixed=fixed, m=m, poses_gt=poses_gt,
                slam_cam=slam_cam, payload=payload)


@pytest.fixture(scope="module")
def ranks2(golden, tmp_path_factory):
    jobs = ["ba_step", "ba_step_stereo", "pose_graph", "local_ba", "joint_gba", "mapper",
            "sharded_map", "slam"]
    return run_ranks(2, jobs, golden["payload"], tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def ranks4(golden, tmp_path_factory):
    return run_ranks(4, ["ba_step", "local_ba", "joint_gba"], golden["payload"],
                     tmp_path_factory.mktemp("ranks4"))


def _same_on_every_rank(outs, job):
    first = outs[0][job]
    for o in outs[1:]:
        for k, v in first.items():
            w = o[job][k]
            if torch.is_tensor(v):
                assert torch.equal(v, w), (job, k)
            elif isinstance(v, tuple) and v and torch.is_tensor(v[0]):
                assert all(torch.equal(a, b) for a, b in zip(v, w)), (job, k)


def _jax_step(golden, n_dev, key="prob", iters=1):
    prob, cam = (golden["prob"], golden["cam"]) if key == "prob" else (golden["prob_s"],
                                                                       golden["cam_s"])
    step = j_dist_ba.make_distributed_ba_step(j_mesh.make_mesh(n_dev), cam, n_total_cams=8)
    poses, pts = prob.poses, prob.points
    for _ in range(iters):
        poses, pts = step(prob._replace(poses=poses, points=pts))
    return np.asarray(poses), np.asarray(pts)


# -- TestDistributedPoseGraph ------------------------------------------------

def test_pose_graph_matches_single_device_and_corrects_drift(golden, ranks2):
    _same_on_every_rank(ranks2, "pose_graph")
    out = ranks2[0]["pose_graph"]
    T, s = out["T"].numpy(), out["s"].numpy()
    est, kf_valid, edges, fixed = golden["payload"]["pose_graph"]
    T_ref, s_ref = pose_graph.optimize_essential_graph(est, kf_valid, edges, fixed, iters=30)
    np.testing.assert_allclose(T, T_ref.numpy(), atol=2e-3)
    np.testing.assert_allclose(s, s_ref.numpy(), atol=2e-3)
    run = j_dpg.make_distributed_pose_graph(j_mesh.make_mesh(2), iters=30)
    T_j, s_j = run(jnp.asarray(golden["est"]), golden["kf_valid"], golden["edges"],
                   golden["fixed"])
    np.testing.assert_allclose(T, np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(s, np.asarray(s_j), atol=1e-4)
    gt, est_np = golden["gt"], golden["est"]
    K = gt.shape[0]
    err_before = np.linalg.norm(est_np[K - 1] @ np.linalg.inv(gt[K - 1]) - np.eye(4))
    err_after = np.linalg.norm(T[K - 1] @ np.linalg.inv(gt[K - 1]) - np.eye(4))
    assert err_after < 0.35 * err_before, (err_before, err_after)


def test_pose_graph_fix_scale_pins_scales(ranks2):
    np.testing.assert_allclose(ranks2[0]["pose_graph"]["s_fix"].numpy(), 1.0, atol=1e-6)


def test_pose_graph_pads_edges():
    edges = pose_graph.PoseGraphEdges(
        i=torch.tensor([0, 1, 2]), j=torch.tensor([1, 2, 3]),
        S_ji=torch.eye(4).expand(3, 4, 4), weight=torch.ones(3),
        valid=torch.ones(3, dtype=torch.bool))
    p = dist_pose_graph.pad_edges(edges, 4)
    assert p.i.shape == (4,) and not bool(p.valid[3]) and float(p.weight[3]) == 0.0
    assert dist_pose_graph.pad_edges(edges, 3) is edges


# -- TestDistributedBA -------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [2, 4])
def test_step_reduces_error(golden, ranks2, ranks4, n_ranks):
    outs = ranks2 if n_ranks == 2 else ranks4
    _same_on_every_rank(outs, "ba_step")
    out = outs[0]["ba_step"]
    prob, cam = golden["prob"], golden["cam"]
    e0 = mean_reproj_err(prob, prob.poses, prob.points, cam)
    e1 = mean_reproj_err(prob, out["poses"].numpy(), out["pts"].numpy(), cam)
    assert e1 < 0.3 * e0, (e0, e1)
    assert e1 < 1.0, e1
    poses_j, pts_j = _jax_step(golden, n_ranks)
    np.testing.assert_allclose(out["poses1"].numpy(), poses_j, atol=1e-3)
    np.testing.assert_allclose(out["pts1"].numpy(), pts_j, atol=1e-3)


def test_stereo_step_reduces_error(golden, ranks2):
    _same_on_every_rank(ranks2, "ba_step_stereo")
    out = ranks2[0]["ba_step_stereo"]
    prob, cam = golden["prob_s"], golden["cam_s"]
    assert prob.ur is not None and float(cam.bf) > 0
    e0 = mean_reproj_err(prob, prob.poses, prob.points, cam)
    e1 = mean_reproj_err(prob, out["poses"].numpy(), out["pts"].numpy(), cam)
    assert e1 < 0.3 * e0, (e0, e1)
    assert e1 < 1.2, e1
    poses_j, pts_j = _jax_step(golden, 2, key="prob_stereo")
    np.testing.assert_allclose(out["poses1"].numpy(), poses_j, atol=1e-3)
    np.testing.assert_allclose(out["pts1"].numpy(), pts_j, atol=1e-3)


def test_step_matches_single_device_semantics(golden, ranks2):
    p = golden["payload"]
    step1 = dist_ba.make_distributed_ba_step(None, p["cam"], 8)
    poses1, pts1 = step1(p["prob"])
    out = ranks2[0]["ba_step"]
    np.testing.assert_allclose(out["poses1"].numpy(), poses1.numpy(), atol=1e-3)
    np.testing.assert_allclose(out["pts1"].numpy(), pts1.numpy(), atol=1e-3)


def test_fixed_pose_untouched(golden, ranks2):
    out = ranks2[0]["ba_step"]["poses1"].numpy()
    start = np.asarray(golden["prob"].poses)
    np.testing.assert_allclose(out[0], start[0], atol=1e-7)
    assert not np.allclose(out[3], start[3])


# -- TestDistributedLocalBA --------------------------------------------------

def _against_jax(port_map, jax_map, spread=0.0):
    """The reference test's limits; ``spread``: per point, the JAX
    package's own spread, allowed where it exceeds 1e-2 m."""
    np.testing.assert_allclose(port_map.kf_pose_cw.numpy(), np.asarray(jax_map.kf_pose_cw),
                               atol=2e-4)
    assert np.array_equal(port_map.kf_point.numpy(), np.asarray(jax_map.kf_point))
    d = np.abs(port_map.pt_pos.numpy() - np.asarray(jax_map.pt_pos)).max(axis=1)
    bad = np.nonzero(d > np.maximum(1e-2, spread))[0]
    assert bad.size == 0, (bad, d[bad], np.broadcast_to(spread, d.shape)[bad])


def test_distributed_local_ba_matches_single_device(golden, ranks2):
    assert all(o["local_ba"]["equal_single"] for o in ranks2)
    m, cam = golden["m"], golden["slam_cam"]
    out = ranks2[0]["local_ba"]["map"]
    jm = j_dist_ba.distributed_local_ba(m, jnp.int32(3), j_mesh.make_mesh(2), cam, jnp.ones(8))
    # The JAX package's own spread of each point over 1, 2 and 4 devices.
    pts = [np.asarray(jm.pt_pos)] + [np.asarray(x.pt_pos) for x in (
        j_local_ba.local_bundle_adjustment(m, jnp.int32(3), cam, jnp.ones(8)),
        j_dist_ba.distributed_local_ba(m, jnp.int32(3), j_mesh.make_mesh(4), cam,
                                       jnp.ones(8)))]
    spread = np.max([np.abs(a - b).max(axis=1) for a in pts for b in pts], axis=0)
    _against_jax(out, jm, spread)
    assert not np.allclose(out.kf_pose_cw.numpy(), np.asarray(m.kf_pose_cw))


def test_distributed_joint_gba_matches_single_device(golden, ranks2):
    assert all(o["joint_gba"]["equal_single"] for o in ranks2)
    out = ranks2[0]["joint_gba"]["map"]
    jm = j_dist_ba.distributed_joint_global_ba(golden["m"], j_mesh.make_mesh(2),
                                               golden["slam_cam"], jnp.ones(8),
                                               phase_iters=(5, 10))
    _against_jax(out, jm)
    terr = np.linalg.norm(out.kf_pose_cw.numpy()[:, :3, 3] - golden["poses_gt"][:, :3, 3],
                          axis=-1)
    assert float(terr.max()) < 0.05, terr


@pytest.mark.parametrize("job", ["local_ba", "joint_gba"])
def test_four_ranks_equal_single_device(ranks4, job):
    # Bit for bit on every rank of 4; the JAX comparison is the 2-rank case's.
    assert all(o[job]["equal_single"] for o in ranks4)
    _same_on_every_rank(ranks4, job)


def test_mapper_mesh_dispatch(ranks2):
    for o in ranks2:
        assert o["mapper"]["has_mesh"]
        assert o["mapper"]["equal_single"]


# -- TestShardedLiveMap ------------------------------------------------------

def test_shard_map_state_placement(ranks2):
    for o in ranks2:
        r = o["sharded_map"]
        names = convert.MapState._fields
        assert {n for n, p in zip(names, r["placements"]) if p == "shard"} == set(KF_FIELDS)
        assert r["block_kf_rows"] == 8 and r["block_pt_rows"] == 512
        assert r["gathered_equal"]


def test_process_keyframe_on_sharded_map_matches(ranks2):
    for o in ranks2:
        assert o["sharded_map"]["sharded_out"]
        assert o["sharded_map"]["process_equal"]


def test_initialize_distributed_single_process_noop():
    assert initialize_distributed(num_processes=1) is False


# -- SlamSystem with a mesh --------------------------------------------------

def test_slam_system_on_a_mesh_equals_one_process(golden, ranks2):
    p = golden["payload"]
    images, depths = p["slam_frames"]
    single = SlamSystem(p["slam_settings"], "rgbd", device="cpu")
    for i in range(N_SLAM):
        single.track_rgbd(images[i], depths[i], float(i))
    single.shutdown()
    want = single.poses_wc()
    for o in ranks2:
        r = o["slam"]
        assert r["has_mesh"] and r["keyframes"] == single.tracker.metrics["keyframes_created"]
        assert r["keyframes"] >= 2
        assert np.array_equal(r["poses_wc"], want)
        assert all(torch.equal(a, b) for a, b in zip(r["map"], single.map))


def test_mesh_refuses_a_foreign_object():
    s = convert.settings_from_reference(small_settings(bf=160.0))
    with pytest.raises(TypeError, match="DeviceMesh"):
        SlamSystem(s, "rgbd", mesh=object(), device="cpu")
