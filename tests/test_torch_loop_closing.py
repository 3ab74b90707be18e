"""Loop closing's parts: ``orbslam2_tpu_torch.models.loop_closing``
against ``orbslam2_tpu.models.loop_closing`` on the CPU, on one map that
both packages receive as the same numpy arrays.

The map is built by the reference tracker (30 frames of the mapping
fixture, 15 keyframes; ``torch_carried_map``); the "loop" pairs its newest
keyframe (14) with keyframe 10, and S_CL is their relative pose, disturbed.
Paired with keyframes 1-9 instead, the node-gated SearchByBoW finds 5-11
matches, RANSAC fails or just passes on them, and the refinements that
follow start from a seed that a rounding moves: OptimizeSim3's inlier
count then differs by 1-7 between the packages (measured; the fixed-scale
pass on keyframe 10 and every retry pass on 1, 3, 6, 8 and 10 agree).
The loop test of ``test_torch_loop_slice.py`` has 106 matches.
The keyframe database is the reference's, filled with every keyframe and
carried across (``convert.database_from_numpy``), on a vocabulary trained
on the map's descriptors.  The Sim3 RANSAC draws the reference's samples
(``torch_carried_tracker.JaxSampler`` from the reference's key, 7).

Held exact: SearchBySim3's matches and agreement, the neighbourhood
projection's matches and count, ``kf_point`` and the point pool after
SearchAndFuse, every gate scalar of ``_sim3_pipeline`` (both passes), the
correction's ``kf_point``, loop edges and streaks, and the streak logic of
``process_keyframe`` over a scripted run of detections.  Within
tolerance: the refined Sim3 (S_TOL = 1e-4), the corrected poses (POSE_TOL
= 2e-4) and points (PT_TOL + PT_RTOL |X|, 1e-3 + 1e-3 |X|: the global BA's
landmark sums run in another order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import loop_closing as jlc
from orbslam2_tpu.models.kf_database import KeyframeDatabase as JDatabase
from orbslam2_tpu.ops.bow import train_vocabulary
from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import loop_closing as tlc
from torch_carried_map import carried_map
from torch_carried_tracker import JaxSampler
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

S_TOL = 1e-4
POSE_TOL = 2e-4
PT_TOL = 1e-3
PT_RTOL = 1e-3


@pytest.fixture(scope="module")
def loop_map():
    s, ps, m, kf_c = carried_map(30)
    ids = np.nonzero(m.kf_valid)[0]
    descs = m.kf_desc[ids][m.kf_kp_valid[ids]]
    vocab = train_vocabulary(descs.astype(np.uint32), k=10, levels=3, seed=0)
    jdb = JDatabase(vocab, s.tpu.max_keyframes, feat_capacity=m.kf_xy.shape[1])
    for k in ids:
        jdb.add_keyframe(int(k), jnp.asarray(m.kf_desc[k]), jnp.asarray(m.kf_kp_valid[k]))
    kf_l = int(ids[-5])
    T_c, T_l = m.kf_pose_cw[kf_c].astype(np.float64), m.kf_pose_cw[kf_l].astype(np.float64)
    S_true = T_c @ np.linalg.inv(T_l)
    D = np.asarray(jlie.sim3_exp(jnp.asarray([0.01, -0.005, 0.008, 0.004, -0.003, 0.002, 0.0],
                                             jnp.float32)), np.float64)
    S_CL = (D @ S_true).astype(np.float32)
    return dict(s=s, ps=ps, m=m, kf_c=int(kf_c), kf_l=kf_l, jdb=jdb, S_CL=S_CL)


def jmap(d):
    return jax.tree.map(jnp.asarray, d["m"])


def tmap(d):
    return convert.map_state_from_numpy(d["m"], "cpu")


def closers(d, fix_scale=True):
    """The reference's loop closer and the port's over the same database,
    the port drawing the reference's RANSAC samples."""
    jl = jlc.LoopCloser(d["s"], copy.copy(d["jdb"]), fix_scale=fix_scale)
    tdb = convert.database_from_numpy(d["jdb"], "cpu")
    tl = convert.loop_closer_from_numpy(jl, d["ps"], tdb, "cpu")
    tl._ransac_samples = JaxSampler(jnp.asarray(tl.reference_key))
    return jl, tl


def assert_maps_equal(out, ref, pose_tol=POSE_TOL):
    ref = jax.tree.map(np.asarray, ref)
    for name in ("kf_point", "kf_valid", "pt_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(ref, name), name)
    kv = ref.kf_valid
    np.testing.assert_allclose(out.kf_pose_cw.numpy()[kv], ref.kf_pose_cw[kv], atol=pose_tol)
    pv = ref.pt_valid
    X = ref.pt_pos[pv]
    err = np.abs(out.pt_pos.numpy()[pv] - X).max(-1)
    assert (err <= PT_TOL + PT_RTOL * np.linalg.norm(X, axis=-1)).all(), err.max()


@pytest.mark.parametrize("radius_mult", [1.0, 2.5])
def test_search_by_sim3(loop_map, radius_mult):
    d = loop_map
    cam, tcam = d["s"].camera_model(), d["ps"].camera_model()
    jl = jlc.LoopCloser(d["s"], d["jdb"], fix_scale=True)
    tl = tlc.LoopCloser(d["ps"], convert.database_from_numpy(d["jdb"], "cpu"), fix_scale=True,
                        device="cpu")
    idx_r, agree_r = jlc.search_by_sim3(jmap(d), jnp.int32(d["kf_c"]), jnp.int32(d["kf_l"]),
                                        jnp.asarray(d["S_CL"]), cam, jl.scale_factors,
                                        radius_mult=jnp.float32(radius_mult))
    idx_o, agree_o = tlc.search_by_sim3(tmap(d), d["kf_c"], d["kf_l"], torch.from_numpy(d["S_CL"]),
                                        tcam, tl.scale_factors, radius_mult=radius_mult)
    agree_r = np.asarray(agree_r)
    assert agree_r.sum() >= 10
    np.testing.assert_array_equal(agree_o.numpy(), agree_r)
    np.testing.assert_array_equal(idx_o.numpy()[agree_r], np.asarray(idx_r)[agree_r])


def test_project_loop_matches(loop_map):
    d = loop_map
    from orbslam2_tpu.models import map_state as jms
    from orbslam2_tpu_torch.models import map_state as tms

    jl = jlc.LoopCloser(d["s"], d["jdb"], fix_scale=True)
    tl = tlc.LoopCloser(d["ps"], convert.database_from_numpy(d["jdb"], "cpu"), fix_scale=True,
                        device="cpu")
    K = d["m"].kf_valid.shape[0]
    jm, tm = jmap(d), tmap(d)
    group = np.asarray(jms.covisible_row(jm, jnp.int32(d["kf_l"]))) > 0
    group |= np.arange(K) == d["kf_l"]
    np.testing.assert_array_equal(
        (tms.covisible_row(tm, d["kf_l"]) > 0).numpy() | (np.arange(K) == d["kf_l"]), group)
    ref = jlc.project_loop_matches(jm, jnp.int32(d["kf_c"]), jnp.int32(d["kf_l"]),
                                   jnp.asarray(group), jnp.asarray(d["S_CL"]),
                                   d["s"].camera_model(), jl.scale_factors)
    out = tlc.project_loop_matches(tm, d["kf_c"], d["kf_l"], torch.from_numpy(group),
                                   torch.from_numpy(d["S_CL"]), d["ps"].camera_model(),
                                   tl.scale_factors)
    ok = np.asarray(ref.ok)
    assert int(ref.n_matches) >= 10
    assert int(out.n_matches) == int(ref.n_matches)
    np.testing.assert_array_equal(out.ok.numpy(), ok)
    np.testing.assert_array_equal(out.idx.numpy()[ok], np.asarray(ref.idx)[ok])
    np.testing.assert_allclose(out.p_l.numpy(), np.asarray(ref.p_l), atol=1e-5)


def test_fuse_into_keyframe(loop_map):
    d = loop_map
    from orbslam2_tpu.models import map_state as jms
    from orbslam2_tpu_torch.models import map_state as tms
    from orbslam2_tpu_torch.ops.select import topk_stable

    jl = jlc.LoopCloser(d["s"], d["jdb"], fix_scale=True)
    tl = tlc.LoopCloser(d["ps"], convert.database_from_numpy(d["jdb"], "cpu"), fix_scale=True,
                        device="cpu")
    K = d["m"].kf_valid.shape[0]
    # The loop side: the points seen by the oldest keyframes; fused into the
    # newest, which sees some of them as points of its own.
    group = np.arange(K) <= d["kf_l"]
    jm, tm = jmap(d), tmap(d)
    seen_r = jms.points_seen_by(jm, jnp.asarray(group)) & jm.pt_valid
    _, cand_r = jax.lax.top_k(seen_r.astype(jnp.float32), 2048)
    seen_o = tms.points_seen_by(tm, torch.from_numpy(group)) & tm.pt_valid
    _, cand_o = topk_stable(seen_o.to(torch.float32), 2048)
    np.testing.assert_array_equal(cand_o.numpy(), np.asarray(cand_r))
    for kf in (d["kf_c"], d["kf_c"] - 1):
        jm = jlc._fuse_into_keyframe(jm, jnp.int32(kf), cand_r.astype(jnp.int32), seen_r[cand_r],
                                     d["s"].camera_model(), jl.scale_factors)
        tm = tlc._fuse_into_keyframe(tm, kf, cand_o, seen_o[cand_o], d["ps"].camera_model(),
                                     tl.scale_factors)
    changed = (np.asarray(jm.kf_point) != d["m"].kf_point).sum()
    assert changed > 0
    for name in ("kf_point", "pt_valid", "pt_visible", "pt_found"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      name)


@pytest.mark.parametrize("fix_scale", [True, False])
@pytest.mark.parametrize("retry", [False, True], ids=["bow", "retry"])
def test_sim3_pipeline_gate_scalars(loop_map, retry, fix_scale):
    d = loop_map
    jl, tl = closers(d, fix_scale)
    kw = (dict(node_gated=False, ratio=0.9, ransac_min=4, sim3_radius_mult=2.5) if retry
          else dict(node_gated=True, ratio=0.75))
    ref = jl._sim3_pipeline(jmap(d), d["kf_c"], d["kf_l"], **kw)
    out = tl._sim3_pipeline(tmap(d), d["kf_c"], d["kf_l"], **kw)
    assert tl.host_syncs == 1
    assert int(ref[0]) >= 5 and int(ref[6]) >= 40
    for i in range(7):  # matches, distinct, bound c/l, RANSAC ok, inliers, projections
        assert int(out[i]) == int(ref[i]), i
    if fix_scale:
        # With the scale free the last stage, the one-directional polish, is
        # blind to s and t scaled together (test_torch_sim3.py).
        np.testing.assert_allclose(out[7], ref[7], atol=S_TOL)
    np.testing.assert_array_equal(out[8], ref[8])
    np.testing.assert_array_equal(out[9], ref[9])
    gj = jl._apply_sim3_gates(jmap(d), d["kf_c"], d["kf_l"], ref)
    gt = tl._apply_sim3_gates(tmap(d), d["kf_c"], d["kf_l"], out)
    assert (gj is None) == (gt is None)
    assert {k: v for k, v in tl.metrics.items()} == jl.metrics


def test_correct_loop(loop_map):
    d = loop_map
    jl, tl = closers(d)
    S = d["S_CL"]
    ref = jl._correct_loop(jmap(d), d["kf_c"], d["kf_l"], jnp.asarray(S))
    out = tl._correct_loop(tmap(d), d["kf_c"], d["kf_l"], S)
    assert [(a, b) for a, b, _ in tl.loop_edges] == [(a, b) for a, b, _ in jl.loop_edges]
    assert tl.metrics == jl.metrics
    # The correction moved the current group.
    assert np.abs(np.asarray(ref.kf_pose_cw)[d["kf_c"]] - d["m"].kf_pose_cw[d["kf_c"]]).max() > 1e-3
    assert_maps_equal(out, ref)
    np.testing.assert_array_equal(out.pt_desc.numpy(), np.asarray(ref.pt_desc).view(np.int32))


def scripted_detections(K=16):
    """Per keyframe: (candidate ids, their covisible groups) in the order a
    database returns them: persisting, overlapping, moving and vanishing
    groups, and two candidates at once."""
    return [
        (6, [3], {3: {2}}),          # before the 8th keyframe: not looked at
        (8, [3], {3: {2, 4}}),
        (9, [4], {4: {5}}),
        (10, [5, 2], {5: {6}, 2: {1}}),       # 5 fires
        (11, [2, 6], {2: {3}, 6: {7}}),       # 6 fires (the first overlap wins)
        (12, [], {}),
        (13, [1], {1: {0, 2}}),
        (14, [1, 12], {1: {2}, 12: {11}}),
        (15, [2], {2: {12}}),                 # 2 fires
    ]


def test_streak_logic_of_process_keyframe(loop_map):
    """The consistent-group bookkeeping of LoopClosing::DetectLoop: each
    candidate's group takes the streak of the first overlapping previous
    group, plus one; 3 fires.  The database is scripted and every fired
    candidate fails its verification, in both packages."""
    d = loop_map
    jl, tl = closers(d)
    fired = {"ref": [], "port": []}
    for name, lc in (("ref", jl), ("port", tl)):
        lc._compute_sim3 = (lambda name: lambda m, c, l_: fired[name].append((c, l_)))(name)
    jm, tm = jmap(d), tmap(d)
    for kf, cands, groups in scripted_detections():
        for name, lc, m in (("ref", jl, jm), ("port", tl, tm)):
            lc.db.detect_loop_candidates = (
                lambda m_, k, extras=None, c=cands, g=groups: (np.asarray(c, np.int64),
                                                               None, g, None))
            lc.process_keyframe(m, kf)
        assert list(tl.candidate_streak.items()) == list(jl.candidate_streak.items())
    assert fired["port"] == fired["ref"] and len(fired["ref"]) >= 3


def test_carried_loop_closer_continues_as_the_reference(loop_map):
    """``convert.loop_closer_from_numpy`` carries the streaks, the last
    loop keyframe, the loop edges and the metrics; the carried closer then
    processes the same detections as the reference."""
    d = loop_map
    jl, _ = closers(d)
    jl.candidate_streak = {(2, 3, 4): 2, (6, 7): 1}
    jl.last_loop_kf = 3
    jl.loop_edges = [(1, 3, np.eye(4, dtype=np.float32))]
    jl.metrics = {"sim3_reject_bow": 2, "bow_match_counts": [(3, 2, 100, 90, 9, 2)]}
    tl = convert.loop_closer_from_numpy(jl, d["ps"], convert.database_from_numpy(d["jdb"], "cpu"),
                                        "cpu")
    assert list(tl.candidate_streak.items()) == list(jl.candidate_streak.items())
    assert tl.last_loop_kf == 3 and tl.metrics == jl.metrics
    assert [(a, b) for a, b, _ in tl.loop_edges] == [(1, 3)]
    np.testing.assert_array_equal(np.asarray(tl.reference_key), np.asarray(jl.key))
    jl2 = copy.copy(jl)
    jl2.db = copy.copy(jl.db)
    for lc in (jl2, tl):
        lc._compute_sim3 = lambda m, c, l_: None
        lc.db.detect_loop_candidates = lambda m_, k, extras=None: (
            np.asarray([3], np.int64), None, {3: {2}}, None)
    jl2.process_keyframe(jmap(d), 14)
    tl.process_keyframe(tmap(d), 14)
    assert list(tl.candidate_streak.items()) == list(jl2.candidate_streak.items()) == [((2, 3), 3)]
    # remap after a compaction drops the edges of dropped keyframes.
    kf_map = np.arange(16)
    kf_map[1] = -1
    jl2.remap(kf_map)
    tl.remap(kf_map)
    assert tl.loop_edges == jl2.loop_edges == [] and tl.last_loop_kf == jl2.last_loop_kf
