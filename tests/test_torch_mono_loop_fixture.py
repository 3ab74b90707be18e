"""The firing step of the reference's own mono loop fixture on the CPU
(``tests/test_slam_e2e.py::test_mono_loop_closure_production_config``:
``small_settings(bf=0)`` at 320x240 with 800 features and pools of 160
keyframes and 16384 points, ``make_loop_sequence(n_frames=280,
circle_radius=2.5, seed=6, n_points=2500)`` without depth, a vocabulary
(k=10, L=4) trained on every 6th frame).

The reference's state just before the ``process_keyframe`` that fires its
first loop (keyframe 94, frame 228, edge (2, 94)) is committed in
``tests/torch_mono_loop_state.npz`` (``tools/torch_mono_loop_state.py``).
The reference is rebuilt from it with numpy, the port through ``convert``
(``chip_smoke.mono_loop_objects``), which draws the reference's samples
(``JaxSampler``); both run that ``process_keyframe``, and the reference
gives the recorded run's edge, S_CL and corrected poses again.

The verification's last stage polishes S_CL on one-directional
reprojections, which a Sim3's scale leaves unchanged when the
translation scales with it (pi(s R p + t) = pi(R p + t / s)).  The
reference frees the scale there anyway, and its scale then follows
rounding: from its own inputs, changed by 1e-6, its polish ends anywhere
in a wide range (held below).  The port keeps OptimizeSim3's scale in the
polish, which two-way reprojections observe (its one departure from the
reference, ROADMAP Queue 3).  So the port is held to the reference:

* the edge (2, 94) and the last loop keyframe, with the reference's draws;
* S_CL's rotation within S_ROT_TOL and its translation over its scale
  (t / s) within S_TDIR_TOL (measured 6.4e-4 rad and 5.4e-4), and its
  scale within S_SCALE_RTOL of the reference's OptimizeSim3 scale,
  0.882795 (measured 0.896109, 1.5% off: the two RANSACs pick different
  minimal samples, one of them with a repeated point);
* the correction of the fixture's map with the reference's S_CL: the
  corrected poses within 1e-4 (measured 1.6e-6), points within 1e-3 m +
  1e-3 |X| (measured 6.1e-5 m), the GBA's segment decisions, and the
  map's integer and boolean fields equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orbslam2_tpu.models import loop_closing as jlc
from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.models.kf_database import KeyframeDatabase as JKeyframeDatabase
from orbslam2_tpu.ops.bow import Vocabulary as JVocabulary
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import loop_closing as tlc

from test_slam_e2e import small_settings
from torch_carried_tracker import JaxSampler
from torch_drivers import rot_angle
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

S_ROT_TOL = 2e-3      # rad
S_TDIR_TOL = 2e-3     # t / s
S_SCALE_RTOL = 0.03   # against the reference's OptimizeSim3 scale
POSE_TOL = 1e-4       # entries of the corrected T_cw
PT_TOL, PT_RTOL = 1e-3, 1e-3


def _scale(S):
    return float(np.cbrt(np.linalg.det(np.asarray(S, np.float64)[:3, :3])))


def reference_objects(arrays, meta, s):
    """The reference's map and loop closer rebuilt from the state."""
    m = jms.MapState(**{k[4:]: jnp.asarray(v) for k, v in arrays.items()
                        if k.startswith("map.")})
    vocab = JVocabulary(**{k: jnp.asarray(arrays["vocab." + k])
                           for k in ("node_desc", "children", "word_id", "idf")},
                        levels=meta["vocab_levels"])
    db = JKeyframeDatabase(vocab, m.kf_capacity, feat_capacity=meta["feat_capacity"])
    assert db.sparse == meta["sparse"]
    for k, v in arrays.items():
        if k.startswith("db."):
            setattr(db, k[3:], jnp.asarray(v))
    lc = jlc.LoopCloser(s, db, fix_scale=False)
    lc.candidate_streak = {tuple(g): n for g, n in meta["streak"]}
    lc.loop_edges = [(a, b, S) for (a, b), S in zip(meta["edges"], arrays["edges.S"])]
    lc.last_loop_kf = meta["last_loop_kf"]
    lc.key = jnp.asarray(arrays["key"])
    return m, lc


@pytest.fixture(scope="module")
def fired():
    arrays, meta = chip_smoke.mono_loop_state()
    s = small_settings(bf=0.0)
    s = dataclasses.replace(s, tpu=dataclasses.replace(s.tpu, max_keyframes=160,
                                                       max_points=16384))
    ts = convert.settings_from_reference(s)
    assert ts == chip_smoke.mono_loop_settings()
    kf = meta["kf_id"]
    jm, ref_lc = reference_objects(arrays, meta, s)
    recorded = {}
    optimize, polish = jlc.optimize_sim3, jlc.refine_sim3_on_projections

    def optimize_recorded(*a, **kw):
        out = optimize(*a, **kw)
        recorded["opt_S"] = np.asarray(out.S12)
        return out

    def polish_recorded(*a, **kw):
        recorded["polish"] = (a, kw)
        return polish(*a, **kw)

    jlc.optimize_sim3, jlc.refine_sim3_on_projections = optimize_recorded, polish_recorded
    try:
        want = jax.tree.map(np.asarray, ref_lc.process_keyframe(jm, kf))
    finally:
        jlc.optimize_sim3, jlc.refine_sim3_on_projections = optimize, polish
    tm, _, port_lc = chip_smoke.mono_loop_objects(arrays, meta, ts, "cpu")
    sampler = JaxSampler(jnp.asarray(arrays["key"]))
    drawn = []

    def draw(valid, iters, k):
        out = sampler(valid, iters, k)
        drawn.append(out.numpy().copy())
        return out

    port_lc._ransac_samples = draw
    witness = chip_smoke.FiringWitness(ts)  # records only
    witness.attach(port_lc)
    got = port_lc.process_keyframe(tm, kf)
    return dict(arrays=arrays, meta=meta, ts=ts, ref_lc=ref_lc, want=want, port_lc=port_lc,
                got=got, drawn=drawn, recorded=recorded, witness=witness)


def test_the_reference_fires_as_recorded(fired):
    arrays, meta, ref_lc, want = fired["arrays"], fired["meta"], fired["ref_lc"], fired["want"]
    res = meta["result"]
    assert [[a, b] for a, b, _ in ref_lc.loop_edges] == res["loop_edges"] == [res["edge"]]
    np.testing.assert_allclose(np.asarray(ref_lc.loop_edges[0][2]), res["S_CL"], atol=1e-6)
    kv = want.kf_valid
    np.testing.assert_allclose(want.kf_pose_cw[kv], arrays["out.kf_pose_cw"][kv], atol=1e-6)
    # The fixture's own gates, on the reference's whole run.
    assert res["frames_lost"] <= 0.05 * res["sequence"]["n_frames"]
    a, b = res["edge"]
    assert b - a > 0.5 * res["n_kf"] and res["ate_sim3_m"] < 0.7


def test_the_port_fires_the_same_edge(fired):
    ref_lc, port_lc = fired["ref_lc"], fired["port_lc"]
    assert [(a, b) for a, b, _ in port_lc.loop_edges] == [(a, b) for a, b, _ in
                                                          ref_lc.loop_edges] == [(2, 94)]
    assert port_lc.last_loop_kf == ref_lc.last_loop_kf == fired["meta"]["kf_id"]
    # The reference's draws, all of them, through JaxSampler.
    assert len(fired["drawn"]) == len(fired["arrays"]["draws"])
    for x, y in zip(fired["drawn"], fired["arrays"]["draws"]):
        np.testing.assert_array_equal(x, y)
    S_ref = np.asarray(ref_lc.loop_edges[0][2], np.float64)
    S_port = np.asarray(port_lc.loop_edges[0][2], np.float64)
    s_ref, s_port = _scale(S_ref), _scale(S_port)
    d_rot = rot_angle((S_ref[:3, :3] / s_ref).T @ (S_port[:3, :3] / s_port))
    d_tdir = np.abs(S_ref[:3, 3] / s_ref - S_port[:3, 3] / s_port).max()
    assert d_rot <= S_ROT_TOL and d_tdir <= S_TDIR_TOL, (d_rot, d_tdir)
    s_opt = _scale(fired["recorded"]["opt_S"])
    assert abs(s_opt - chip_smoke.MONO_LOOP_REF_OPT_SCALE) <= 1e-6
    assert abs(s_port / s_opt - 1.0) <= S_SCALE_RTOL, (s_port, s_opt)


def test_the_polish_cannot_observe_the_scale(fired):
    """The reference's polish from its own inputs and from them with S0
    changed by 1e-6 ends at scales far apart, with the same rotation and t
    / s; the port's keeps S0's scale and finds that rotation and t / s."""
    a, kw = fired["recorded"]["polish"]
    S0 = np.asarray(a[0])
    assert kw.get("fix_scale", a[6] if len(a) > 6 else None) is False
    outs = []
    for eps in (0.0, 1e-6, -1e-6):
        S0e = S0.copy()
        S0e[:3, :] *= np.float32(1.0 + eps)
        outs.append(np.asarray(jlc.refine_sim3_on_projections(jnp.asarray(S0e), *a[1:], **kw),
                               np.float64))
    scales = [_scale(S) for S in outs]
    assert max(scales) / min(scales) > 1.1, scales
    for S in outs[1:]:
        assert rot_angle((outs[0][:3, :3] / scales[0]).T @ (S[:3, :3] / _scale(S))) <= S_ROT_TOL
    port = tlc.refine_sim3_on_projections(
        torch.from_numpy(S0), *(torch.from_numpy(np.array(x)) for x in a[1:5]),
        fired["ts"].camera_model()).numpy().astype(np.float64)
    assert abs(_scale(port) - _scale(S0)) <= 1e-6
    d_rot = rot_angle((outs[0][:3, :3] / scales[0]).T @ (port[:3, :3] / _scale(port)))
    d_tdir = np.abs(outs[0][:3, 3] / scales[0] - port[:3, 3] / _scale(port)).max()
    assert d_rot <= S_ROT_TOL and d_tdir <= S_TDIR_TOL, (d_rot, d_tdir)


def test_the_port_corrects_as_the_reference(fired):
    """``_correct_loop`` on the fixture's map with the reference's S_CL."""
    arrays, meta, want = fired["arrays"], fired["meta"], fired["want"]
    tm, _, port_lc = chip_smoke.mono_loop_objects(arrays, meta, fired["ts"], "cpu")
    S_ref = np.asarray(fired["ref_lc"].loop_edges[0][2], np.float32)
    got = port_lc._correct_loop(tm, meta["kf_id"], 2, S_ref)
    kv = want.kf_valid
    np.testing.assert_allclose(got.kf_pose_cw.numpy()[kv], want.kf_pose_cw[kv], atol=POSE_TOL)
    # The correction moved the current side of the loop.
    before = np.linalg.inv(arrays["map.kf_pose_cw"][kv].astype(np.float64))
    after = np.linalg.inv(want.kf_pose_cw[kv].astype(np.float64))
    assert np.abs(after[:, :3, 3] - before[:, :3, 3]).max() > 0.05
    pv = want.pt_valid
    X = want.pt_pos[pv]
    err = np.abs(got.pt_pos.numpy()[pv] - X).max(-1)
    assert (err <= PT_TOL + PT_RTOL * np.linalg.norm(X, axis=-1)).all(), err.max()
    for name in ("kf_point", "kf_valid", "pt_valid", "pt_ref_kf", "kf_parent", "n_kf", "n_pt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
    assert port_lc.metrics == fired["ref_lc"].metrics == {"gba_rejected_segments": 1}


def test_the_firing_witness_reruns_the_accepted_verification(fired):
    """chip_smoke's FiringWitness (phase 17(b)) on the CPU: it keeps the
    accepted verification's inputs and its rerun agrees; a gate scalar or
    draws the rerun does not repeat make it fail."""
    meta, lc, witness = fired["meta"], fired["port_lc"], fired["witness"]
    assert [rec["kf"] for rec in witness.fired] == [(meta["kf_id"], 2)]
    lines = witness.check(lc)
    assert len(lines) == 1 and "S_CL rotation 0.000e+00 rad, t / s 0.000e+00" in lines[0]
    rec = witness.fired[0]
    gates, drawn = list(rec["gates"]), list(rec["drawn"])
    g, kw, out = gates[-1]
    rec["gates"][-1] = ([g[0] + 1] + g[1:], kw, out)
    with pytest.raises(AssertionError, match="gate scalars"):
        witness.check(lc)
    rec["gates"] = gates
    rec["drawn"] = [(v, torch.zeros_like(x)) for v, x in drawn]
    with pytest.raises(AssertionError):
        witness.check(lc)
