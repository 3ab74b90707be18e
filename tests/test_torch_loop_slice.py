"""Loop closing end to end: the reference's loop test
(``tests/test_slam_e2e.py::TestLoopClosing``) through the JAX
``SlamSystem`` and the port's, both with the reference's defaults (mapping
and loop closing on, scale fixed) on the CPU.

The fixture is the reference's: ``make_loop_sequence(n_frames=84,
circle_radius=1.5, with_depth=True, seed=5)`` at 320x240 (bf 160), a
vocabulary (k=10, L=4) trained on every 6th frame's descriptors, local BA
and fuse off so that the revisit goes through BoW and Sim3 instead of
reconnecting through covisibility.  The reference inserts keyframe 16 at
frame 75, where its loop fires: edge (2, 16), 106 matches, 92 distinct,
138 Sim3 inliers, 152 projections; ATE 0.128133 m against 0.170283 m with
loop closing off.

Three runs of the port (tracker and loop closer drawing the reference's
RANSAC samples, ``torch_carried_tracker.JaxSampler``):

* from frame 0 with loop closing on, which must pass the reference's own
  assertions: every frame tracked, a loop edge spanning the circle (b - a
  > 0.5 n_kf), ATE < max(1.15 x loop-off ATE, 0.05) and < 0.5;
* from frame 0 with loop closing off, forked from the first run before
  frame 75 (loop closing changes nothing before its first correction);
* carried from the reference's whole state (map, database, loop closer,
  tracker) before frame 75: it fires the reference's edge with the
  reference's gate scalars and S_CL, its states are the reference's, its
  corrected keyframe poses are within POS_TOL / ROT_TOL of the reference's
  (measured 8.8e-5 m, 5.0e-5 rad), its points within PT_TOL + PT_RTOL |X|,
  and |dATE| <= ATE_TOL over frames 0-79, the frames up to the first
  keyframe after the loop (measured 4.9e-5 m).

Two differences are held as measured (ROADMAP Queue 3): the essential
graph's poses, 8.6e-5 m from the reference's (float32 LM through a
dense 672-unknown LU solve), move one SearchAndFuse projection across
its window: one observation of 98304
(keyframe 15, slot 313) stays unbound where the reference binds it; given
the reference's own post-graph map, the port's fuse binds it.  And the
frames after keyframe 17 (80-83, 83-84 inliers) track up to 3.3 cm apart,
so |dATE| over all 84 frames is 1.59e-3 m: held to ATE_ALL_TOL = 2e-3.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from orbslam2_tpu.models.system import Sensor, SlamSystem as JSlamSystem
from orbslam2_tpu.ops.bow import train_vocabulary
from orbslam2_tpu.ops.extractor import OrbExtractor
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem

from test_slam_e2e import small_settings
from torch_carried_tracker import JaxSampler, carry_tracker, record_sim3_gates
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

POS_TOL = 2e-4
ROT_TOL = 2e-4
PT_TOL = 1e-3
PT_RTOL = 1e-3
ATE_TOL = 1e-3
ATE_ALL_TOL = 2e-3
FLIPS_MAX = 1  # bindings the correction's fuse may flip (see above)
N_FRAMES = 84
CARRY_AT = 75  # the frame whose keyframe fires the reference's loop


def _rot_angle(R):
    R = np.asarray(R, np.float64)
    return float(np.arctan2(np.linalg.norm(R - R.T) / np.sqrt(2.0), np.trace(R) - 1.0))


def _ate(system, seq):
    return float(jsyn.ate_rmse(system.poses_wc(), seq.poses_wc, with_scale=False))


@pytest.fixture(scope="module")
def runs():
    s = small_settings(bf=160.0)
    seq = jsyn.make_loop_sequence(s.camera_model(), n_frames=N_FRAMES, circle_radius=1.5,
                                  with_depth=True, seed=5)
    ex = OrbExtractor(s.orb, s.tpu)
    descs = np.concatenate([np.asarray(f.desc)[np.asarray(f.valid)]
                            for f in (ex(seq.images[i]) for i in range(0, N_FRAMES, 6))])
    vocab = train_vocabulary(descs, k=10, levels=4, seed=0)
    ts = convert.settings_from_reference(s)
    port_vocab = convert.vocabulary_from_numpy(jax.tree.map(np.asarray, vocab))

    def mapper_off(system):
        system.local_mapper.enable_ba = False
        system.local_mapper.enable_fuse = False
        return system

    ref = mapper_off(JSlamSystem(s, Sensor.RGBD, vocabulary=vocab))
    port = mapper_off(SlamSystem(ts, "rgbd", vocabulary=port_vocab, device="cpu"))
    port.tracker._ransac_samples = JaxSampler(ref.tracker.init_key)
    port.loop_closer._ransac_samples = JaxSampler(ref.loop_closer.key)
    carried = mapper_off(SlamSystem(ts, "rgbd", vocabulary=port_vocab, device="cpu"))
    logs = {"ref": [], "port": [], "carried": []}
    record_sim3_gates(ref.loop_closer, logs["ref"])
    record_sim3_gates(port.loop_closer, logs["port"])
    states = {"ref": [], "port": [], "carried": [], "off": []}

    def track(name, system, frames):
        for i in frames:
            system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
            states[name].append(int(system.tracking_state()))

    # Frames 0-74: the reference and the port side by side, each in its own
    # thread (each library runs its kernels without the GIL).
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(track, "ref", ref, range(CARRY_AT)),
                  pool.submit(track, "port", port, range(CARRY_AT))]:
            f.result()
    assert not port.loop_closer.loop_edges  # nothing corrected yet: fork
    port_off = copy.deepcopy(port)
    port_off.loop_closer = port_off.tracker.loop_closer = None
    carry_tracker(ref, carried)
    record_sim3_gates(carried.loop_closer, logs["carried"])
    maps_at_loop = {}
    for i in range(CARRY_AT, N_FRAMES):
        for name, system in (("ref", ref), ("port", port), ("carried", carried),
                             ("off", port_off)):
            track(name, system, [i])
        if i == CARRY_AT:
            maps_at_loop = {"ref": jax.tree.map(np.asarray, ref.map),
                            "carried": jax.tree.map(np.asarray, carried.map)}
    return dict(seq=seq, ref=ref, port=port, carried=carried, off=port_off, logs=logs,
                states=states, maps_at_loop=maps_at_loop)


def test_reference_closes_its_loop_at_the_carry_frame(runs):
    ref = runs["ref"]
    assert [(a, b) for a, b, _ in ref.loop_closer.loop_edges] == [(2, 16)]
    log = runs["logs"]["ref"]
    assert len(log) == 1 and log[0]["accepted"] and log[0]["kf_c"] == 16


def test_from_frame_0_passes_the_reference_assertions(runs):
    port, seq = runs["port"], runs["seq"]
    assert all(st == 1 for st in runs["states"]["port"])
    edges = [(a, b) for a, b, _ in port.loop_closer.loop_edges]
    assert edges, "no loop edge fired on a closed circular trajectory"
    a, b = edges[0]
    n_kf = int(port.map.n_kf)
    assert b - a > 0.5 * n_kf, (edges, n_kf)
    ate_on, ate_off = _ate(port, seq), _ate(runs["off"], seq)
    assert ate_on < max(1.15 * ate_off, 0.05), (ate_on, ate_off)
    assert ate_on < 0.5
    assert port.metrics()["n_loop_closures"] == len(edges)


def test_carried_fires_the_reference_edge_with_its_gate_scalars(runs):
    ref, carried = runs["ref"], runs["carried"]
    assert all(st == 1 for st in runs["states"]["carried"])
    assert ([(a, b) for a, b, _ in carried.loop_closer.loop_edges]
            == [(a, b) for a, b, _ in ref.loop_closer.loop_edges])
    keys = ("kf_c", "kf_l", "n_matches", "n_distinct", "ransac_ok", "n_inliers", "n_proj",
            "retry", "accepted")
    got = [{k: e[k] for k in keys} for e in runs["logs"]["carried"]]
    want = [{k: e[k] for k in keys} for e in runs["logs"]["ref"]]
    assert got == want
    np.testing.assert_allclose(np.asarray(runs["logs"]["carried"][0]["S_CL"]),
                               np.asarray(runs["logs"]["ref"][0]["S_CL"]), atol=1e-4)
    assert carried.loop_closer.last_loop_kf == ref.loop_closer.last_loop_kf
    assert (list(carried.loop_closer.candidate_streak.items())
            == list(ref.loop_closer.candidate_streak.items()))


def test_carried_correction_matches_the_reference(runs):
    ref, car = runs["maps_at_loop"]["ref"], runs["maps_at_loop"]["carried"]
    kv = ref.kf_valid
    np.testing.assert_array_equal(car.kf_valid, kv)
    for k in np.nonzero(kv)[0]:
        Tr, Tc = ref.kf_pose_cw[k], car.kf_pose_cw[k]
        assert np.abs(Tr[:3, 3] - Tc[:3, 3]).max() <= POS_TOL, k
        assert _rot_angle(Tr[:3, :3].T @ Tc[:3, :3]) <= ROT_TOL, k
    assert (car.kf_point != ref.kf_point).sum() <= FLIPS_MAX
    np.testing.assert_array_equal(car.pt_valid, ref.pt_valid)
    pv = ref.pt_valid
    X = ref.pt_pos[pv]
    err = np.abs(car.pt_pos[pv] - X).max(-1)
    assert (err <= PT_TOL + PT_RTOL * np.linalg.norm(X, axis=-1)).all(), err.max()


def test_carried_trajectory_matches_the_reference(runs):
    assert runs["states"]["carried"] == runs["states"]["ref"][CARRY_AT:]
    gt = runs["seq"].poses_wc
    ref, car = runs["ref"].poses_wc(), runs["carried"].poses_wc()

    def d_ate(n):
        return float(jsyn.ate_rmse(car[:n], gt[:n], with_scale=False)
                     - jsyn.ate_rmse(ref[:n], gt[:n], with_scale=False))

    assert abs(d_ate(80)) <= ATE_TOL, d_ate(80)
    assert abs(d_ate(N_FRAMES)) <= ATE_ALL_TOL, d_ate(N_FRAMES)
