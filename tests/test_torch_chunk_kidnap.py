"""A kidnap inside a chunk, against the reference on the CPU: RGB-D,
chunk 4, mapping on, loop closing off, ``small_settings(bf=160)``, the
scenario of ``tests/test_track_fused.py``'s ``TestChunkedMode``:
``make_loop_sequence(n_frames=48, circle_radius=1.5, seed=5,
n_points=900)`` fed frames 0-23 and then 4-7, a vocabulary (k=10, L=4) on
frames 0, 4, ..., 20.

With chunk 4 the reference tracks every fed frame OK, the kidnapped ones
on the motion model, and relocalizes once, when ``shutdown()`` resolves
the last chunk (calls 21-24), with no requeue; the kidnapped frames keep
their motion-model poses, and the ATE over the fed frames is 0.4636 m,
above its own slow test's 0.3 m gate (ROADMAP Queue 3).  The port draws the
reference's RANSAC samples.  Two runs of it:

* from frame 0: per call, state, path, relocalization and keyframe
  counts equal; the keyframes' frame ids, the trajectory's frames and lost
  flags equal; the frames requeued by each chunk's relocalization walk
  equal; |dATE| <= 1e-3 m (measured 1.1e-4 m).  Its poses are not held
  to 2e-4 m: they part from the reference's by up to 5.7e-4 m, local BA's
  float32 sums in another order on a map built while tracking drifts
  (ROADMAP Queue 3, as the per-frame kidnap of
  ``test_torch_reloc_slice.py``);
* carried from the reference's state at the chunk boundary before the
  loss (fed frame 21, ``torch_carried_tracker.carry_tracker``, with the
  chained context): the same per-call log, keyframes and requeues, and
  the poses it tracked (each frame's pose relative to its reference
  keyframe, the trajectory's entry) within 2e-4 m and rad (measured
  3.6e-5 m), but frame 21's within 3e-4 m (measured 2.30e-4 m: the frame
  the per-frame reference loses first, on few inliers; ROADMAP Queue 3),
  and |dATE| <= 1e-3 m.

Both runs resolve the chunk of calls 17-20 before call 21, where the
carried run starts (the next dispatch would resolve it first).
"""

import numpy as np
import pytest

from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem

from test_slam_e2e import small_settings
from torch_carried_tracker import carry_tracker
from torch_drivers import (
    ATE_TOL_M, POS_TOL_M, ROT_TOL_RAD, check_pair, count_requeues, make_pair, record, rot_angle,
    run_pair, sequence_vocabulary,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

def _pose(T):
    return np.asarray(T.cpu() if hasattr(T, "cpu") else T, np.float64)


FEED = list(range(24)) + [4, 5, 6, 7]
CARRY_AT = 21  # calls 17-20 are the last chunk before the loss (frame 0 initializes)
# The frame the per-frame reference loses first: tracked here on few
# inliers, its pose moves with the keypoints' rounding (ROADMAP Queue 3).
WEAK_FRAME = 21
WEAK_FRAME_TOL_M = 3e-4


@pytest.fixture(scope="module")
def runs():
    s = small_settings(bf=160.0)
    seq = jsyn.make_loop_sequence(s.camera_model(), n_frames=48, circle_radius=1.5,
                                  with_depth=True, seed=5, n_points=900)
    vocab, port_vocab = sequence_vocabulary(s, seq.images, range(0, 24, 4))
    ref, port = make_pair(s, vocab, port_vocab, enable_loop_closing=False, chunk=4)
    carried = SlamSystem(convert.settings_from_reference(s), "rgbd", vocabulary=port_vocab,
                         enable_loop_closing=False, chunk=4, device="cpu")
    requeues = {"ref": count_requeues(ref), "port": count_requeues(port),
                "carried": count_requeues(carried)}
    carried_log = []

    def on_call(j, i):
        if j == CARRY_AT:
            # The chunk of calls 17-20 was tracked at call 20 and nothing
            # is buffered: resolving it now is what the next dispatch would
            # do first (both runs do).
            ref.tracker.flush()
            port.tracker.flush()
            carry_tracker(ref, carried)
        if j >= CARRY_AT:
            carried.track_rgbd(seq.images[i], seq.depths[i], float(j))
            carried_log.append(record(carried))

    logs = run_pair(ref, port, seq.images, seq.depths, FEED, before=on_call)
    carried.shutdown()
    return dict(ref=ref, port=port, carried=carried, logs=logs, carried_log=carried_log,
                gt=seq.poses_wc[FEED], requeues=requeues)


def test_from_frame_0(runs):
    check_pair(runs["ref"], runs["port"], runs["logs"], runs["gt"], poses=False)
    assert runs["requeues"]["port"] == runs["requeues"]["ref"]
    assert runs["port"].metrics()["relocalizations"] == runs["ref"].metrics()["relocalizations"]


def test_carried_from_the_chunk_boundary(runs):
    assert runs["carried_log"] == runs["logs"]["ref"][CARRY_AT:]
    own = slice(CARRY_AT, None)
    ours, theirs = runs["carried"].tracker.trajectory[own], runs["ref"].tracker.trajectory[own]
    assert [(f, r, lost) for f, _, r, lost in ours] == [(f, r, lost) for f, _, r, lost in theirs]
    for (fid, a, _, _), (_, b, _, _) in zip(ours, theirs):
        a, b = _pose(a), _pose(b)
        tol = WEAK_FRAME_TOL_M if fid == WEAK_FRAME else POS_TOL_M
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= tol, fid
        assert rot_angle(a[:3, :3].T @ b[:3, :3]) <= ROT_TOL_RAD, fid
    carried_requeues = runs["requeues"]["carried"]
    assert carried_requeues == runs["requeues"]["ref"][-len(carried_requeues):]
    for name in ("kf_valid", "n_kf", "kf_point"):
        np.testing.assert_array_equal(getattr(runs["carried"].map, name).numpy(),
                                      np.asarray(getattr(runs["ref"].map, name)), err_msg=name)
    out, ref = runs["carried"].poses_wc(), runs["ref"].poses_wc()
    assert out.shape == ref.shape == (len(FEED), 4, 4)
    assert abs(jsyn.ate_rmse(out, runs["gt"], with_scale=False)
               - jsyn.ate_rmse(ref, runs["gt"], with_scale=False)) <= ATE_TOL_M
