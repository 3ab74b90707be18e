"""The pipelined tracker against the reference's on the CPU: RGB-D,
mapping on, loop closing off, 24 frames of ``tests/test_track_fused.py``'s
sequence (``small_settings(bf=160)``, ``make_sequence(seed=3)``), as its
``TestPipelinedMode`` runs it.  Frame k+1 is tracked before frame k is
resolved, so a keyframe enters the map one frame late.

Per call: state, path, relocalization and keyframe counts equal; the
keyframes' frame ids, the trajectory's frames and lost flags equal; poses
within 2e-4 m and rad; |dATE| <= 1e-3 m; nothing pending after
``shutdown()``.
"""

import pytest

from orbslam2_tpu.utils import synthetic as jsyn

from test_slam_e2e import small_settings
from torch_drivers import check_pair, make_pair, run_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 24


@pytest.fixture(scope="module")
def runs():
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=N, with_depth=True, seed=3)
    ref, port = make_pair(s, enable_loop_closing=False, pipeline=True)
    logs = run_pair(ref, port, seq.images, seq.depths, range(N))
    return dict(seq=seq, ref=ref, port=port, logs=logs)


def test_matches_the_reference(runs):
    check_pair(runs["ref"], runs["port"], runs["logs"], runs["seq"].poses_wc)


def test_drained(runs):
    tr = runs["port"].tracker
    assert tr._pending is None
    assert len(tr.trajectory) == N
    assert tr.metrics["frames"] == runs["ref"].tracker.metrics["frames"] == N - 1
