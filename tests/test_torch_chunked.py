"""The chunked tracker against the reference's on the CPU: RGB-D, mapping
on, loop closing off, on ``tests/test_track_fused.py``'s sequence
(``small_settings(bf=160)``, ``make_sequence(seed=3)``), as its
``TestChunkedMode`` runs it: chunk 4 over 24 frames, and chunk 5 over 23,
so that the last two frames go through ``flush``.

Per call: state, path, relocalization and keyframe counts equal; the
keyframes' frame ids, the trajectory's frames and lost flags equal; poses
within 2e-4 m and rad; |dATE| <= 1e-3 m; nothing buffered or pending after
``shutdown()``.
"""

import numpy as np
import pytest

from orbslam2_tpu.utils import synthetic as jsyn

from test_slam_e2e import small_settings
from torch_drivers import check_pair, make_pair, run_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", params=[(4, 24), (5, 23)], ids=["chunk4x24", "chunk5x23"])
def runs(request):
    chunk, n = request.param
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=n, with_depth=True, seed=3)
    ref, port = make_pair(s, enable_loop_closing=False, chunk=chunk)
    logs = run_pair(ref, port, seq.images, seq.depths, range(n))
    return dict(seq=seq, ref=ref, port=port, logs=logs, n=n)


def test_matches_the_reference(runs):
    check_pair(runs["ref"], runs["port"], runs["logs"], runs["seq"].poses_wc)


def test_drained(runs):
    tr = runs["port"].tracker
    assert not tr._chunk_buf and tr._pending_chunk is None and tr._pending is None
    assert len(tr.trajectory) == runs["n"]
    # Frame 0 initializes; every other frame is a tracked frame.
    assert tr.metrics["frames"] == runs["ref"].tracker.metrics["frames"] == runs["n"] - 1
    assert int(np.asarray(runs["ref"].map.n_kf)) >= 3
