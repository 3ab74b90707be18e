"""A blackout inside a chunk, against the reference on the CPU: RGB-D,
chunk 4, mapping on, loop closing off, ``small_settings(bf=160)``, the
scenario of ``tests/test_track_fused.py``'s ``TestChunkedMode``:
``make_sequence(seed=3)``, 24 frames, frame 13 zeroed (the first of the
chunk [13..16]: frame 0 initializes, the chunks are 1-4, 5-8, ...), a
vocabulary (k=10, L=4) on every 4th frame.

The reference loses frame 13 and, through the chunk's relocalization walk
(every lost frame of a chunk built again and relocalized in turn), never
recovers: frames 13-23 are lost (its own slow test expects only frame 13
bad; ROADMAP Queue 3).  The port draws the reference's RANSAC samples and
is held to that run: per call, state, path, relocalization and keyframe
counts equal; the keyframes' frame ids, the trajectory's frames and lost
flags (the bad tail) equal; the frames requeued by each walk equal; poses
within 2e-4 m and rad (measured 9.7e-6 m); |dATE| <= 1e-3 m.
"""

import numpy as np
import pytest

from orbslam2_tpu.utils import synthetic as jsyn

from test_slam_e2e import small_settings
from torch_drivers import check_pair, count_requeues, make_pair, run_pair, sequence_vocabulary
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs():
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=24, with_depth=True, seed=3)
    images = np.asarray(seq.images).copy()
    images[13] = 0.0
    vocab, port_vocab = sequence_vocabulary(s, images, range(0, 24, 4))
    ref, port = make_pair(s, vocab, port_vocab, enable_loop_closing=False, chunk=4)
    requeues = {"ref": count_requeues(ref), "port": count_requeues(port)}
    logs = run_pair(ref, port, images, seq.depths, range(24))
    return dict(ref=ref, port=port, logs=logs, gt=seq.poses_wc, requeues=requeues)


def test_matches_the_reference(runs):
    check_pair(runs["ref"], runs["port"], runs["logs"], runs["gt"])
    assert runs["requeues"]["port"] == runs["requeues"]["ref"]


def test_bad_tail_and_relocalization_frames(runs):
    def bad_tail(system):
        return [fid for fid, _, _, lost in system.tracker.trajectory if lost and fid >= 12]

    assert bad_tail(runs["port"]) == bad_tail(runs["ref"])
    assert bad_tail(runs["ref"])[0] == 13

    def relocs(log):
        return [j for j, r in enumerate(log) if r[1] == "reloc"]

    assert relocs(runs["logs"]["port"]) == relocs(runs["logs"]["ref"])
    # Each lost chunk's walk drew RANSAC samples where the reference did.
    assert runs["port"].tracker._ransac_samples.calls > 0
    assert len(runs["port"].tracker.trajectory) == 24
