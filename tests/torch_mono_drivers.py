"""Run the JAX ``SlamSystem`` and the port's side by side on mono through
one of the tracker's drivers, on ``tests/test_slam_e2e.py``'s ``mono_seq``
(320x240, ``make_sequence(n_frames=16, n_points=400, seed=7)``), and hold
the port to the reference.

``mono_pair(**kw)`` builds both systems with ``SlamSystem(settings,
"mono", **kw)`` (the reference's defaults otherwise: synchronous mapping,
the loop closer with the scale free), the port drawing the reference's
RANSAC samples, and feeds both the 16 frames (``torch_drivers.run_pair``);
``before(system_pair, j)`` runs ahead of call j.  The port's
initialization branch records how many inputs waited in the chunk buffer
when it ran.  ``check_mono_pair`` asserts the logs, keyframe frame ids,
trajectory frames and lost flags equal, the poses within POS_TOL_M and
ROT_TOL_RAD and the Sim3-aligned |dATE| within ``torch_drivers.ATE_TOL_M``,
the frames up to initialization tracked one at a time with nothing
buffered, and nothing buffered or pending after ``shutdown()``.
"""

import numpy as np

from orbslam2_tpu.utils import synthetic as jsyn

from test_slam_e2e import small_settings
from torch_drivers import check_pair, make_pair, run_pair

# The drivers' limit (torch_drivers): mono poses drift apart with the
# frames tracked; the per-frame slice, lost from frame 10 on, stays within
# 8.7e-6 m, the pipelined run, which recovers at frame 12 and tracks to
# frame 15, reaches 1.5e-4 m there.
POS_TOL_M = 2e-4
ROT_TOL_RAD = 2e-4
N = 16


def mono_sequence():
    s = small_settings()
    return s, jsyn.make_sequence(s.camera_model(), n_frames=N, n_points=400, seed=7)


def mono_pair(before=None, **kw):
    s, seq = mono_sequence()
    ref, port = make_pair(s, sensor="mono", **kw)
    buffered_at_init = []
    inner = port.tracker._track

    def track(frame, sensor):
        buffered_at_init.append(len(port.tracker._chunk_buf))
        return inner(frame, sensor)

    port.tracker._track = track
    logs = run_pair(ref, port, seq.images, None, range(N),
                    before=None if before is None else (lambda j, i: before(ref, port, j)))
    return dict(seq=seq, ref=ref, port=port, logs=logs, buffered_at_init=buffered_at_init)


def check_mono_pair(runs):
    ref, port = runs["ref"], runs["port"]
    check_pair(ref, port, runs["logs"], runs["seq"].poses_wc, pos_tol=POS_TOL_M,
               rot_tol=ROT_TOL_RAD, with_scale=True)
    assert port.loop_closer is None or port.loop_closer.fix_scale is False
    states = [r[0] for r in runs["logs"]["ref"]]
    init = states.index(1)
    assert init <= 2, states
    assert runs["buffered_at_init"] == [0] * (init + 1)
    tr = port.tracker
    assert not tr._chunk_buf and tr._pending_chunk is None and tr._pending is None
    assert len(tr.trajectory) == N
    assert tr.metrics["frames"] == ref.tracker.metrics["frames"]
    assert int(np.asarray(ref.map.n_kf)) >= 2
