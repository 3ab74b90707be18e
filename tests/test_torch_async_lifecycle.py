"""The async mapping pipeline's own properties, on the port alone on the
CPU, with no wall-clock threshold, and the System lifecycle.

A mapper whose ``process_keyframe`` blocks on a ``threading.Event`` (it
ignores ``abort``, so it overruns every bounded wait): frames keep
tracking while the job is alive; keyframes beyond ``kf_queue_depth`` are
deferred; at the urgent gap ``wait(timeout)`` sets ``abort_gba`` and
returns None and the frame returns; after the release and ``shutdown()``
the queue is empty and no job is in flight.  A worker exception is raised
again in the tracking thread.  ``reset()`` followed by a run repeats a
fresh system's run exactly (synchronous mapping, loop closing on).
"""

import threading

import numpy as np
import pytest

from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.utils import synthetic

from test_slam_e2e import small_settings
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_FRAMES = 16
N_FAST = 12


def _settings(bf=160.0):
    return convert.settings_from_reference(small_settings(bf=bf))


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(_settings().camera_model(), n_frames=N_FRAMES,
                                   with_depth=True, seed=3)


@pytest.fixture(scope="module")
def fast_seq():
    """The reference's async test's sequence (tests/test_async_pipeline.py):
    the policy wants a keyframe on most frames, and the first N_FAST frames
    track with the map frozen at two keyframes."""
    return synthetic.make_sequence(_settings(32.0).camera_model(), n_frames=20,
                                   n_points=400, with_depth=True, seed=11, radius=0.5,
                                   forward=1.8)


def _blocked_system(release, calls):
    system = SlamSystem(_settings(32.0), "rgbd", enable_loop_closing=False, async_mapping=True,
                        device="cpu")
    inner = system.local_mapper.process_keyframe

    def blocked(m, kf_id, abort=None, n_now=None):
        calls.append(kf_id)
        release.wait()
        return inner(m, kf_id, abort=abort, n_now=n_now)

    system.local_mapper.process_keyframe = blocked
    tr = system.tracker
    tr.kf_queue_depth = 1
    tr.kf_urgent_gap = 2
    tr.kf_urgent_wait_s = 0.01
    return system


def test_tracking_goes_on_while_a_job_blocks(fast_seq):
    seq = fast_seq
    release, calls, waits = threading.Event(), [], []
    system = _blocked_system(release, calls)
    mp, tr = system.mapping_pipeline, system.tracker
    inner_wait = mp.wait

    def wait(timeout=None):
        res = inner_wait(timeout)
        waits.append((timeout, mp.abort_gba.is_set(), res))
        return res

    mp.wait = wait
    states, alive, queue = [], [], []
    for i in range(N_FAST):
        system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
        states.append(system.tracking_state())
        alive.append(not mp.accept_keyframes())
        queue.append(len(tr._kf_queue))
    # The first job blocks for the whole run; frames went on tracking.
    assert len(calls) == 1 and mp.jobs_run == 1
    first = alive.index(True)
    assert all(alive[first:]) and first < N_FAST - 4
    assert states == [1] * N_FAST
    # The queue never held more than its depth; later keyframes were
    # deferred (every keyframe but the submitted and the queued one).
    assert max(queue) == 1
    assert tr.metrics["keyframes_created"] == 2
    # At the urgent gap the bounded wait raised the abort and gave up.
    assert waits and all(t == 0.01 and aborted and res is None for t, aborted, res in waits)
    release.set()
    system.shutdown()
    assert not tr._kf_queue and mp.accept_keyframes() and mp._thread is None
    assert mp.jobs_run == 2 and len(system.poses_wc()) == N_FAST


def test_worker_exception_is_raised_in_the_tracking_thread(seq):
    system = SlamSystem(_settings(), "rgbd", enable_loop_closing=False, async_mapping=True,
                        device="cpu")

    def broken(m, kf_id, abort=None, n_now=None):
        raise RuntimeError("mapping failed")

    system.local_mapper.process_keyframe = broken
    with pytest.raises(RuntimeError, match="mapping failed"):
        for i in range(N_FRAMES):
            system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
            if system.mapping_pipeline._thread is not None:
                system.mapping_pipeline._thread.join()
        system.shutdown()
    assert system.mapping_pipeline._thread is None


def _run(system, seq, n):
    for i in range(n):
        system.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
    system.shutdown()
    return system.poses_wc(), {k: getattr(system.map, k).clone() for k in system.map._fields}


def test_reset_repeats_a_fresh_run(seq):
    n = 10
    system = SlamSystem(_settings(), "rgbd", device="cpu")
    _run(system, seq, 6)
    system.reset()
    assert system.tracker.frame_id == 0 and system.timestamps == []
    poses, m = _run(system, seq, n)
    fresh_poses, fresh_m = _run(SlamSystem(_settings(), "rgbd", device="cpu"), seq, n)
    np.testing.assert_array_equal(poses, fresh_poses)
    for k in m:
        assert np.array_equal(m[k].numpy(), fresh_m[k].numpy()), k
    assert system.metrics()["keyframes_created"] >= 1


def test_mapping_device_and_stereo_construct():
    s = _settings()
    system = SlamSystem(s, "rgbd", chunk=8, async_mapping=True, mapping_device="cpu",
                        device="cpu")
    assert system.mapping_pipeline.device.type == "cpu"
    assert system.tracker.chunk == 8 and system.tracker.mapping_pipeline is system.mapping_pipeline
    stereo = SlamSystem(s, "stereo", chunk=8, async_mapping=True, device="cpu")
    assert stereo.tracker.mapping_pipeline is stereo.mapping_pipeline
    stereo.shutdown()
