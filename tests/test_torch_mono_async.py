"""Mono with async mapping against the reference's on the CPU
(``torch_mono_drivers``): ``SlamSystem(settings, "mono",
async_mapping=True)`` on ``mono_seq``, with the schedule made
deterministic as ``test_torch_async.py`` makes it: in both packages
``poll`` and ``wait`` join the worker without setting ``abort_gba``, so
each job is adopted at the first frame boundary after it was submitted.
The adoption re-anchors the keyframes tracking inserted during a job
through the job keyframe's pose delta, inverted as a general 4x4 matrix
with no Sim3 scale taken out (the reference's ``async_pipeline.py``).

Per call: state, path and keyframe counts equal; the frames of each
adoption, the job keyframes and ``jobs_run`` equal (one job, on keyframe
2, adopted at frame 4); keyframe frame ids and
the trajectory's frames and lost flags equal; poses within 2e-4 m and rad;
the Sim3-aligned |dATE| <= 1e-3 m; no job in flight and an empty keyframe
queue after ``shutdown()``.
"""

import pytest

from orbslam2_tpu.models import async_pipeline as jap
from orbslam2_tpu_torch.models import async_pipeline as tap

from test_torch_async import _joined, _log_adoptions
from torch_mono_drivers import check_mono_pair, mono_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs():
    adoptions = {"ref": [], "port": []}

    def before(ref, port, j):
        if j == 0:
            _joined(ref.mapping_pipeline, jap.AsyncMappingPipeline._finish)
            _joined(port.mapping_pipeline, tap.AsyncMappingPipeline._finish)
            _log_adoptions(ref, adoptions["ref"])
            _log_adoptions(port, adoptions["port"])

    out = mono_pair(before=before, async_mapping=True)
    out["adoptions"] = adoptions
    return out


def test_matches_the_reference(runs):
    check_mono_pair(runs)


def test_adoptions(runs):
    ref, port = runs["ref"], runs["port"]
    assert runs["adoptions"]["port"] == runs["adoptions"]["ref"]
    # One keyframe after the initial map: one job, adopted at frame 4.
    assert port.mapping_pipeline.jobs_run == ref.mapping_pipeline.jobs_run >= 1
    assert len(runs["adoptions"]["ref"]) == ref.mapping_pipeline.jobs_run
    assert not port.tracker._kf_queue and port.mapping_pipeline.accept_keyframes()
    assert port.mapping_pipeline._thread is None or not port.mapping_pipeline._thread.is_alive()
