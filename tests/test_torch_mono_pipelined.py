"""Mono under the pipelined driver against the reference's on the CPU
(``torch_mono_drivers``): ``SlamSystem(settings, "mono", pipeline=True)``
on ``mono_seq``.  Both initialize at frame 1, track to frame 10, lose it,
recover through the reference keyframe at frame 12 and track to frame 15.

Per call: state, path, relocalization and keyframe counts equal; the
keyframes' frame ids, the trajectory's frames and lost flags equal; poses
within 2e-4 m and rad (measured 1.5e-4 m at frame 15); the Sim3-aligned
|dATE| <= 1e-3 m; nothing pending after ``shutdown()``.
"""

import pytest

from torch_mono_drivers import check_mono_pair, mono_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs():
    return mono_pair(pipeline=True)


def test_matches_the_reference(runs):
    check_mono_pair(runs)


def test_pipelined(runs):
    assert runs["port"].tracker.pipeline and runs["port"].tracker.chunk == 0
