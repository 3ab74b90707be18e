"""Mono under the chunked driver against the reference's on the CPU
(``torch_mono_drivers``): ``SlamSystem(settings, "mono", chunk=5)`` on
``mono_seq``, mapping synchronous.  Frames 0 and 1 initialize one at a
time (the doubled budget; the chunk buffer stays empty); frames 2-11 go
in two chunks of 5, built with the mono frame builder and with no
close-depth points spawned, and frames 12-15 through ``flush``.

Per call: state, path, relocalization and keyframe counts equal; the
keyframes' frame ids, the trajectory's frames and lost flags equal; poses
within 2e-4 m and rad (measured 1.2e-5 m); the Sim3-aligned |dATE| <=
1e-3 m; nothing buffered or pending after ``shutdown()``.
"""

import numpy as np
import pytest

from torch_mono_drivers import check_mono_pair, mono_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs():
    return mono_pair(chunk=5)


def test_matches_the_reference(runs):
    check_mono_pair(runs)


def test_chunks_and_the_map(runs):
    port, ref = runs["port"], runs["ref"]
    assert port.tracker.metrics["chunks"] == 2
    # A mono keyframe spawns no close-depth points: the map's integer
    # fields are the reference's.
    assert bool((port.map.kf_ur[port.map.kf_valid] < 0).all())
    for name in ("kf_valid", "kf_point", "kf_parent", "kf_frame_id", "n_kf", "pt_valid"):
        np.testing.assert_array_equal(getattr(port.map, name).numpy(),
                                      np.asarray(getattr(ref.map, name)), err_msg=name)
