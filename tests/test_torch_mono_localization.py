"""Mono localization-only mode against the reference's on the CPU
(``torch_mono_drivers``): ``SlamSystem(settings, "mono")`` maps frames 0-9
of ``mono_seq``, then ``activate_localization_mode()`` and frames 10-15
are tracked, or relocalized, against the frozen map.  Mono spawns no
temporary VO points (it has no depth), in the reference
(``track_fused.py``'s ``use_temp``) as in the port, and relocalizes
LOST frames through the keyframe database with P3P on map points alone.

Per call: state, path, relocalization and keyframe counts equal; no
keyframe or point added in localization mode by either; the keyframes'
frame ids, the trajectory's frames and lost flags equal; poses within
2e-4 m and rad; the Sim3-aligned |dATE| <= 1e-3 m.
"""

import numpy as np
import pytest

from torch_mono_drivers import check_mono_pair, mono_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_SLAM = 10


@pytest.fixture(scope="module")
def runs():
    sizes = {"ref": [], "port": []}

    def before(ref, port, j):
        if j == N_SLAM:
            ref.activate_localization_mode()
            port.activate_localization_mode()
        if j >= N_SLAM:
            for name, system in (("ref", ref), ("port", port)):
                sizes[name].append((int(np.asarray(system.map.n_kf)),
                                    int(np.asarray(system.map.pt_valid).sum())))

    out = mono_pair(before=before)
    out["sizes"] = sizes
    return out


def test_matches_the_reference(runs):
    check_mono_pair(runs)


def test_frozen_map(runs):
    ref, port = runs["ref"], runs["port"]
    assert port.localization_only and port.tracker.local_mapper is None
    for name, system in (("ref", ref), ("port", port)):
        final = (int(np.asarray(system.map.n_kf)), int(np.asarray(system.map.pt_valid).sum()))
        assert all(s == final for s in runs["sizes"][name]), (name, runs["sizes"][name])
    assert runs["sizes"]["port"] == runs["sizes"]["ref"]
    created = [r[3] for r in runs["logs"]["ref"]]
    assert created[N_SLAM:] == [created[N_SLAM - 1]] * (len(created) - N_SLAM)
