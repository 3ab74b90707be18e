"""Map checkpoint and resume.

Port of ``orbslam2_tpu/utils/checkpoint.py``.  ORB-SLAM2 itself cannot save
or reload a map; the map here is a struct of arrays, so a checkpoint is an
npz of ``MapState``'s fields under their names, and a resumed session can
localize against the loaded map at once (localization-only mode) or go on
mapping.

The file is the reference's: descriptor words (``kf_desc``, ``pt_desc``)
are stored as uint32 and come back as the int32 view of the same bits, and
the counters ``n_kf`` and ``n_pt`` are 0-d int32.  A map either package
saved loads in the other.
"""

from __future__ import annotations

import numpy as np

from ..convert import map_state_from_numpy
from ..models.map_state import MapState

_DESC_FIELDS = ("kf_desc", "pt_desc")


def save_map(m: MapState, path: str) -> None:
    arrays = {}
    for name, val in m._asdict().items():
        a = val.cpu().numpy()
        arrays[name] = a.view(np.uint32) if name in _DESC_FIELDS else a
    np.savez_compressed(path, **arrays)


def load_map(path: str, device) -> MapState:
    """The map saved at ``path``, on ``device`` (no default)."""
    with np.load(path) as z:
        return map_state_from_numpy({name: z[name] for name in MapState._fields}, device)
