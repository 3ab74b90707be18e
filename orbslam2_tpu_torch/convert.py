"""State carried across from the reference package.

Functions that turn the JAX package's state, given as numpy arrays (or
anything ``numpy.asarray`` accepts), into the port's tensors on a device.
Descriptors arrive as uint32 words and become the int32 view of the same
bits.  Nothing here imports jax: callers convert with ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from . import config
from .models.frame import Frame
from .models.kf_database import KeyframeDatabase
from .models.loop_closing import LoopCloser
from .models.map_state import MapState
from .models.track_fused import TrackCtx
from .ops.bow import Vocabulary, vocabulary_from_arrays


def settings_from_reference(settings) -> config.Settings:
    """A reference ``Settings`` -> the port's, field by field."""

    def conv(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})

    return config.Settings(
        camera=conv(config.CameraSettings, settings.camera),
        orb=conv(config.OrbSettings, settings.orb),
        tpu=conv(config.TpuSettings, settings.tpu),
        sensor=settings.sensor,
        rectification=settings.rectification,
    )


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> tensor on ``device``; uint32 becomes its int32 view."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # A copy: keeps 0-d arrays 0-d (ascontiguousarray would make them 1-d)
    # and gives torch a writable, contiguous buffer.
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _fields(d) -> Mapping:
    return d._asdict() if hasattr(d, "_asdict") else d


def _named(cls, d, device):
    d = _fields(d)
    return cls(**{k: tensor_from_numpy(d[k], device) for k in cls._fields})


def map_state_from_numpy(d, device) -> MapState:
    """A reference ``MapState`` (or a dict of its arrays) -> ``MapState``."""
    return _named(MapState, d, device)


def frame_from_numpy(d, device) -> Frame:
    """A reference ``Frame`` (or a dict of its arrays) -> ``Frame``."""
    return _named(Frame, d, device)


def track_ctx_from_numpy(d, device) -> TrackCtx:
    """A reference ``TrackCtx`` (or a dict) -> ``TrackCtx``: arrays go to
    ``device``; the host-decided scalars (``only_tracking`` among them)
    become Python values."""
    d = _fields(d)
    host = {"has_velocity": bool, "weak": bool, "ref_kf": int, "frames_since_kf": int,
            "only_tracking": bool}
    return TrackCtx(**{
        k: host[k](np.asarray(d[k])) if k in host else tensor_from_numpy(d[k], device)
        for k in TrackCtx._fields
    })


def vocabulary_from_numpy(v) -> Vocabulary:
    """A reference ``Vocabulary`` (or a dict of its arrays and ``levels``)
    -> the port's, on the CPU (``Vocabulary.to`` moves it)."""
    v = _fields(v)
    return vocabulary_from_arrays(v["node_desc"], v["children"], v["word_id"], v["idf"],
                                  int(v["levels"]))


def database_from_numpy(db, device) -> KeyframeDatabase:
    """A reference ``KeyframeDatabase`` -> the port's on ``device``, its
    vocabulary and per-keyframe state (BoW rows or sparse word lists,
    entries, feature node ids) carried across."""
    K, cap = np.asarray(db.has_entry).shape[0], db._feat_capacity
    out = KeyframeDatabase(vocabulary_from_numpy(db.vocab), K, feat_capacity=cap, device=device)
    if out.sparse != db.sparse:
        raise ValueError(f"the reference database is {'sparse' if db.sparse else 'dense'} for "
                         f"{out.vocab.n_words} words, this package's would not be")
    names = ("db_words", "db_weights") if db.sparse else ("bow",)
    for name in names + ("has_entry",):
        setattr(out, name, tensor_from_numpy(getattr(db, name), device))
    if db.db_nodes is not None:
        out.db_nodes = tensor_from_numpy(db.db_nodes, device)
    return out


def loop_closer_from_numpy(lc, settings: config.Settings, database: KeyframeDatabase,
                           device) -> LoopCloser:
    """A reference ``LoopCloser`` -> the port's on ``device``, over
    ``database``: its options, loop edges (S_CL as float32), consistent
    groups (in their order), last loop keyframe and metrics carried across.
    Its RANSAC key (the position of the reference's draws) comes back as
    ``reference_key``, a uint32 array, for a caller that replays them."""
    out = LoopCloser(settings, database, fix_scale=bool(lc.fix_scale),
                     enable_gba=bool(lc.enable_gba), gba_mode=lc.gba_mode, device=device)
    out.loop_edges = [(int(a), int(b), np.array(S, np.float32)) for a, b, S in lc.loop_edges]
    out.candidate_streak = {tuple(int(k) for k in g): int(n)
                            for g, n in lc.candidate_streak.items()}
    out.last_loop_kf = int(lc.last_loop_kf)
    out.metrics = {k: (list(v) if isinstance(v, list) else v) for k, v in lc.metrics.items()}
    out.reference_key = np.asarray(lc.key, np.uint32)
    return out
