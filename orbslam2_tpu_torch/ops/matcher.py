"""Projection-guided matching — the SearchByProjection core.

Port of ``orbslam2_tpu/ops/matcher.py``: ``ORBmatcher::SearchByProjection``
(src/ORBmatcher.cc:≈55/≈1180), packed Hamming nearest + second neighbour
under a per-source circular window and octave band,
``SearchForTriangulation`` (≈650) and the monocular
``SearchForInitialization`` (≈450).

``projection_best2`` is the projection search's core: for CUDA tensors it
launches the fused kernel (``csrc/projection_best2.cu``), which never
writes the (M, N) distance matrix; CPU tensors take
``_projection_best2_plain`` (the mask + ``masked_best2`` over the plain
Hamming matrix).  Triangulation's and initialization's matching go
through ``hamming.hamming_matrix``, which launches its own kernel for CUDA
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from .extractor import Features
from .hamming import (
    TH_HIGH, TH_LOW, Matches, _hamming_plain, masked_best2, match_descriptors,
    rotation_consistency,
)


def _projection_best2_plain(
    proj_uv, rr2, proj_level, proj_desc, proj_valid,
    frame_xy, frame_level, frame_desc, frame_valid,
    level_band: int, level_dir: Optional[torch.Tensor] = None,
):
    """The plain version of ``projection_best2``: the pair mask (window,
    octave gate, validity) over the plain Hamming matrix, then
    ``masked_best2``."""
    diff = proj_uv[:, None, :] - frame_xy[None, :, :]
    d2 = (diff * diff).sum(-1)
    dl = frame_level[None, :] - proj_level[:, None]
    band_ok = dl.abs() <= level_band
    if level_dir is not None:
        band_ok = torch.where(
            level_dir > 0, dl >= 0, torch.where(level_dir < 0, dl <= 0, band_ok)
        )
    mask = (d2 <= rr2[:, None]) & band_ok & proj_valid[:, None] & frame_valid[None, :]
    return masked_best2(_hamming_plain(proj_desc, frame_desc), mask)


def projection_best2(
    proj_uv: torch.Tensor,      # (M, 2) projected source positions
    rr2: torch.Tensor,          # (M,) squared search radius per source
    proj_level: torch.Tensor,   # (M,) predicted octave (int)
    proj_desc: torch.Tensor,    # (M, 8) int32
    proj_valid: torch.Tensor,   # (M,) bool
    frame_xy: torch.Tensor,     # (N, 2)
    frame_level: torch.Tensor,  # (N,) int
    frame_desc: torch.Tensor,   # (N, 8) int32
    frame_valid: torch.Tensor,  # (N,) bool
    level_band: int,
    level_dir: Optional[torch.Tensor] = None,
):
    """(best_idx (M,) int64, best (M,) int32, second (M,) int32): the
    first-minimum column and the best and second-best Hamming distance over
    the targets inside each source's window (``d2 <= rr2``) and octave gate,
    with both sides valid; masked pairs count as distance 10000, so a row
    without a candidate gives (0, 10000, 10000).  ``level_dir`` (0-d int
    tensor) selects the motion-model octave gate: +1 forward motion
    (target octave >= source), -1 backward (<=), 0 or None the symmetric
    +-level_band.  CPU tensors take the plain version, CUDA tensors the
    kernel; anything else raises."""
    args = (proj_uv, rr2, proj_level, proj_desc, proj_valid,
            frame_xy, frame_level, frame_desc, frame_valid)
    kinds = {t.device.type for t in args + (() if level_dir is None else (level_dir,))}
    if kinds == {"cpu"}:
        return _projection_best2_plain(*args, level_band, level_dir)
    if kinds != {"cuda"}:
        raise ValueError(f"projection_best2: tensors on {sorted(kinds)}, expected all on "
                         "the CPU or all on CUDA")
    from ..kernels import projection_best2_cuda

    return projection_best2_cuda(*(t.contiguous() for t in args), level_band, level_dir)


def search_for_initialization(
    f_ref: Features,
    f_cur: Features,
    window: int = 100,
    check_rotation: bool = True,
    max_level: int = 1,
) -> Matches:
    """Windowed matching for monocular initialization
    (ORBmatcher::SearchForInitialization, src/ORBmatcher.cc:≈450): pairs
    within ``window`` px of the reference position, on the same octave, at
    most ``max_level`` (the reference package admits octaves <= 1 where
    ORB-SLAM2 keeps octave 0); cross-checked TH_LOW matching with ratio
    0.9, then the rotation histogram."""
    diff = f_ref.xy[:, None, :] - f_cur.xy[None, :, :]
    d2 = (diff * diff).sum(-1)
    pair_mask = (
        (d2 <= float(window) ** 2)
        & (f_ref.level[:, None] <= max_level)
        & (f_cur.level[None, :] <= max_level)
        & (f_ref.level[:, None] == f_cur.level[None, :])
    )
    m = match_descriptors(
        f_ref.desc, f_ref.valid, f_cur.desc, f_cur.valid,
        pair_mask=pair_mask, max_dist=TH_LOW, ratio=0.9, cross_check=True,
    )
    if check_rotation:
        m = m._replace(ok=rotation_consistency(f_ref.angle, f_cur.angle, m.idx, m.ok))
    return m


def projection_match(
    proj_uv: torch.Tensor,
    rr2: torch.Tensor,
    proj_level: torch.Tensor,
    proj_desc: torch.Tensor,
    proj_valid: torch.Tensor,
    frame_xy: torch.Tensor,
    frame_level: torch.Tensor,
    frame_desc: torch.Tensor,
    frame_valid: torch.Tensor,
    level_band: int,
    max_dist: int,
    ratio: float,
    level_dir: Optional[torch.Tensor] = None,
) -> Matches:
    """``projection_best2`` (the arguments are its own) with the
    acceptance gates on top: best <= ``max_dist`` and best < ``ratio`` x
    second."""
    best_idx, best, second = projection_best2(
        proj_uv, rr2, proj_level, proj_desc, proj_valid,
        frame_xy, frame_level, frame_desc, frame_valid, level_band, level_dir,
    )
    ok = (best <= max_dist) & proj_valid
    ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return Matches(idx=best_idx, dist=best, dist2=second, ok=ok)


def search_by_projection(
    proj_uv: torch.Tensor,
    proj_level: torch.Tensor,
    proj_desc: torch.Tensor,
    proj_valid: torch.Tensor,
    frame: Features,
    scale_factors: torch.Tensor,
    radius=7.0,
    max_dist: int = TH_HIGH,
    ratio: float = 0.9,
    level_band: int = 1,
    level_dir: Optional[torch.Tensor] = None,
) -> Matches:
    """Projection-guided matching (the SearchByProjection overloads): the
    base ``radius`` is scaled by the predicted octave's scale factor.  The
    rotation check is the caller's (``hamming.rotation_consistency``)."""
    lvl = torch.clamp(proj_level, 0, scale_factors.shape[0] - 1).long()
    r = radius * scale_factors[lvl]
    return projection_match(
        proj_uv, r * r, proj_level, proj_desc, proj_valid,
        frame.xy, frame.level, frame.desc, frame.valid,
        level_band=level_band, max_dist=max_dist, ratio=ratio,
        level_dir=level_dir,
    )


def epipolar_distance(xy1: torch.Tensor, xy2: torch.Tensor, F12: torch.Tensor) -> torch.Tensor:
    """(N1, 2) x (N2, 2) -> (N1, N2) squared distance of each x2 from the
    epipolar line x1^T F12 (ORBmatcher::CheckDistEpipolarLine,
    src/ORBmatcher.cc:≈45)."""
    x1h = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)
    lines = x1h @ F12  # (N1, 3): a x + b y + c = 0 in image 2
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c
    return (num * num) / torch.clamp(a * a + b * b, min=1e-12)


def search_for_triangulation(
    f1: Features,
    f2: Features,
    F12: torch.Tensor,
    sigma2: torch.Tensor,
    check_rotation: bool = True,
) -> Matches:
    """Epipolar-constrained matching for new-point triangulation
    (ORBmatcher::SearchForTriangulation, src/ORBmatcher.cc:≈650): the
    squared epipolar distance gate is 3.84 sigma^2 at the octave of the
    keypoint in image 2; cross-checked TH_LOW matching, then the rotation
    histogram.  The reference's epipole gate (``epipole2``) is unused on the
    RGB-D path and not ported."""
    d_epi = epipolar_distance(f1.xy, f2.xy, F12)
    th = 3.84 * sigma2[torch.clamp(f2.level, 0, sigma2.shape[0] - 1).long()]
    m = match_descriptors(
        f1.desc, f1.valid, f2.desc, f2.valid,
        pair_mask=d_epi <= th[None, :], max_dist=TH_LOW, ratio=1.0, cross_check=True,
    )
    if check_rotation:
        m = m._replace(ok=rotation_consistency(f1.angle, f2.angle, m.idx, m.ok))
    return m
