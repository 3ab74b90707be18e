"""Projection-guided matching — the SearchByProjection core.

Port of ``orbslam2_tpu/ops/matcher.py`` for RGB-D tracking and local
mapping: ``ORBmatcher::SearchByProjection`` (src/ORBmatcher.cc:≈55/≈1180),
packed Hamming nearest + second neighbour under a per-source circular
window and octave band, and ``SearchForTriangulation`` (≈650).  The Hamming matrix goes through ``hamming.hamming_matrix``,
which launches the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from .extractor import Features
from .hamming import (
    TH_HIGH, TH_LOW, Matches, hamming_matrix, masked_best2, match_descriptors,
    rotation_consistency,
)


def projection_match(
    proj_uv: torch.Tensor,      # (M, 2) projected source positions
    rr2: torch.Tensor,          # (M,) squared search radius per source
    proj_level: torch.Tensor,   # (M,) predicted octave
    proj_desc: torch.Tensor,    # (M, 8) int32
    proj_valid: torch.Tensor,   # (M,) bool
    frame_xy: torch.Tensor,     # (N, 2)
    frame_level: torch.Tensor,  # (N,)
    frame_desc: torch.Tensor,   # (N, 8) int32
    frame_valid: torch.Tensor,  # (N,) bool
    level_band: int,
    max_dist: int,
    ratio: float,
    level_dir: Optional[torch.Tensor] = None,
) -> Matches:
    """Best and second Hamming neighbour inside each source's window
    (``d2 <= rr2``) and octave band.  ``level_dir`` (int scalar tensor)
    selects the motion-model octave gate: +1 forward motion (target octave
    >= source), -1 backward (<=), 0 or None the symmetric +-level_band."""
    diff = proj_uv[:, None, :] - frame_xy[None, :, :]
    d2 = (diff * diff).sum(-1)
    dl = frame_level[None, :] - proj_level[:, None]
    band_ok = dl.abs() <= level_band
    if level_dir is not None:
        band_ok = torch.where(
            level_dir > 0, dl >= 0, torch.where(level_dir < 0, dl <= 0, band_ok)
        )
    mask = (d2 <= rr2[:, None]) & band_ok & proj_valid[:, None] & frame_valid[None, :]
    best_idx, best, second = masked_best2(hamming_matrix(proj_desc, frame_desc), mask)
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
