"""Stereo matching and RGB-D depth association.

Port of ``orbslam2_tpu/ops/stereo.py``.  ``compute_stereo_matches``
(``Frame::ComputeStereoMatches``, src/Frame.cc:≈470) matches each left
keypoint to the right image's keypoints inside a band of rows, an octave
band and the disparity range, as one masked Hamming matching (the band is
the pair mask; ``hamming.match_descriptors``, whose Hamming matrix is a
kernel on the card), then refines the right u to sub-pixel by an SAD sweep
and a parabola (Frame.cc:≈540).  The sweep is plain PyTorch: an
(N, 11 sweeps, 11, 11) bilinear gather over all keypoints at once.
``depth_from_depthmap`` is ``Frame::ComputeStereoFromRGBD`` (≈590).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .extractor import Features
from .hamming import TH_HIGH, match_descriptors

_PATCH = 5     # half patch size (11x11)
_SWEEP = 5     # +-5 px disparity sweep


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` at float (y, x) of one shape, clamped
    into the image."""
    h, w = img.shape
    y = torch.clamp(y, 0.0, h - 1.001)
    x = torch.clamp(x, 0.0, w - 1.001)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    fy = y - y0
    fx = x - x0
    flat = img.reshape(-1)
    i00 = y0 * w + x0
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + w]
    v11 = flat[i00 + w + 1]
    return (
        v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx) + v11 * fy * fx
    )


def _subpixel_refine(
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    xl: torch.Tensor,
    yl: torch.Tensor,
    xr0: torch.Tensor,
    step: torch.Tensor,
) -> torch.Tensor:
    """Per-keypoint sub-pixel right u by an SAD sweep and a parabola at the
    keypoint's octave scale ``step`` (the reference refines on the octave's
    image): 11x11 patches spaced ``step`` apart, sampled bilinearly from the
    level-0 images, centre-normalized, compared at 11 shifts of ``step``
    around ``xr0``; the first SAD minimum, clamped to the interior, is
    refined by a parabola through its neighbours (offset clamped to +-1).
    xl / yl / xr0 / step (N,) float32; returns (N,) float32."""
    dev = xl.device
    offs = torch.arange(-_PATCH, _PATCH + 1, dtype=torch.float32, device=dev)
    sweeps = torch.arange(-_SWEEP, _SWEEP + 1, dtype=torch.float32, device=dev)
    s = step[:, None]
    gy = yl[:, None] + offs * s                                  # (N, 11)
    gxl = xl[:, None] + offs * s                                 # (N, 11)
    pl = _bilinear(img_left, gy[:, :, None].expand(-1, -1, 11), gxl[:, None, :].expand(-1, 11, -1))
    pl = pl - pl[:, _PATCH, _PATCH, None, None]                  # (N, 11, 11)
    # gx[n, o, k] = xr0 + sweep_o * s + offs_k * s, summed in that order.
    gx = (xr0[:, None] + sweeps * s)[:, :, None] + (offs * s)[:, None, :]   # (N, 11, 11)
    n = xl.shape[0]
    pr = _bilinear(img_right, gy[:, None, :, None].expand(n, 11, 11, 11),
                   gx[:, :, None, :].expand(n, 11, 11, 11))      # (N, sweep, 11, 11)
    pr = pr - pr[:, :, _PATCH, _PATCH, None, None]
    sads = (pl[:, None] - pr).abs().sum((-2, -1))                # (N, 11)
    best = torch.argmin(sads, dim=1)
    bi = torch.clamp(best, 1, 2 * _SWEEP - 1)
    s0 = sads.gather(1, (bi - 1)[:, None])[:, 0]
    s1 = sads.gather(1, bi[:, None])[:, 0]
    s2 = sads.gather(1, (bi + 1)[:, None])[:, 0]
    denom = s0 - 2.0 * s1 + s2
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (s0 - s2) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    return xr0 + (sweeps[bi] + delta) * step


def compute_stereo_matches(
    left: Features,
    right: Features,
    image_left: torch.Tensor,
    image_right: torch.Tensor,
    scale_factors: torch.Tensor,
    bf: float,
    min_disp: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ur, depth) per left keypoint, -1 where unmatched.  Candidates: the
    right keypoints within 2 x scale(level_l) rows, one octave and a
    disparity in (min_disp, bf]; the best Hamming match among them
    (TH_HIGH, no ratio test, no cross-check), refined to sub-pixel, and kept
    if the refined disparity is still in range."""
    lvl = torch.clamp(left.level, 0, scale_factors.shape[0] - 1).long()
    r = 2.0 * scale_factors[lvl]
    dv = (left.xy[:, None, 1] - right.xy[None, :, 1]).abs()
    band = dv <= r[:, None]
    level_ok = (left.level[:, None] - right.level[None, :]).abs() <= 1
    disp = left.xy[:, None, 0] - right.xy[None, :, 0]
    disp_ok = (disp > min_disp) & (disp <= bf)
    m = match_descriptors(
        left.desc, left.valid, right.desc, right.valid,
        pair_mask=band & level_ok & disp_ok, max_dist=TH_HIGH, ratio=1.0,
    )
    xr0 = right.xy[m.idx, 0]
    ur = _subpixel_refine(
        image_left.to(torch.float32), image_right.to(torch.float32),
        left.xy[:, 0], left.xy[:, 1], xr0, scale_factors[lvl],
    )
    matched_disp = left.xy[:, 0] - ur
    ok = m.ok & (matched_disp > min_disp) & (matched_disp <= bf)
    neg = torch.full_like(ur, -1.0)
    ur = torch.where(ok, ur, neg)
    depth = torch.where(ok, bf / torch.clamp(matched_disp, min=1e-6), neg)
    return ur, depth


def depth_from_depthmap(
    feats: Features, depth_map: torch.Tensor, bf: float, depth_factor: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample the raw-coordinate depth map at each keypoint and synthesize
    the virtual right-image coordinate ur = u - bf/z.  Returns (ur, depth),
    both -1 where there is no depth."""
    h, w = depth_map.shape
    xi = torch.clamp(torch.round(feats.xy[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(feats.xy[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_map[yi, xi] / max(depth_factor, 1e-9)
    ok = (d > 0.0) & feats.valid
    neg = torch.full_like(d, -1.0)
    ur = torch.where(ok, feats.xy[:, 0] - bf / torch.clamp(d, min=1e-9), neg)
    depth = torch.where(ok, d, neg)
    return ur, depth
