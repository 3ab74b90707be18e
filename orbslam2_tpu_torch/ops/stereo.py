"""RGB-D depth association.

Port of ``orbslam2_tpu/ops/stereo.py::depth_from_depthmap``
(``Frame::ComputeStereoFromRGBD``, src/Frame.cc:≈590).  Stereo matching is
not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .extractor import Features


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
