"""FAST-9/16 corner score + 3x3 NMS.

Port of ``orbslam2_tpu/ops/fast.py`` (the detector half of
``ORBextractor::ComputeKeyPointsOctTree``, src/ORBextractor.cc:≈790).
``fast_score`` and ``nms3x3`` are the plain PyTorch versions;
``fast_score_nms`` is the entry point the extractor calls: it launches the
CUDA kernel (``csrc/fast_nms.cu``) for a CUDA tensor and composes the plain
versions for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3: 16 (dy, dx) offsets clockwise from 12
# o'clock.  Arc contiguity is evaluated circularly over this order.
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)

ARC_LENGTH = 9  # FAST-9


def fast_score(image: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 corner score, (H, W) float32: the largest threshold t
    at which a 9-contiguous arc of the circle is all brighter than center+t
    or all darker than center-t; clamped at 0, and 0 in the 3-px border."""
    img = image.to(torch.float32)
    diffs = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), (0, 1)) - img for dy, dx in CIRCLE_OFFSETS]
    )

    def window_min(x):
        m = x
        for i in range(1, ARC_LENGTH):
            m = torch.minimum(m, torch.roll(x, -i, 0))
        return m

    bright = window_min(diffs).amax(0)
    dark = window_min(-diffs).amax(0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    h, w = img.shape
    interior = torch.zeros_like(score, dtype=torch.bool)
    interior[3:h - 3, 3:w - 3] = True
    return torch.where(interior, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep a pixel that is a maximum of its
    window (neighbours outside the image ignored) unless an earlier pixel
    in raster order within the window is itself a maximum of its own
    window."""
    h, w = score.shape
    nb_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    is_max = score >= nb_max
    idx = torch.arange(h * w, dtype=torch.float32, device=score.device).view(h, w)
    neg_idx = torch.where(is_max, -idx, torch.full_like(idx, -float("inf")))
    first = -F.max_pool2d(neg_idx[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(is_max & (first == idx), score, torch.zeros_like(score))


def fast_score_nms(image: torch.Tensor) -> torch.Tensor:
    """``nms3x3(fast_score(image))`` for an (H, W) float32 image: the CUDA
    kernel for a CUDA tensor, the plain versions for a CPU tensor."""
    if image.device.type == "cpu":
        return nms3x3(fast_score(image))
    from ..kernels import fast_score_nms_cuda

    return fast_score_nms_cuda(image.contiguous())
