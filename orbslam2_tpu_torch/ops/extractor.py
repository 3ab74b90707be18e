"""The ORB extractor: pyramid -> FAST+NMS -> select -> orient -> describe.

Port of ``orbslam2_tpu/ops/extractor.py`` (``ORBextractor::operator()``,
src/ORBextractor.cc:≈1000): all levels with static shapes, producing a
fixed-capacity, masked feature set.  The detector runs through
``fast.fast_score_nms``, which launches the CUDA kernel when the image lies
on a CUDA device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OrbSettings, TpuSettings
from . import fast as fast_ops
from . import orb as orb_ops
from . import pyramid as pyr_ops
from . import select as select_ops


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (padded + masked):
      xy:       (N, 2) float32 — keypoint (x, y) in level-0 pixels
      level:    (N,)   int32   — pyramid octave
      angle:    (N,)   float32 — orientation (radians)
      response: (N,)   float32 — FAST corner score
      desc:     (N, 8) int32   — packed 256-bit rBRIEF (uint32 bits)
      valid:    (N,)   bool
    """

    xy: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def _extract(
    image: torch.Tensor,
    n_levels: int,
    scale_factor: float,
    min_th: float,
    capacity: int,
    per_level: tuple,
    cell: int,
) -> Features:
    dev = image.device
    levels = pyr_ops.build_pyramid(image.to(torch.float32), n_levels, scale_factor)
    scales = [float(s) for s in pyr_ops.scale_factors(n_levels, scale_factor)]

    xs, lvls, resps, valids, patches = [], [], [], [], []
    for li, img in enumerate(levels):
        score = fast_ops.fast_score_nms(img)
        score = torch.where(score >= min_th, score, torch.zeros_like(score))
        xy, resp, valid = select_ops.select_keypoints(score, per_level[li], cell=cell)
        # One 31x31 patch per keypoint from the blurred level feeds both
        # the orientation and the descriptor.
        patches.append(orb_ops.extract_patches(pyr_ops.gaussian_blur(img), xy))
        xs.append(xy * scales[li])
        lvls.append(torch.full((per_level[li],), li, dtype=torch.int32, device=dev))
        resps.append(resp)
        valids.append(valid)

    xy = torch.cat(xs)
    lvl = torch.cat(lvls)
    resp = torch.cat(resps)
    valid = torch.cat(valids)
    pat = torch.cat(patches)
    ang = orb_ops.orientations_from_patches(pat)
    desc = orb_ops.descriptors_from_patches(pat, ang)

    n = xy.shape[0]
    if n < capacity:
        pad = capacity - n
        xy = torch.cat([xy, xy.new_zeros((pad, 2))])
        lvl = torch.cat([lvl, lvl.new_zeros(pad)])
        ang = torch.cat([ang, ang.new_zeros(pad)])
        resp = torch.cat([resp, resp.new_zeros(pad)])
        desc = torch.cat([desc, desc.new_zeros((pad, 8))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    elif n > capacity:
        # Keep the strongest ``capacity`` features overall.
        top_resp, idx = select_ops.topk_stable(
            torch.where(valid, resp, torch.full_like(resp, -1.0)), capacity
        )
        xy, lvl, ang, desc = xy[idx], lvl[idx], ang[idx], desc[idx]
        resp, valid = top_resp, top_resp > 0.0

    return Features(xy=xy, level=lvl, angle=ang, response=resp, desc=desc, valid=valid)


class OrbExtractor:
    """Configured extractor: ``feats = extractor(image)``.

    ``image``: (H, W) uint8/float32 grayscale (tensor or array); it is
    moved to ``device``.  Output capacity is ``tpu.max_keypoints``.
    """

    def __init__(self, orb: OrbSettings, tpu: TpuSettings, cell: int = 32,
                 device="cpu"):
        self.orb = orb
        self.tpu = tpu
        self.cell = cell
        self.device = torch.device(device)
        self.per_level = tuple(
            pyr_ops.features_per_level(orb.n_features, orb.n_levels, orb.scale_factor)
        )

    def __call__(self, image) -> Features:
        return _extract(
            torch.as_tensor(image, device=self.device),
            self.orb.n_levels,
            self.orb.scale_factor,
            float(self.orb.min_th_fast),
            self.tpu.max_keypoints,
            self.per_level,
            self.cell,
        )
