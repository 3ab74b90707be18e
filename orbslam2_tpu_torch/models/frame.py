"""Per-image working set: extraction + undistortion + depth association.

Port of ``orbslam2_tpu/models/frame.py`` (``Frame``, src/Frame.cc): the
mono, stereo and RGB-D constructors.  The stereo constructor extracts the
left and the right image one after the other, as the reference package
does (the reference runs two extraction threads, Frame.cc:≈110).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import stereo as stereo_ops
from ..ops.extractor import Features, OrbExtractor
from ..utils.camera import CameraModel, undistort_points


class Frame(NamedTuple):
    """Fixed-capacity frame: Features + stereo/depth channels.  ``xy`` is
    undistorted level-0 coords (Frame::mvKeysUn); ur/depth < 0 where
    unavailable."""

    xy: torch.Tensor        # (N, 2) undistorted
    level: torch.Tensor     # (N,) int32
    angle: torch.Tensor     # (N,)
    response: torch.Tensor  # (N,)
    desc: torch.Tensor      # (N, 8) int32 (uint32 bits)
    valid: torch.Tensor     # (N,) bool
    ur: torch.Tensor        # (N,) stereo right-u
    depth: torch.Tensor     # (N,)

    @property
    def features(self) -> Features:
        return Features(
            xy=self.xy, level=self.level, angle=self.angle,
            response=self.response, desc=self.desc, valid=self.valid,
        )


def build_mono_frame(image, extractor: OrbExtractor, cam: CameraModel) -> Frame:
    f = extractor(image)
    none = torch.full_like(f.response, -1.0)
    return Frame(
        xy=undistort_points(cam, f.xy), level=f.level, angle=f.angle,
        response=f.response, desc=f.desc, valid=f.valid, ur=none, depth=none,
    )


def build_stereo_frame(
    image_left, image_right, extractor: OrbExtractor, cam: CameraModel,
    scale_factors: torch.Tensor,
) -> Frame:
    """Extract both images, then match left to right for ur and depth
    (``ops.stereo.compute_stereo_matches``); keypoints are the left ones."""
    image_left = torch.as_tensor(image_left, dtype=torch.float32, device=extractor.device)
    image_right = torch.as_tensor(image_right, dtype=torch.float32, device=extractor.device)
    left = extractor(image_left)
    right = extractor(image_right)
    ur, depth = stereo_ops.compute_stereo_matches(
        left, right, image_left, image_right, scale_factors, cam.bf
    )
    return Frame(
        xy=undistort_points(cam, left.xy), level=left.level, angle=left.angle,
        response=left.response, desc=left.desc, valid=left.valid, ur=ur, depth=depth,
    )


def build_rgbd_frame(
    image, depth_map, extractor: OrbExtractor, cam: CameraModel,
    depth_factor: float = 1.0,
) -> Frame:
    f = extractor(image)
    depth_map = torch.as_tensor(depth_map, dtype=torch.float32, device=extractor.device)
    ur, depth = stereo_ops.depth_from_depthmap(f, depth_map, cam.bf, depth_factor)
    return Frame(
        xy=undistort_points(cam, f.xy), level=f.level, angle=f.angle,
        response=f.response, desc=f.desc, valid=f.valid, ur=ur, depth=depth,
    )
