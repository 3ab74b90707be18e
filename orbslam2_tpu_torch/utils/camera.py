"""Pinhole camera model with radial-tangential distortion.

Port of ``orbslam2_tpu/utils/camera.py``: ``Frame::UndistortKeyPoints``
(src/Frame.cc:≈420), ``Frame::UnprojectStereo`` (src/Frame.cc:≈630), the
projection used by the matchers and the pose optimizer, its distorted and
stereo variants.  Functions take
torch tensors, batched over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class CameraModel(NamedTuple):
    """Static per-sequence intrinsics as host Python floats.

    Each float holds an exact float32 value, so arithmetic with float32
    tensors rounds as the reference's float32 constants do.
    """

    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, float, float, float, float]  # k1, k2, p1, p2, k3
    bf: float  # stereo baseline * fx (0 for mono)
    width: int
    height: int
    # Undistorted image bounds (Frame::ComputeImageBounds, Frame.cc:≈440).
    min_x: float
    max_x: float
    min_y: float
    max_y: float

    @property
    def baseline(self) -> float:
        return _f32(self.bf / self.fx)


def _f32(x) -> float:
    return float(np.float32(x))


def make_camera(fx, fy, cx, cy, dist=None, bf=0.0, width=640, height=480) -> CameraModel:
    d = np.zeros(5, np.float32) if dist is None else np.asarray(dist, np.float32)
    if d.shape[0] < 5:
        d = np.concatenate([d, np.zeros(5 - d.shape[0], np.float32)])
    cam = CameraModel(
        fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
        dist=tuple(float(v) for v in d[:5]), bf=_f32(bf),
        width=int(width), height=int(height),
        min_x=0.0, max_x=_f32(width), min_y=0.0, max_y=_f32(height),
    )
    corners = torch.tensor(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]],
        dtype=torch.float32,
    )
    und = undistort_points(cam, corners).numpy()
    return cam._replace(
        min_x=_f32(min(und[0, 0], und[2, 0])),
        max_x=_f32(max(und[1, 0], und[3, 0])),
        min_y=_f32(min(und[0, 1], und[1, 1])),
        max_y=_f32(max(und[2, 1], und[3, 1])),
    )


def distort_normalized(cam: CameraModel, xn: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion of normalized coordinates (..., 2)."""
    k1, k2, p1, p2, k3 = cam.dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([xd, yd], dim=-1)


def project(cam: CameraModel, p_cam: torch.Tensor, distort: bool = False) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2): undistorted by
    default (the system works on undistorted keypoints after extraction),
    with the lens distortion applied for ``distort=True``."""
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    if distort:
        xn = distort_normalized(cam, p_cam[..., :2] * inv_z[..., None])
        return torch.stack([cam.fx * xn[..., 0] + cam.cx, cam.fy * xn[..., 1] + cam.cy],
                           dim=-1)
    u = cam.fx * (p_cam[..., 0] * inv_z) + cam.cx
    v = cam.fy * (p_cam[..., 1] * inv_z) + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: CameraModel, p_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3) [u, v, u_right], u_right = u - bf / z."""
    uv = project(cam, p_cam)
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    ur = uv[..., 0] - cam.bf * inv_z
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: CameraModel, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels (..., 2) + depth (...) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def undistort_points(cam: CameraModel, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Pixel coords (..., 2) -> undistorted pixel coords, by the fixed-point
    iteration of cv::undistortPoints with a static count."""
    xd = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    k1, k2, p1, p2, k3 = cam.dist
    x = xd
    for _ in range(iters):
        r2 = (x * x).sum(-1)
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy = x[..., 0] * x[..., 1]
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x[..., 0] ** 2)
        dy = p1 * (r2 + 2.0 * x[..., 1] ** 2) + 2.0 * p2 * xy
        x = (xd - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    u = cam.fx * x[..., 0] + cam.cx
    v = cam.fy * x[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def in_image(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    """Boolean mask: undistorted pixel inside the undistorted image bounds."""
    return (
        (uv[..., 0] >= cam.min_x)
        & (uv[..., 0] < cam.max_x)
        & (uv[..., 1] >= cam.min_y)
        & (uv[..., 1] < cam.max_y)
    )
