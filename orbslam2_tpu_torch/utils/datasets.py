"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Port of ``orbslam2_tpu/utils/datasets.py``: the reference's example mains
each hand-roll one loader (mono_tum.cc's ``LoadImages``, rgbd_tum.cc's
association reader, stereo_kitti.cc's sequence reader, stereo_euroc.cc's
timestamp reader); the same file formats are read here, in one module.

The loaders stay on the host: they yield numpy float32 grayscale frames
(and depth maps in the file's units), decoded with PIL, and a frame
reaches the device inside ``SlamSystem.track_*``.  The EuRoC stereo
rectification (``build_rectify_maps``, ``remap_bilinear``) is numpy too.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image


def _imread_gray(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("L"), np.float32)


def _imread_depth(path: str) -> np.ndarray:
    return np.asarray(Image.open(path), np.float32)


# ---------------------------------------------------------------------------
# TUM RGB-D (mono_tum.cc / rgbd_tum.cc)
# ---------------------------------------------------------------------------


def load_tum_rgb_list(seq_dir: str) -> List[Tuple[float, str]]:
    """Parse rgb.txt: '# comment' lines then 'timestamp filename'."""
    out = []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            out.append((float(ts), os.path.join(seq_dir, rel)))
    return out


def load_tum_associations(assoc_file: str, seq_dir: str):
    """rgbd association file: 't_rgb rgb t_depth depth' per line
    (Examples/RGB-D/associations/*.txt)."""
    out = []
    with open(assoc_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            out.append((float(p[0]), os.path.join(seq_dir, p[1]), os.path.join(seq_dir, p[3])))
    return out


def iter_tum_mono(seq_dir: str) -> Iterator[Tuple[float, np.ndarray]]:
    for ts, path in load_tum_rgb_list(seq_dir):
        yield ts, _imread_gray(path)


def iter_tum_rgbd(seq_dir: str, assoc_file: str) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    for ts, rgb, depth in load_tum_associations(assoc_file, seq_dir):
        yield ts, _imread_gray(rgb), _imread_depth(depth)


# ---------------------------------------------------------------------------
# KITTI odometry (mono_kitti.cc / stereo_kitti.cc)
# ---------------------------------------------------------------------------


def load_kitti_times(seq_dir: str) -> np.ndarray:
    with open(os.path.join(seq_dir, "times.txt")) as f:
        return np.array([float(x) for x in f.read().split()], np.float64)


def iter_kitti(seq_dir: str, stereo: bool = False
               ) -> Iterator[Tuple[float, np.ndarray, Optional[np.ndarray]]]:
    times = load_kitti_times(seq_dir)
    left_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    for i, ts in enumerate(times):
        name = f"{i:06d}.png"
        left = _imread_gray(os.path.join(left_dir, name))
        right = _imread_gray(os.path.join(right_dir, name)) if stereo else None
        yield float(ts), left, right


# ---------------------------------------------------------------------------
# EuRoC MAV (mono_euroc.cc / stereo_euroc.cc)
# ---------------------------------------------------------------------------


def load_euroc_timestamps(ts_file: str) -> List[str]:
    with open(ts_file) as f:
        return [line.strip() for line in f if line.strip()]


def iter_euroc(mav_dir: str, ts_file: str, stereo: bool = False
               ) -> Iterator[Tuple[float, np.ndarray, Optional[np.ndarray]]]:
    cam0 = os.path.join(mav_dir, "cam0", "data")
    cam1 = os.path.join(mav_dir, "cam1", "data")
    for stamp in load_euroc_timestamps(ts_file):
        left = _imread_gray(os.path.join(cam0, stamp + ".png"))
        right = _imread_gray(os.path.join(cam1, stamp + ".png")) if stereo else None
        yield float(stamp) / 1e9, left, right


# ---------------------------------------------------------------------------
# EuRoC stereo rectification (stereo_euroc.cc's initUndistortRectifyMap)
# ---------------------------------------------------------------------------


def build_rectify_maps(K, D, R, P_new, width: int, height: int):
    """The undistort + rectify sampling grid of one camera: for each
    destination pixel, the source pixel to sample (cv::initUndistortRectifyMap
    for the radtan model)."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    R = np.asarray(R, np.float64)
    P_new = np.asarray(P_new, np.float64)
    fx_n, fy_n = P_new[0, 0], P_new[1, 1]
    cx_n, cy_n = P_new[0, 2], P_new[1, 2]

    u, v = np.meshgrid(np.arange(width), np.arange(height))
    x = (u - cx_n) / fx_n
    y = (v - cy_n) / fy_n
    ones = np.ones_like(x)
    ray = np.stack([x, y, ones], -1) @ R  # R^T applied: dest ray -> src cam
    xs = ray[..., 0] / ray[..., 2]
    ys = ray[..., 1] / ray[..., 2]
    k1, k2, p1, p2 = (list(D) + [0, 0, 0, 0])[:4]
    r2 = xs * xs + ys * ys
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = xs * radial + 2 * p1 * xs * ys + p2 * (r2 + 2 * xs * xs)
    yd = ys * radial + p1 * (r2 + 2 * ys * ys) + 2 * p2 * xs * ys
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv::remap (bilinear, border constant 0)."""
    h, w = img.shape
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    valid = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    # Fractions relative to the clipped base, so that coordinates on the
    # last row or column interpolate to the boundary pixel.
    fx = map_x - x0c
    fy = map_y - y0c
    a = img[y0c, x0c]
    b = img[y0c, x0c + 1]
    c = img[y0c + 1, x0c]
    d = img[y0c + 1, x0c + 1]
    out = a * (1 - fx) * (1 - fy) + b * fx * (1 - fy) + c * (1 - fx) * fy + d * fx * fy
    return np.where(valid, out, 0.0).astype(np.float32)
