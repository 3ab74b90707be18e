"""Image pyramid + Gaussian blur.

Port of ``orbslam2_tpu/ops/pyramid.py`` (``ORBextractor::ComputePyramid``,
src/ORBextractor.cc:≈750, and the 7x7 sigma=2 blur before description,
≈1060).

The reference resamples with ``jax.image.resize(..., "bilinear",
antialias=True)``: a triangle filter widened by the downscale factor,
applied separably as two dense weight matrices.  ``resize_weights``
rebuilds those matrices in float32 numpy with the same operations, and
``build_pyramid`` applies them as two matmuls.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """Static (H, W) per pyramid level (level 0 = full resolution)."""
    return [
        (
            max(int(round(height / scale_factor**i)), 32),
            max(int(round(width / scale_factor**i)), 32),
        )
        for i in range(n_levels)
    ]


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 antialiased triangle-filter weights — the
    ``compute_weight_mat`` of JAX's ``scale_and_translate`` (transposed),
    evaluated in float32 in the same order.  The sample positions are
    rounded once, as the reference's compiled program computes them (a
    fused multiply-add); rounding the product first moves weights by up to
    3e-6 and pyramid pixels by up to 4e-3."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    # (i + 0.5) * inv_scale - 0.5 is exact in float64, then rounded once.
    centers = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centers.astype(np.float64) * float(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in - 0.5))
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return np.ascontiguousarray(w.T)


@functools.lru_cache(maxsize=64)
def _weights_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def _resize(image: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    h, w = image.shape
    out = image
    if shape[0] != h:
        out = _weights_on(h, shape[0], image.device) @ out
    if shape[1] != w:
        out = out @ _weights_on(w, shape[1], image.device).T
    return out


def build_pyramid(
    image: torch.Tensor, n_levels: int, scale_factor: float
) -> List[torch.Tensor]:
    """Grayscale (H, W) float32 -> list of per-level images, each resampled
    from the previous level like the reference."""
    shapes = level_shapes(image.shape[0], image.shape[1], n_levels, scale_factor)
    levels = [image]
    for i in range(1, n_levels):
        levels.append(_resize(levels[-1], shapes[i]))
    return levels


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur, numpy-style ``reflect`` padding (the
    cv::BORDER_REFLECT_101 rule), taps summed in the reference's order."""
    k = [float(v) for v in _gaussian_kernel(ksize, sigma)]
    r = ksize // 2
    h, w = image.shape
    padded = F.pad(image[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    out = torch.zeros_like(image)
    for i in range(ksize):
        out = out + k[i] * padded[i:i + h]
    padded = F.pad(out[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    out2 = torch.zeros_like(image)
    for i in range(ksize):
        out2 = out2 + k[i] * padded[:, i:i + w]
    return out2


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level scale (level-i coords * scale[i] = level-0 coords)."""
    return np.array([scale_factor**i for i in range(n_levels)], np.float32)


def level_sigma2(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level measurement variance sigma^2 = scale^2 (ORBextractor ctor,
    src/ORBextractor.cc:≈430)."""
    return scale_factors(n_levels, scale_factor) ** 2


def features_per_level(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Per-level feature budget (ORBextractor ctor, src/ORBextractor.cc:≈430):
    geometric series over 1/scaleFactor."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1.0 - factor) / (1.0 - factor**n_levels)
    out = []
    total = 0
    for i in range(n_levels - 1):
        n = int(round(n_first * factor**i))
        out.append(n)
        total += n
    out.append(max(n_features - total, 0))
    return out
