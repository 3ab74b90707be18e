"""Oriented rBRIEF descriptors: orientation + rotated binary tests.

Port of ``orbslam2_tpu/ops/orb.py`` (``IC_Angle``, src/ORBextractor.cc:≈80,
and ``computeOrbDescriptor``, ≈110).  The sampling pattern is the same
seeded array, so descriptors agree bit for bit with the reference package.

The reference samples the rotated pattern through one-hot contractions (a
TPU-friendly form of a gather); here it is a plain gather, which reads the
same pixels.  Descriptors are 8 words of 32 bits held as ``torch.int32``
with the bits of the reference's uint32 words.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_PATCH = 15  # circular patch radius for orientation
PATCH = 2 * HALF_PATCH + 1


def _make_pattern(seed: int = 42, n_pairs: int = 256) -> np.ndarray:
    """(n_pairs, 2, 2) int32 sample offsets (x, y) within the 31x31 patch:
    isotropic Gaussian, sigma = patch/5, clipped to the radius-13 disc."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n_pairs * 2:
        cand = rng.normal(0.0, PATCH / 5.0, size=(n_pairs * 4, 2))
        cand = np.round(cand).astype(np.int32)
        r = np.hypot(cand[:, 0], cand[:, 1])
        cand = cand[r <= 13.0]
        pts.extend(cand.tolist())
    pts = np.array(pts[: n_pairs * 2], np.int32)
    return pts.reshape(n_pairs, 2, 2)


BRIEF_PATTERN = _make_pattern()  # (256, 2, 2) int32, (x, y) offsets

_yy, _xx = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
_CIRC_MASK = (_xx**2 + _yy**2 <= HALF_PATCH**2).astype(np.float32)
# (patch_pixels, 2): (m10, m01) of a flattened patch as one matvec.
_MXY = np.stack(
    [(_xx * _CIRC_MASK).reshape(-1), (_yy * _CIRC_MASK).reshape(-1)], -1
).astype(np.float32)


def extract_patches(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(N, PATCH*PATCH) float32 patches centred (rounded, border-clamped)
    on each keypoint."""
    h, w = image.shape
    x = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), HALF_PATCH, w - 1 - HALF_PATCH)
    y = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), HALF_PATCH, h - 1 - HALF_PATCH)
    offs = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=image.device)
    rows = (y[:, None] + offs)[:, :, None]
    cols = (x[:, None] + offs)[:, None, :]
    return image[rows, cols].reshape(xy.shape[0], PATCH * PATCH)


def orientations_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (radians) per flattened patch (IC_Angle)."""
    m = patches @ torch.from_numpy(_MXY).to(patches.device)
    return torch.atan2(m[:, 1], m[:, 0])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words, bit j of word k = bit 32k+j
    (the reference's uint32 packing, reinterpreted as int32)."""
    n = bits.shape[0]
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device
    )
    words = (bits.view(n, 8, 32).to(torch.int64) * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def descriptors_from_patches(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 packed steered BRIEF from flattened patches + angles:
    rotate the pattern by the keypoint angle, round each offset to the
    nearest pixel, compare I(p0) < I(p1)."""
    n = patches.shape[0]
    pat = torch.from_numpy(BRIEF_PATTERN.astype(np.float32)).to(patches.device)
    px = pat[:, :, 0].reshape(-1)  # (512,) = pairs x {p0, p1}
    py = pat[:, :, 1].reshape(-1)
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    rx = torch.round(px * ca - py * sa).to(torch.int64) + HALF_PATCH
    ry = torch.round(px * sa + py * ca).to(torch.int64) + HALF_PATCH
    samples = torch.gather(patches, 1, ry * PATCH + rx).view(n, 256, 2)
    return pack_bits(samples[:, :, 0] < samples[:, :, 1])
