"""Packed 256-bit Hamming distance — the matching primitive.

Port of ``orbslam2_tpu/ops/hamming.py`` (``ORBmatcher::DescriptorDistance``,
src/ORBmatcher.cc:≈1630).  Descriptors are (N, 8) ``torch.int32`` words
holding the reference's uint32 bits.  ``hamming_matrix`` launches the CUDA
kernel (``csrc/hamming.cu``) for CUDA tensors and takes ``_hamming_plain``
for CPU tensors.

Thresholds are the reference's (ORBmatcher.cc:≈30): TH_LOW=50,
TH_HIGH=100, and the best/second-best ratio gates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

from .select import topk_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30  # rotation-consistency histogram bins

_INVALID_DIST = 10_000  # > any possible 256-bit distance


def bit_signs(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N, 256) float32: each descriptor bit as +1 / -1."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(desc[:, :, None], shifts), 1)
    return (2 * bits - 1).to(torch.float32).reshape(desc.shape[0], 256)


def _hamming_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Na, 8) x (Nb, 8) int32 -> (Na, Nb) int32 through one float32 matmul
    of the +1/-1 bit vectors: a . b = 256 - 2 d.  Every product is +-1 and
    every partial sum an integer of magnitude <= 256, so the result is exact
    in any summation order (TF32 is off, see the package's ``__init__``)."""
    dot = bit_signs(desc_a) @ bit_signs(desc_b).T
    return ((256.0 - dot) * 0.5).to(torch.int32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Na, 8) x (Nb, 8) int32 -> (Na, Nb) int32 Hamming distances."""
    if desc_a.device.type == "cpu" and desc_b.device.type == "cpu":
        return _hamming_plain(desc_a, desc_b)
    from ..kernels import hamming_matrix_cuda

    return hamming_matrix_cuda(desc_a.contiguous(), desc_b.contiguous())


class Matches(NamedTuple):
    """Fixed-shape match result, one row per query descriptor:
    idx (Na,) int index into B (valid only where ``ok``), dist / dist2 (Na,)
    best and second-best distance, ok (Na,) bool."""

    idx: torch.Tensor
    dist: torch.Tensor
    dist2: torch.Tensor
    ok: torch.Tensor


def masked_best2(dist: torch.Tensor, pair_mask: Optional[torch.Tensor]):
    """Best + second-best along axis 1 under a pair mask.  Returns
    (best_idx, best, second) with masked pairs at _INVALID_DIST; the best
    index is the first minimum, as ``argmin`` in both frameworks."""
    if pair_mask is not None:
        dist = torch.where(pair_mask, dist, torch.full_like(dist, _INVALID_DIST))
    best_idx = torch.argmin(dist, dim=1)
    best = dist.gather(1, best_idx[:, None])[:, 0]
    dist2m = dist.scatter(1, best_idx[:, None], _INVALID_DIST)
    second = dist2m.amin(dim=1)
    return best_idx, best, second


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    pair_mask: Optional[torch.Tensor] = None,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    cross_check: bool = False,
) -> Matches:
    """Nearest-neighbour descriptor matching with the reference's gates:
    ``max_dist`` accept threshold, best < ``ratio`` * second, optional
    ``pair_mask`` candidate gating and ``cross_check`` (A must also be B's
    best match)."""
    dist = hamming_matrix(desc_a, desc_b)
    vmask = valid_a[:, None] & valid_b[None, :]
    mask = vmask if pair_mask is None else (vmask & pair_mask)

    best_idx, best, second = masked_best2(dist, mask)
    ok = (best <= max_dist) & valid_a
    ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))

    if cross_check:
        dist_m = torch.where(mask, dist, torch.full_like(dist, _INVALID_DIST))
        b_best_a = torch.argmin(dist_m, dim=0)
        ok = ok & (b_best_a[best_idx] == torch.arange(desc_a.shape[0], device=ok.device))

    return Matches(idx=best_idx, dist=best, dist2=second, ok=ok)


def rotation_consistency(
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    matches_idx: torch.Tensor,
    matches_ok: torch.Tensor,
) -> torch.Tensor:
    """The rotation-histogram check (ORBmatcher::ComputeThreeMaxima,
    src/ORBmatcher.cc:≈1600): bin each match's angle difference into 30
    bins and keep matches in the top-3 bins holding >= 0.1 x the best
    count.  Returns the filtered ``ok`` mask."""
    two_pi = 2.0 * math.pi
    rot = angle_a - angle_b[matches_idx]
    # Floored modulo with the reference's rounding (remainder of the
    # truncated division, shifted into [0, 2pi)).
    rot = torch.fmod(rot, two_pi)
    rot = torch.where((rot != 0) & (rot < 0), rot + two_pi, rot)
    bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int64), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=bins.device)
    hist = hist.index_add(0, bins, matches_ok.to(torch.int32))
    top3 = topk_stable(hist, 3)[0]
    in_top3 = hist >= top3[2]
    strong = hist.to(torch.float32) >= 0.1 * top3[0].to(torch.float32)
    return matches_ok & (in_top3 & strong)[bins]
