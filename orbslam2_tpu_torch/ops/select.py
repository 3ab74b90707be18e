"""Spatially-uniform keypoint selection (grid top-k).

Port of ``orbslam2_tpu/ops/select.py`` (stand-in for
``ORBextractor::DistributeOctTree``, src/ORBextractor.cc:≈560): per-cell
candidate top-k, then a global top-n.

Both top-k steps rank with a stable descending sort, so among equal scores
the lower index comes first — the order JAX's ``top_k`` gives, which
``torch.topk`` does not promise.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k`` along the last dim with ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(
    score: torch.Tensor,
    n_target: int,
    cell: int = 32,
    cand_per_cell: int = 4,
    border: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick up to ``n_target`` spatially distributed keypoints from an
    (H, W) NMS'd score map.  Returns xy (n_target, 2) float32 (x, y),
    responses (n_target,) and valid (n_target,) bool, padded."""
    h, w = score.shape
    dev = score.device
    inside = torch.zeros((h, w), dtype=torch.bool, device=dev)
    inside[border:h - border, border:w - border] = True
    score = torch.where(inside, score, torch.zeros_like(score))

    hc = -(-h // cell)
    wc = -(-w // cell)
    padded = torch.zeros((hc * cell, wc * cell), dtype=score.dtype, device=dev)
    padded[:h, :w] = score
    cells = padded.view(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    cell_top, cell_idx = topk_stable(cells, cand_per_cell)

    cell_id = torch.arange(hc * wc, device=dev)[:, None]
    abs_y = (cell_id // wc) * cell + cell_idx // cell
    abs_x = (cell_id % wc) * cell + cell_idx % cell

    cand_score = cell_top.reshape(-1)
    k = min(n_target, cand_score.shape[0])
    top_score, top_i = topk_stable(cand_score, k)
    sel_x = abs_x.reshape(-1)[top_i].to(torch.float32)
    sel_y = abs_y.reshape(-1)[top_i].to(torch.float32)
    valid = top_score > 0.0

    if k < n_target:
        pad = n_target - k
        top_score = torch.cat([top_score, top_score.new_zeros(pad)])
        sel_x = torch.cat([sel_x, sel_x.new_zeros(pad)])
        sel_y = torch.cat([sel_y, sel_y.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])

    return torch.stack([sel_x, sel_y], dim=-1), top_score, valid
