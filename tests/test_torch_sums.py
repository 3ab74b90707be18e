"""The port's fixed-order float sums against the scatter-adds they replace.

Local BA sums each point's landmark rows over the cameras through the
inverse observation index (``local_ba._point_blocks``), and the point
normals are a segment sum (``map_state.segment_sum``): both in an order
fixed by the shapes, where a float ``index_add`` on the card runs through
atomics.  On CPU inputs with repeated targets, dropped targets and empty
segments they equal the old ``scatter_add`` / ``index_add`` within 1e-6
relative (float32 sums of a few terms in another order).
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.models import map_state as ms
from orbslam2_tpu_torch.solvers import local_ba as tlb

RTOL = 1e-6


def _close(a, b):
    scale = b.abs().clamp(min=1.0)
    assert float(((a - b).abs() / scale).max()) <= RTOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_blocks_equal_the_scatter_add(seed):
    rng = np.random.default_rng(seed)
    C, N, P = 6, 40, 30
    # Repeated points within a camera (duplicates), unobserved slots, and
    # points 25-29 observed by no camera (empty segments).
    pid = torch.from_numpy(rng.integers(0, 25, (C, N)))
    obs_ok = torch.from_numpy(rng.uniform(size=(C, N)) < 0.7)
    pid = torch.where(obs_ok, pid, 0)
    inv_slot, ok1 = tlb._inverse_slots(pid, obs_ok, P)
    assert (ok1.sum() < obs_ok.sum()) and ok1.any()
    # K4 weighs every observation outside the solve's mask by w = 0: its
    # pack rows are zero there (rows 27-31 hold other values).
    obs_mask = ok1 & torch.from_numpy(rng.uniform(size=(C, N)) < 0.9)
    pack = torch.from_numpy(rng.normal(size=(C, 32, N)).astype(np.float32))
    pack[:, :27] = pack[:, :27] * obs_mask[:, None, :]
    free_f = torch.from_numpy((rng.uniform(size=C) < 0.7).astype(np.float32))

    H_pp, b_p, Gp = tlb._point_blocks(pack, inv_slot, free_f)

    # The scatter tail this replaces.
    H6 = ms.scatter_add(P, pid, pack[:, 0:6, :].transpose(1, 2))
    want_H = H6[:, list(tlb._HPP_FULL)].view(P, 3, 3)
    want_b = ms.scatter_add(P, pid, pack[:, 6:9, :].transpose(1, 2))
    G = pack[:, 9:27, :] * free_f[:, None, None]
    G_pad = torch.cat([G, torch.zeros_like(G[:, :, :1])], dim=2)
    want_G = G_pad.gather(2, inv_slot[:, None, :].expand(C, 18, P)).view(C, 6, 3, P)

    _close(H_pp, want_H)
    _close(b_p, want_b)
    assert torch.equal(Gp, want_G)
    assert (H_pp[25:] == 0).all() and (b_p[25:] == 0).all()
    assert (H_pp[:25] != 0).any()


@pytest.mark.parametrize("trailing", [(), (3,)], ids=["scalars", "vectors"])
def test_segment_sum_equals_index_add(trailing):
    rng = np.random.default_rng(7)
    size, n = 50, 400
    # Targets 0-39 repeat, 40-49 are empty, -1 and `size` are dropped.
    index = torch.from_numpy(rng.integers(-1, 40, n))
    index[::17] = size
    src = torch.from_numpy(rng.normal(size=(n,) + trailing).astype(np.float32))
    got = ms.segment_sum(size, index, src)
    keep = (index >= 0) & (index < size)
    want = torch.zeros((size,) + trailing).index_add(
        0, torch.where(keep, index, 0), src * keep.view((-1,) + (1,) * len(trailing)))
    assert got.shape == want.shape
    _close(got, want)
    assert (got[40:] == 0).all()


def test_segment_sum_depends_only_on_the_order_within_each_segment():
    # Interleaving the segments differently, each keeping its own order,
    # gives the same bits: the stable sort lines every segment up the same.
    rng = np.random.default_rng(3)
    seg = np.repeat(np.arange(5), 30)
    src = torch.from_numpy((rng.normal(size=(150, 3)) * 10.0 ** rng.integers(-3, 4, (150, 1)))
                           .astype(np.float32))
    a = ms.segment_sum(5, torch.from_numpy(seg), src)
    # Segment k's entries, in their order, at sorted random positions.
    positions = np.sort(rng.permutation(150).reshape(5, 30), axis=1)
    perm = np.empty(150, np.int64)
    for k in range(5):
        perm[positions[k]] = np.flatnonzero(seg == k)
    b = ms.segment_sum(5, torch.from_numpy(seg[perm]), src[torch.from_numpy(perm)])
    assert not (seg[perm] == seg).all()
    assert torch.equal(a, b)
