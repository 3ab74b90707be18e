"""K3's plain version, ``ops.matcher.projection_best2`` on CPU tensors,
against the JAX package: the Pallas kernel ``projection_best2_pallas`` in
interpret mode (its own golden, ``tests/test_pallas_matcher.py``) and the
XLA branch of ``projection_match``, with the motion-model octave gate
(``level_dir`` -1, 0, +1) that the Pallas kernel never took, at ragged
shapes and on tie-heavy descriptors.  Tolerance: exact, every output.
A plain copy of the card kernel's lane-split scan and merge
(``_lane_split_best2``) is held to the plain version on the same inputs,
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops.matcher import projection_match as jax_projection_match
from orbslam2_tpu.ops.pallas_kernels import projection_best2_pallas
from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.ops import matcher
from tests.test_pallas_matcher import _mk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _port_args(uv, xy, rr2, la, lb, va, vb, da, db):
    """The port's separate tensors: int64 source levels (as predict_scale
    gives them), int32 target levels, int32 descriptor words."""
    t = torch.from_numpy
    return (t(uv), t(rr2), t(la.astype(np.int64)), t(np.array(da).view(np.int32)),
            t(va > 0.5), t(xy), t(lb.astype(np.int32)), t(np.array(db).view(np.int32)),
            t(vb > 0.5))


@pytest.mark.parametrize("shape", [(128, 128), (256, 128), (128, 384)])
def test_equals_the_pallas_kernel(shape):
    na, nb = shape
    da, ma, db, mb, uv, xy, rr2, la, lb, va, vb = _mk(na, nb, seed=na + nb)
    ref = [np.asarray(x) for x in projection_best2_pallas(da, ma, db, mb, level_band=1,
                                                           interpret=True)]
    out = [x.numpy() for x in matcher.projection_best2(
        *_port_args(uv, xy, rr2, la, lb, va, vb, da, db), 1)]
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])
    has = ref[1] < 10_000
    assert has.any() and not has.all()
    np.testing.assert_array_equal(out[0][has], ref[0][has])
    # Where no candidate exists the port gives argmin's first column.
    assert (out[0][~has] == 0).all()


def test_empty_window_rows_equal_the_pallas_kernel():
    da, ma, db, mb, uv, xy, rr2, la, lb, va, vb = _mk(128, 128, seed=3, all_invalid_rows=16)
    ref = [np.asarray(x) for x in projection_best2_pallas(da, ma, db, mb, level_band=1,
                                                           interpret=True)]
    out = [x.numpy() for x in matcher.projection_best2(
        *_port_args(uv, xy, rr2, la, lb, va, vb, da, db), 1)]
    assert (out[1][:16] == 10_000).all() and (out[2][:16] == 10_000).all()
    assert (out[0][:16] == 0).all()
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])


def _ragged(na, nb, seed, ties):
    """Sources and targets in a 120x90 window with radii up to 40 px, so
    windows hold several targets; ``ties`` draws descriptors from a pool of
    6, so windows hold equal distances.  A few rows have an empty window
    and one has its radius exactly at a target's distance."""
    rng = np.random.default_rng(seed)
    if ties:
        pool = rng.integers(0, 2**32, (6, 8), dtype=np.uint32)
        da, db = pool[rng.integers(0, 6, na)], pool[rng.integers(0, 6, nb)]
    else:
        da = rng.integers(0, 2**32, (na, 8), dtype=np.uint32)
        db = rng.integers(0, 2**32, (nb, 8), dtype=np.uint32)
    uv = (rng.uniform(0, 1, (na, 2)) * [120, 90]).astype(np.float32)
    xy = (rng.uniform(0, 1, (nb, 2)) * [120, 90]).astype(np.float32)
    rr2 = (rng.uniform(3, 40, na) ** 2).astype(np.float32)
    rr2[::7] = 0.0
    d = uv[0] - xy[nb // 2]
    rr2[0] = d[0] * d[0] + d[1] * d[1]
    la = rng.integers(0, 8, na).astype(np.int32)
    lb = rng.integers(0, 8, nb).astype(np.int32)
    va, vb = rng.uniform(size=na) > 0.2, rng.uniform(size=nb) > 0.2
    return da, db, uv, xy, rr2, la, lb, va, vb


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("level_dir", [None, -1, 0, 1])
@pytest.mark.parametrize("shape", [(77, 300), (1, 5)])
def test_projection_match_equals_the_xla_branch(shape, level_dir, ties):
    na, nb = shape
    da, db, uv, xy, rr2, la, lb, va, vb = _ragged(na, nb, seed=na * nb + 7, ties=ties)
    gates = dict(level_band=1, max_dist=100, ratio=0.9)
    ref = jax_projection_match(
        jnp.asarray(uv), jnp.asarray(rr2), jnp.asarray(la), jnp.asarray(da), jnp.asarray(va),
        jnp.asarray(xy), jnp.asarray(lb), jnp.asarray(db), jnp.asarray(vb), **gates,
        level_dir=None if level_dir is None else jnp.int32(level_dir))
    t = torch.from_numpy
    out = matcher.projection_match(
        t(uv), t(rr2), t(la.astype(np.int64)), t(da.view(np.int32)), t(va), t(xy), t(lb),
        t(db.view(np.int32)), t(vb), **gates,
        level_dir=None if level_dir is None else torch.tensor(level_dir, dtype=torch.int32))
    for name in ("idx", "dist", "dist2", "ok"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    if na > 1:
        assert (np.asarray(ref.dist) < 10_000).sum() >= 10
        if ties:  # equal best and second distances occur and are kept
            has = np.asarray(ref.dist) < 10_000
            assert (np.asarray(ref.dist) == np.asarray(ref.dist2))[has].any()


def test_a_cpu_call_launches_nothing():
    da, db, uv, xy, rr2, la, lb, va, vb = _ragged(40, 60, seed=1, ties=True)
    t = torch.from_numpy
    kernels.reset_launch_counts()
    matcher.projection_best2(t(uv), t(rr2), t(la), t(da.view(np.int32)), t(va), t(xy), t(lb),
                             t(db.view(np.int32)), t(vb), 1,
                             torch.tensor(1, dtype=torch.int32))
    assert set(kernels.LAUNCHES.values()) == {0}


def test_the_kernel_wrapper_refuses_cpu_tensors():
    args = (torch.zeros(3, 2), torch.ones(3), torch.zeros(3, dtype=torch.int64),
            torch.zeros(3, 8, dtype=torch.int32), torch.ones(3, dtype=torch.bool),
            torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, 8, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.projection_best2_cuda(*args, 1)
    # Tensors on neither the CPU alone nor CUDA alone are refused too.
    mixed = (args[0].to("meta"),) + args[1:]
    with pytest.raises(ValueError, match="meta"):
        matcher.projection_best2(*mixed, 1)


# -- the card kernel's reduction, in plain torch ------------------------------

LANES = 32  # csrc/projection_best2.cu: one warp per source row
COLS = 256  # targets per staged tile


def _lane_split_best2(proj_uv, rr2, proj_level, proj_desc, proj_valid,
                      frame_xy, frame_level, frame_desc, frame_valid, level_band,
                      level_dir=None):
    """A plain copy of the kernel's reduction: the columns are split into
    tiles of COLS and, within each, into LANES interleaved strides; each
    lane scans its columns in ascending order keeping (best, idx, second)
    with `<` and `else if <`, then five xor-butterfly steps merge the
    lanes' partials, best by (distance, column), second = min(max(b1, b2),
    s1, s2)."""
    inv = 10_000
    diff = proj_uv[:, None, :] - frame_xy[None, :, :]
    d2 = (diff * diff).sum(-1)
    dl = frame_level[None, :].long() - proj_level[:, None].long()
    gate = dl.abs() <= level_band
    if level_dir is not None:
        gate = torch.where(level_dir > 0, dl >= 0, torch.where(level_dir < 0, dl <= 0, gate))
    mask = (d2 <= rr2[:, None]) & gate & proj_valid[:, None] & frame_valid[None, :]
    dist = torch.where(mask, matcher._hamming_plain(proj_desc, frame_desc), inv)
    M, N = dist.shape
    best = torch.full((LANES, M), inv)
    second = torch.full((LANES, M), inv)
    idx = torch.zeros((LANES, M), dtype=torch.int64)
    for col0 in range(0, N, COLS):
        for lane in range(LANES):
            for j in range(col0 + lane, min(col0 + COLS, N), LANES):
                d = dist[:, j]
                lt_best = d < best[lane]
                lt_second = ~lt_best & (d < second[lane])
                second[lane] = torch.where(lt_best, best[lane],
                                           torch.where(lt_second, d, second[lane]))
                idx[lane] = torch.where(lt_best, j, idx[lane])
                best[lane] = torch.where(lt_best, d, best[lane])
    for m in (16, 8, 4, 2, 1):
        partner = torch.arange(LANES) ^ m
        ob, oi, os = best[partner], idx[partner], second[partner]
        second = torch.minimum(torch.maximum(best, ob), torch.minimum(second, os))
        take = (ob < best) | ((ob == best) & (oi < idx))
        best, idx = torch.where(take, ob, best), torch.where(take, oi, idx)
    assert (best == best[0]).all() and (idx == idx[0]).all() and (second == second[0]).all()
    return idx[0], best[0], second[0]


def _ties_across_lanes_and_tiles(na, nb, seed):
    """Every target in every window and octave band; each row's descriptor
    planted at one column of the second tile and one of the third, so its
    first minimum (0) falls after a tile of larger distances, in lanes that
    differ from row to row, and ties with a later tile's copy."""
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (na, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (nb, 8), dtype=np.uint32)
    uv = rng.uniform(0, 10, (na, 2)).astype(np.float32)
    xy = rng.uniform(0, 10, (nb, 2)).astype(np.float32)
    rr2 = np.full(na, 400.0, np.float32)
    la = np.zeros(na, np.int32)
    lb = rng.integers(0, 2, nb).astype(np.int32)
    vb = rng.uniform(size=nb) > 0.1
    for r in range(na):
        for c in (rng.integers(COLS, 2 * COLS), rng.integers(2 * COLS, nb)):
            db[c], lb[c], vb[c] = da[r], 0, True
    return da, db, uv, xy, rr2, la, lb, np.ones(na, bool), vb


@pytest.mark.parametrize("level_dir", [None, -1, 1])
@pytest.mark.parametrize("case", ["ragged_ties", "ragged_random", "nb_below_32",
                                  "two_tiles_ties", "ties_across_lanes", "one_by_one"])
def test_lane_split_merge_equals_the_plain_version(case, level_dir):
    if case == "ragged_ties":
        data = _ragged(77, 300, seed=11, ties=True)
    elif case == "ragged_random":
        data = _ragged(45, 517, seed=12, ties=False)
    elif case == "nb_below_32":
        data = _ragged(33, 20, seed=13, ties=True)
    elif case == "two_tiles_ties":
        data = _ragged(19, COLS + 37, seed=14, ties=True)
    elif case == "ties_across_lanes":
        data = _ties_across_lanes_and_tiles(21, 2 * COLS + 70, seed=15)
    else:
        data = _ragged(1, 1, seed=16, ties=False)
    da, db, uv, xy, rr2, la, lb, va, vb = data
    t = torch.from_numpy
    args = (t(uv), t(rr2), t(la.astype(np.int64)), t(da.view(np.int32)), t(va), t(xy),
            t(lb), t(db.view(np.int32)), t(vb))
    ld = None if level_dir is None else torch.tensor(level_dir, dtype=torch.int32)
    want = matcher._projection_best2_plain(*args, 1, ld)
    got = _lane_split_best2(*args, 1, ld)
    for name, g, w in zip(("idx", "best", "second"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    if case == "ties_across_lanes":
        # First minima sit in several lanes and tiles, and ties are kept.
        assert len({int(i) % LANES for i in want[0]}) > 1
        assert (want[0] >= COLS).all() and (want[1] == 0).all()
        assert (want[2] == 0).any()


def test_lane_split_merge_on_empty_windows():
    da, ma, db, mb, uv, xy, rr2, la, lb, va, vb = _mk(128, 300, seed=3, all_invalid_rows=16)
    args = _port_args(uv, xy, rr2, la, lb, va, vb, da, db)
    want = matcher._projection_best2_plain(*args, 1)
    got = _lane_split_best2(*args, 1)
    assert (got[1][:16] == 10_000).all() and (got[0][:16] == 0).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
