"""Local mapping of the port on the CPU against the reference, stage by
stage, on one map carried across from the reference tracker (14 frames, 10
keyframes; ``torch_carried_map``).

Each stage gets the same input map in both packages (the reference's
output of the stage before), so a difference is the stage's own.  Integer
and boolean state is held exact everywhere.  Floats are exact where the
stage only moves them; triangulated positions agree within TRI_TOL (the
reference's CPU matmuls and the port's sum in another order; measured
below 1e-5), and after the whole ``process_keyframe``, which ends in local
BA, poses within POSE_TOL and points within PT_TOL + PT_RTOL |X| (far
points with short baselines move by up to 1.5 m in BA, where float32 sums
in another order differ by up to 2e-3 m).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import local_mapping as jlm
from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.ops import matcher as jmatch
from orbslam2_tpu.ops import twoview as jtv
from orbslam2_tpu.ops.extractor import Features as JFeatures
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import local_mapping as tlm
from orbslam2_tpu_torch.models import map_state as tms
from orbslam2_tpu_torch.ops import matcher as tmatch
from orbslam2_tpu_torch.ops import twoview as ttv
from orbslam2_tpu_torch.ops.extractor import Features as TFeatures
from torch_carried_map import carried_map

TRI_TOL = 1e-4
EPI_TOL_PX = 2e-3
POSE_TOL = 1e-4
PT_TOL = 1e-3
PT_RTOL = 1e-3


@pytest.fixture(scope="module")
def carried():
    s, ps, m, kf = carried_map(14)
    jmapper = jlm.LocalMapper(s, sensor="rgbd")
    tmapper = tlm.LocalMapper(ps, sensor="rgbd")
    sf, sigma2, inv_sigma2 = tmapper.tables("cpu")
    return dict(s=s, ps=ps, m=m, kf=kf, jmapper=jmapper, tmapper=tmapper,
                sf=sf, sigma2=sigma2, inv_sigma2=inv_sigma2)


def _j(m):
    return jax.tree.map(jnp.asarray, m)


def _t(m):
    return convert.map_state_from_numpy(jax.tree.map(np.asarray, m), "cpu")


def _np(x):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def assert_maps_agree(got, ref, float_tol=None):
    """Every field of two maps: integers and booleans exact, floats exact
    unless ``float_tol`` gives (atol, rtol) for the field."""
    float_tol = float_tol or {}
    for f in tms.MapState._fields:
        a, b = _np(getattr(got, f)), _np(getattr(ref, f))
        if f in float_tol:
            np.testing.assert_allclose(a, b, atol=float_tol[f][0], rtol=float_tol[f][1],
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def stages(carried):
    """The reference's stage outputs in process_keyframe's order; each is
    the next stage's input in both packages."""
    jm, kf, mp = _j(carried["m"]), jnp.int32(carried["kf"]), carried["jmapper"]
    out = {"input": jm}
    out["culled"] = jlm.cull_map_points(jm)
    out["triangulated"] = jlm.triangulate_new_points(
        out["culled"], kf, mp.cam, mp.scale_factors, mp.sigma2,
        n_neighbors=mp.n_tri_neighbors)
    nids, w = jms.best_covisible(out["triangulated"], kf, 8)
    out["pairs"] = (
        np.asarray(jnp.concatenate([jnp.stack([kf, nb]) for nb in nids])),
        np.asarray(jnp.concatenate([jnp.stack([nb, kf]) for nb in nids])),
        np.asarray(jnp.repeat(w > 0, 2)),
    )
    out["fused"] = jlm.fuse_neighborhood(
        out["triangulated"], *(jnp.asarray(p) for p in out["pairs"][:2]), mp.cam,
        mp.scale_factors, mp.inv_sigma2, pair_valid=jnp.asarray(out["pairs"][2]))
    return out


def test_bucket():
    for cap, n in ((8, 3), (8, 9), (16, 8), (16, 9), (4, 100)):
        assert tlm._bucket(cap, n) == jlm._bucket(cap, n)


def test_derived_structure(carried):
    jm, tm, kf = _j(carried["m"]), _t(carried["m"]), carried["kf"]
    for got, want in zip(tms._valid_obs(tm), jms._valid_obs(jm)):
        np.testing.assert_array_equal(_np(got), _np(want))
    for k in (0, kf // 2, kf):
        np.testing.assert_array_equal(_np(tms.covisible_row(tm, k)),
                                      _np(jms.covisible_row(jm, jnp.int32(k))))
        for got, want in zip(tms.best_covisible(tm, k, 12),
                             jms.best_covisible(jm, jnp.int32(k), 12)):
            np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(tms.point_observation_counts(tm)),
                                  _np(jms.point_observation_counts(jm)))
    mask = np.arange(tm.kf_capacity) % 3 == 0
    np.testing.assert_array_equal(_np(tms.points_seen_by(tm, torch.from_numpy(mask))),
                                  _np(jms.points_seen_by(jm, jnp.asarray(mask))))


def test_cull_map_points(carried, stages):
    got = tlm.cull_map_points(_t(stages["input"]))
    assert_maps_agree(got, stages["culled"])
    assert int(got.pt_valid.sum()) < int(carried["m"].pt_valid.sum())


def _pool_pressure_map():
    """tests/test_compaction.py::TestPointPoolPressure's map: 95% of the
    point pool valid, a well-observed first quarter, fresh points at the
    end."""
    P, K, N = 256, 4, 64
    n_fill = int(0.95 * P)
    rng = np.random.default_rng(0)
    m = jax.tree.map(np.asarray, jms.make_empty_map(K, P, N))
    kf_point = np.full((K, N), -1, np.int32)
    kf_point[0, :] = np.arange(N)
    kf_point[1, :] = np.arange(N)
    visible = np.full(P, 10, np.int32)
    found = np.full(P, 3, np.int32)
    found[:N] = 9
    first_kf = np.zeros(P, np.int32)
    first_kf[n_fill - 8:n_fill] = 9
    visible[n_fill - 8:n_fill] = 1
    found[n_fill - 8:n_fill] = 1
    valid = np.zeros(P, bool)
    valid[:n_fill] = True
    return m._replace(
        pt_pos=rng.uniform(-1, 1, (P, 3)).astype(np.float32), pt_valid=valid,
        pt_visible=visible, pt_found=found, pt_first_kf=first_kf, kf_point=kf_point,
        kf_kp_valid=np.ones((K, N), bool), kf_valid=np.array([True, True, False, False]),
        n_kf=np.int32(10), n_pt=np.int32(n_fill),
    )


def test_cull_map_points_under_pool_pressure():
    m = _pool_pressure_map()
    ref = jlm.cull_map_points(_j(m))
    got = tlm.cull_map_points(_t(m))
    assert_maps_agree(got, ref)
    kept = got.pt_valid.numpy()
    assert kept.sum() <= int(0.90 * m.pt_valid.shape[0]) < m.pt_valid.sum()
    assert kept[:64].all() and kept[int(0.95 * 256) - 8:int(0.95 * 256)].all()


def test_triangulate_new_points(carried, stages):
    tm, mp = carried["tmapper"], carried["jmapper"]
    got = tlm.triangulate_new_points(_t(stages["culled"]), carried["kf"], tm.cam, carried["sf"],
                                     carried["sigma2"], n_neighbors=mp.n_tri_neighbors)
    ref = stages["triangulated"]
    assert_maps_agree(got, ref, float_tol={"pt_pos": (TRI_TOL, 0.0)})
    assert int(ref.n_pt) > int(stages["culled"].n_pt), "nothing was triangulated"


def test_fuse_neighborhood(carried, stages):
    tm = carried["tmapper"]
    a, b, valid = (torch.from_numpy(p.copy()) for p in stages["pairs"])
    got = tlm.fuse_neighborhood(_t(stages["triangulated"]), a, b, tm.cam, carried["sf"],
                                carried["inv_sigma2"], pair_valid=valid)
    ref = stages["fused"]
    assert_maps_agree(got, ref)
    before = np.asarray(stages["triangulated"].kf_point)
    assert (np.asarray(ref.kf_point) != before).any(), "the fuse changed no binding"


def test_fuse_with_neighbor(carried, stages):
    jm = stages["triangulated"]
    kf = carried["kf"]
    nb = int(jms.best_covisible(jm, jnp.int32(kf), 1)[0][0])
    mp, tm = carried["jmapper"], carried["tmapper"]
    for a, b in ((kf, nb), (nb, kf)):
        ref = jlm.fuse_with_neighbor(jm, jnp.int32(a), jnp.int32(b), mp.cam, mp.scale_factors,
                                     mp.inv_sigma2)
        got = tlm.fuse_with_neighbor(_t(jm), torch.tensor(a), torch.tensor(b), tm.cam,
                                     carried["sf"], carried["inv_sigma2"])
        assert_maps_agree(got, ref)


def test_apply_point_replacements_and_dedup(carried):
    m = carried["m"]
    rng = np.random.default_rng(4)
    live = np.nonzero(m.pt_valid)[0]
    M = 64
    old = rng.choice(live, M).astype(np.int32)
    new = rng.choice(live, M).astype(np.int32)
    new[:4] = old[4:8]        # survivors retired elsewhere: dropped
    old[8:12] = old[12:16]    # points retired twice: the first slot wins
    new[16] = old[16]         # a no-op
    old[17] = -1
    do = rng.random(M) < 0.9
    ref = jms.apply_point_replacements(_j(m), *(jnp.asarray(x) for x in (old, new, do)))
    got = tms.apply_point_replacements(_t(m), *(torch.from_numpy(x) for x in (old, new, do)))
    assert_maps_agree(got, ref)
    assert int(np.asarray(ref.pt_valid).sum()) < int(m.pt_valid.sum())

    rows = rng.integers(-1, 40, (6, 50)).astype(np.int32)
    np.testing.assert_array_equal(tms.dedup_binding_rows(torch.from_numpy(rows)).numpy(),
                                  np.asarray(jms.dedup_binding_rows(jnp.asarray(rows))))


@pytest.mark.parametrize("touched", [None, "window"])
def test_compute_distinctive_descriptors(carried, stages, touched):
    jm = stages["fused"]
    kf = carried["kf"]
    kw_j, kw_t = {}, {}
    if touched == "window":
        ids = np.array([kf, kf - 1, 2, kf], np.int32)
        kw_j = dict(touched_kfs=jnp.asarray(ids), subset_cap=1024)
        kw_t = dict(touched_kfs=torch.from_numpy(ids), subset_cap=1024)
    ref = jms.compute_distinctive_descriptors(jm, **kw_j)
    got = tms.compute_distinctive_descriptors(_t(jm), **kw_t)
    assert_maps_agree(got, ref)
    assert (np.asarray(ref.pt_desc) != np.asarray(jm.pt_desc)).any()


@pytest.mark.parametrize("sensor", ["rgbd", "mono"])
def test_cull_keyframes(carried, stages, sensor):
    jm = stages["fused"]
    bf = 32.0 if sensor == "rgbd" else 0.0
    kw = dict(n_levels=4, bf=bf, th_depth=40.0)
    for current in (carried["kf"], 3):
        ref = jlm.cull_keyframes(jm, jnp.int32(current), **kw)
        got = tlm.cull_keyframes(_t(jm), current, **kw)
        assert_maps_agree(got, ref)


def test_compact_map(carried):
    m = carried["m"]
    kf_valid = m.kf_valid.copy()
    kf_valid[[3, 4, 7]] = False  # a chain of culled parents, and one alone
    m = m._replace(kf_valid=kf_valid)
    ref, ref_map = jms.compact_map(_j(m))
    got, got_map = tms.compact_map(_t(m))
    assert_maps_agree(got, ref)
    np.testing.assert_array_equal(got_map, ref_map)
    assert int(got.n_kf) == int(m.n_kf) - 3


def _features(m, k, valid):
    d = dict(xy=m.kf_xy[k], level=m.kf_level[k], angle=m.kf_angle[k],
             response=np.ones_like(m.kf_angle[k]), desc=m.kf_desc[k], valid=valid)
    return (JFeatures(**{f: jnp.asarray(v) for f, v in d.items()}),
            TFeatures(**{f: convert.tensor_from_numpy(v, "cpu") for f, v in d.items()}))


def _fundamental(m, k1, k2, cam):
    """F21^T between two keyframes of the map, as triangulation forms it."""
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64)
    T21 = m.kf_pose_cw[k2].astype(np.float64) @ np.linalg.inv(m.kf_pose_cw[k1])
    t = T21[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    return (Kinv.T @ tx @ T21[:3, :3] @ Kinv).T.astype(np.float32)


def test_epipolar_search_and_triangulation(carried):
    """search_for_triangulation, epipolar_distance and triangulate_linear
    on two covisible keyframes of the carried map, and epipolar_distance /
    triangulate_linear again on seeded points."""
    m, kf = carried["m"], carried["kf"]
    cam = carried["tmapper"].cam
    nb = int(jms.best_covisible(_j(m), jnp.int32(kf), 1)[0][0])
    jf1, tf1 = _features(m, kf, m.kf_kp_valid[kf])
    jf2, tf2 = _features(m, nb, m.kf_kp_valid[nb])
    F12 = _fundamental(m, kf, nb, cam)
    sigma2 = np.asarray(carried["jmapper"].sigma2)
    ref = jmatch.search_for_triangulation(jf1, jf2, jnp.asarray(F12), jnp.asarray(sigma2))
    got = tmatch.search_for_triangulation(tf1, tf2, torch.from_numpy(F12),
                                          torch.from_numpy(sigma2))
    ok = np.asarray(ref.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.idx.numpy()[ok], np.asarray(ref.idx)[ok])
    np.testing.assert_array_equal(got.dist.numpy()[ok], np.asarray(ref.dist)[ok])
    assert ok.sum() > 10

    rng = np.random.default_rng(7)
    xy1 = (rng.random((300, 2)) * [320, 240]).astype(np.float32)
    xy2 = (rng.random((200, 2)) * [320, 240]).astype(np.float32)
    d_ref = np.asarray(jmatch.epipolar_distance(*(jnp.asarray(x) for x in (xy1, xy2, F12))))
    d_got = tmatch.epipolar_distance(*(torch.from_numpy(x) for x in (xy1, xy2, F12))).numpy()
    # Compared as distances in pixels: a x + b y + c cancels at image scale
    # in float32, so the two frameworks' rounding differs by up to 6.2e-4 px
    # (measured), near the gate as far from it.
    np.testing.assert_allclose(np.sqrt(d_got), np.sqrt(d_ref), atol=EPI_TOL_PX, rtol=0.0)

    # Triangulate the matched pairs, and seeded points seen from two poses.
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    P1 = K @ m.kf_pose_cw[kf][:3, :4]
    P2 = K @ m.kf_pose_cw[nb][:3, :4]
    idx = np.asarray(ref.idx)
    cases = [(P1, P2, m.kf_xy[kf][ok], m.kf_xy[nb][idx[ok]])]
    X = (rng.normal(size=(100, 3)) * [1.0, 0.7, 0.4] + [0, 0, 4]).astype(np.float32)
    Q1 = K @ np.eye(4, dtype=np.float32)[:3]
    Q2 = K @ np.hstack([np.eye(3), [[-0.2], [0.02], [0.05]]]).astype(np.float32)
    noisy = [(x @ Q[:, :3].T + Q[:, 3])
             for x, Q in ((X, Q1), (X, Q2))]
    noisy = [(p[:, :2] / p[:, 2:] + rng.normal(scale=0.5, size=(100, 2))).astype(np.float32)
             for p in noisy]
    cases.append((Q1, Q2, *noisy))
    for A, B, a, b in cases:
        want = np.asarray(jtv.triangulate_linear(*(jnp.asarray(x) for x in (A, B, a, b))))
        out = ttv.triangulate_linear(*(torch.from_numpy(np.ascontiguousarray(x))
                                       for x in (A, B, a, b))).numpy()
        np.testing.assert_allclose(out, want, atol=TRI_TOL, rtol=TRI_TOL)


def test_process_keyframe(carried):
    """The whole mapping sequence for the newest keyframe."""
    m, kf = carried["m"], carried["kf"]
    ref = carried["jmapper"].process_keyframe(_j(m), kf)
    got = carried["tmapper"].process_keyframe(_t(m), kf)
    tol = {"kf_pose_cw": (POSE_TOL, 0.0), "pt_pos": (PT_TOL, PT_RTOL),
           "pt_normal": (1e-5, 0.0), "pt_min_dist": (1e-5, 1e-5),
           "pt_max_dist": (1e-5, 1e-5)}
    assert_maps_agree(got, ref, float_tol=tol)
    assert np.abs(np.asarray(ref.kf_pose_cw) - m.kf_pose_cw).max() > 10 * POSE_TOL


def test_mapper_refuses_a_mesh(carried):
    with pytest.raises(NotImplementedError, match="item 17"):
        tlm.LocalMapper(carried["ps"], sensor="rgbd", mesh=object())
