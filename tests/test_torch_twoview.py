"""Two-view initialization: the port's ``ops/twoview.py``,
``matcher.search_for_initialization`` and the mono map bootstrap's pieces
of ``models/tracking.py``, held against the JAX package on the CPU.

The scenes are ``tests/test_twoview.py``'s (200 points, 320x240 camera,
noise 0.3 px, 10% outliers unless said).  The port gets the reference's
RANSAC samples: ``jax.random.choice`` with the reference's key and
weights (``torch_carried_tracker._choice``), as ``initialize_two_view``
draws them.

Exact: ``success``, ``used_h``, ``n_inliers``, ``good``, the inlier masks
of the scores, CheckRT's good masks and counts, the matcher's matches, the
downselection and the repeated-target scatter.  Within tolerances: the
normalization (1e-5 relative), F and H up to sign and scale (1e-4 after
scaling both to unit norm), the scores (1e-4 relative), the candidate
motions as a set (1e-4: the two packages' SVDs give singular vectors of
other signs, so the candidates come in another order), T21 (1e-4) and the
points (5e-4 relative: the Gauss-Newton polish of float32 triangulation
moves far points, 30-65 units under a wrong motion, by up to 1.2e-4 of
their distance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import tracking as jtracking
from orbslam2_tpu.ops import matcher as jmatcher
from orbslam2_tpu.ops import twoview as J
from orbslam2_tpu.ops.extractor import Features as JFeatures
from orbslam2_tpu.solvers import lie as jlie
from orbslam2_tpu_torch.models import tracking as ttracking
from orbslam2_tpu_torch.models.frame import Frame
from orbslam2_tpu_torch.ops import matcher as tmatcher
from orbslam2_tpu_torch.ops import twoview as T
from orbslam2_tpu_torch.ops.extractor import Features

from test_twoview import K, make_scene
from torch_carried_tracker import _choice
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL_TOL = 1e-5
MAT_TOL = 1e-4
SCORE_RTOL = 1e-4
POSE_TOL = 1e-4
PTS_RTOL = 5e-4
# (seed, planar, outlier share, key) of test_twoview.py's initialize cases.
SCENES = {"general": (2, False, 0.1, 0), "planar": (3, True, 0.1, 1),
          "structure": (4, False, 0.0, 2), "outliers": (5, False, 0.15, 3)}


def _t(x):
    return torch.from_numpy(np.array(x).copy())


def _scene(name):
    seed, planar, outliers, key = SCENES[name]
    xy1, xy2, valid, R, t, X, out_idx = make_scene(seed=seed, planar=planar, outliers=outliers)
    key = jax.random.PRNGKey(key)
    return xy1, xy2, valid, key, (R, t, X, out_idx)


def _port_init(xy1, xy2, valid, key, iters=256):
    samples = _choice(key, valid, iters, 8)
    return T.initialize_two_view(_t(xy1), _t(xy2), _t(valid), _t(K), samples=_t(samples),
                                 iters=iters)


def _rot_deg(R, R_gt):
    dR = np.asarray(R) @ np.asarray(R_gt).T
    return np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))


def _unit(M):
    M = np.asarray(M, np.float64).reshape(M.shape[:-2] + (9,))
    M = M / np.linalg.norm(M, axis=-1, keepdims=True)
    # Sign: the largest-magnitude entry positive.
    i = np.argmax(np.abs(M), axis=-1)
    return M * np.sign(np.take_along_axis(M, i[..., None], -1))


# -- test_twoview.py's seven cases, on the port ---------------------------------


class TestSolvers:
    def test_fundamental_exact(self):
        xy1, xy2, valid, R, t, X, _ = make_scene(noise=0.0, outliers=0.0)
        x1n, T1 = T.normalize_points(_t(xy1), _t(valid))
        x2n, T2 = T.normalize_points(_t(xy2), _t(valid))
        F = (T2.T @ T._solve_f_8pt(x1n[:8], x2n[:8]) @ T1).numpy()
        o = np.ones((200, 1))
        x1h = np.concatenate([np.asarray(xy1), o], -1)
        x2h = np.concatenate([np.asarray(xy2), o], -1)
        lines = x1h @ F.T
        dist = np.abs(np.sum(lines * x2h, -1)) / np.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)
        assert np.median(dist) < 0.5

    def test_homography_exact(self):
        xy1, xy2, valid, R, t, X, _ = make_scene(planar=True, noise=0.0, outliers=0.0)
        x1n, T1 = T.normalize_points(_t(xy1), _t(valid))
        x2n, T2 = T.normalize_points(_t(xy2), _t(valid))
        H = (torch.linalg.inv(T2) @ T._solve_h_dlt(x1n[:8], x2n[:8]) @ T1).numpy()
        p = np.concatenate([np.asarray(xy1), np.ones((200, 1))], -1) @ H.T
        err = np.linalg.norm(p[:, :2] / p[:, 2:3] - np.asarray(xy2), axis=-1)
        assert np.median(err) < 0.5


class TestInitialize:
    def test_general_scene_selects_f_and_recovers_motion(self):
        xy1, xy2, valid, key, (R, t, X, _) = _scene("general")
        res = _port_init(xy1, xy2, valid, key)
        assert bool(res.success) and not bool(res.used_h)
        T21 = res.T21.numpy()
        assert _rot_deg(T21[:3, :3], R) < 1.0
        tdir = T21[:3, 3] / np.linalg.norm(T21[:3, 3])
        assert np.degrees(np.arccos(np.clip(tdir @ (t / np.linalg.norm(t)), -1, 1))) < 3.0

    def test_planar_scene_selects_h_and_recovers_motion(self):
        xy1, xy2, valid, key, (R, t, X, _) = _scene("planar")
        res = _port_init(xy1, xy2, valid, key)
        assert bool(res.used_h) and bool(res.success)
        assert _rot_deg(res.T21.numpy()[:3, :3], R) < 2.0

    def test_triangulated_structure_matches_gt(self):
        xy1, xy2, valid, key, (R, t, X, _) = _scene("structure")
        res = _port_init(xy1, xy2, valid, key)
        assert bool(res.success)
        good = res.good.numpy()
        pts = res.points.numpy()[good]
        s = np.median(X[good][:, 2] / pts[:, 2])
        assert np.median(np.linalg.norm(pts * s - X[good], axis=-1)) < 0.15

    def test_outliers_rejected(self):
        xy1, xy2, valid, key, (R, t, X, out_idx) = _scene("outliers")
        res = _port_init(xy1, xy2, valid, key)
        assert res.good.numpy()[out_idx].mean() < 0.2

    def test_insufficient_parallax_fails(self):
        xy1, xy2, valid = _pure_rotation()
        res = _port_init(xy1, xy2, valid, jax.random.PRNGKey(4))
        assert not bool(res.success)


def _pure_rotation():
    rng = np.random.default_rng(6)
    X = np.stack([rng.uniform(-3, 3, 150), rng.uniform(-2, 2, 150), rng.uniform(4, 9, 150)], -1)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.03, 0.0], jnp.float32)))

    def proj(P):
        return np.stack([K[0, 0] * P[:, 0] / P[:, 2] + K[0, 2],
                         K[1, 1] * P[:, 1] / P[:, 2] + K[1, 2]], -1)

    xy1 = jnp.asarray(proj(X) + rng.normal(0, 0.3, (150, 2)), jnp.float32)
    xy2 = jnp.asarray(proj(X @ R.T) + rng.normal(0, 0.3, (150, 2)), jnp.float32)
    return xy1, xy2, jnp.ones(150, bool)


# -- each function against its JAX twin ----------------------------------------


def test_jacobi_eigh_matches_numpy():
    rng = np.random.default_rng(0)
    for n, sweeps in ((9, T.SWEEPS_9), (3, T.SWEEPS_3)):
        A = rng.normal(size=(32, n + 2, n))
        G = np.einsum("bmi,bmj->bij", A, A)
        lam, V = T.jacobi_eigh(torch.from_numpy(G), sweeps)
        lam, V = lam.numpy(), V.numpy()
        np.testing.assert_allclose(np.sort(lam, -1), np.linalg.eigvalsh(G), rtol=1e-12,
                                   atol=1e-12 * np.abs(G).max())
        np.testing.assert_allclose(G @ V, V * lam[:, None, :], atol=1e-10 * np.abs(G).max())
        np.testing.assert_allclose(np.swapaxes(V, -1, -2) @ V, np.broadcast_to(np.eye(n), G.shape),
                                   atol=1e-12)


def test_normalize_points_matches():
    xy1, _, valid, _, _ = _scene("general")
    valid = np.asarray(valid).copy()
    valid[::7] = False
    xn, Tm = J.normalize_points(xy1, jnp.asarray(valid))
    xn_t, T_t = T.normalize_points(_t(xy1), _t(valid))
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn), rtol=REL_TOL, atol=REL_TOL)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(Tm), rtol=REL_TOL, atol=REL_TOL)


@pytest.mark.parametrize("model", ["F", "H"])
def test_minimal_and_refined_solvers_match(model):
    """The 256 minimal solves of the reference's samples and the weighted
    all-point solve, up to sign and scale."""
    xy1, xy2, valid, key, _ = _scene("planar" if model == "H" else "general")
    x1n, _ = J.normalize_points(xy1, valid)
    x2n, _ = J.normalize_points(xy2, valid)
    samples = np.array(_choice(key, valid, 256, 8))
    jsolve = J._solve_h_dlt if model == "H" else J._solve_f_8pt
    tsolve = T._solve_h_dlt if model == "H" else T._solve_f_8pt
    ref = jax.vmap(jsolve)(x1n[samples], x2n[samples])
    out = tsolve(_t(x1n)[samples], _t(x2n)[samples])
    w = np.linspace(0.0, 1.0, 200).astype(np.float32)
    ref_w = jsolve(x1n, x2n, w=jnp.asarray(w))
    out_w = tsolve(_t(x1n), _t(x2n), w=_t(w))
    # Samples that repeat a point leave a null space of more than one
    # dimension, where either package's vector is arbitrary: skip those.
    distinct = np.array([len(set(s)) == 8 for s in samples])
    assert distinct.sum() > 200
    np.testing.assert_allclose(_unit(out.numpy())[distinct], _unit(np.asarray(ref))[distinct],
                               atol=MAT_TOL)
    np.testing.assert_allclose(_unit(out_w.numpy()), _unit(np.asarray(ref_w)), atol=MAT_TOL)
    if model == "F":
        # Rank 2.
        assert np.abs(np.linalg.det(out.numpy().astype(np.float64))).max() < 1e-6


@pytest.mark.parametrize("model", ["F", "H"])
def test_scores_match(model):
    """Scores and inlier masks of 64 hypotheses (the reference's minimal
    solves, denormalized) on the same matches."""
    xy1, xy2, valid, key, _ = _scene("planar" if model == "H" else "general")
    x1n, T1 = J.normalize_points(xy1, valid)
    x2n, T2 = J.normalize_points(xy2, valid)
    samples = np.array(_choice(key, valid, 64, 8))
    if model == "H":
        M = jnp.einsum("ij,bjk,kl->bil", jnp.linalg.inv(T2),
                       jax.vmap(J._solve_h_dlt)(x1n[samples], x2n[samples]), T1)
        jscore, tscore = J._score_h, T._score_h
    else:
        M = jnp.einsum("ij,bjk,kl->bil", T2.T,
                       jax.vmap(J._solve_f_8pt)(x1n[samples], x2n[samples]), T1)
        jscore, tscore = J._score_f, T._score_f
    ref_s, ref_in = jax.vmap(lambda m: jscore(m, xy1, xy2, valid))(M)
    out_s, out_in = tscore(_t(M), _t(xy1), _t(xy2), _t(valid))
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), rtol=SCORE_RTOL, atol=1e-3)
    np.testing.assert_array_equal(out_in.numpy(), np.asarray(ref_in))


def _motion_set_match(Rs_ref, ts_ref, Rs, ts):
    """Each reference candidate's distance to its nearest port candidate,
    and whether that pairing is one to one."""
    d = np.array([[max(np.abs(Rs_ref[i] - Rs[k]).max(), np.abs(ts_ref[i] - ts[k]).max())
                   for k in range(len(Rs))] for i in range(len(Rs_ref))])
    nearest = d.argmin(1)
    return d.min(1).max(), len(set(nearest.tolist())) == len(Rs_ref)


def test_decompose_e_and_h_give_the_reference_candidates():
    xy1, xy2, valid, key, _ = _scene("general")
    x1n, T1 = J.normalize_points(xy1, valid)
    x2n, T2 = J.normalize_points(xy2, valid)
    F = T2.T @ J._solve_f_8pt(x1n, x2n, w=valid.astype(jnp.float32)) @ T1
    E = jnp.asarray(K).T @ F @ jnp.asarray(K)
    Rs_ref, ts_ref = (np.asarray(a) for a in J.decompose_e(E))
    Rs, ts = (a.numpy() for a in T.decompose_e(_t(E)))
    worst, one_to_one = _motion_set_match(Rs_ref, ts_ref, Rs, ts)
    assert one_to_one and worst <= POSE_TOL, worst
    np.testing.assert_allclose(np.linalg.det(Rs), 1.0, atol=1e-5)

    xy1, xy2, valid, key, _ = _scene("planar")
    x1n, T1 = J.normalize_points(xy1, valid)
    x2n, T2 = J.normalize_points(xy2, valid)
    H = jnp.linalg.inv(T2) @ J._solve_h_dlt(x1n, x2n, w=valid.astype(jnp.float32)) @ T1
    Rs_ref, ts_ref = (np.asarray(a) for a in J.decompose_h(H, jnp.asarray(K)))
    Rs, ts = (a.numpy() for a in T.decompose_h(_t(H), _t(K)))
    worst, one_to_one = _motion_set_match(Rs_ref, ts_ref, Rs, ts)
    assert one_to_one and worst <= POSE_TOL, worst


def test_check_rt_matches():
    xy1, xy2, valid, key, (R, t, X, _) = _scene("general")
    t_unit = (t / np.linalg.norm(t)).astype(np.float32)
    for Rm, tv in ((R.astype(np.float32), t_unit), (R.T.astype(np.float32), -t_unit)):
        ref = J.check_rt(jnp.asarray(Rm), jnp.asarray(tv), xy1, xy2, valid, jnp.asarray(K))
        out = T.check_rt(_t(Rm), _t(tv), _t(xy1), _t(xy2), _t(valid), _t(K))
        assert int(out[0]) == int(ref[0])
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=1e-4)
        good = np.asarray(ref[3])
        np.testing.assert_allclose(out[2].numpy()[good], np.asarray(ref[2])[good],
                                   rtol=PTS_RTOL, atol=PTS_RTOL)


@pytest.mark.parametrize("name", list(SCENES) + ["pure_rotation"])
def test_initialize_two_view_matches(name):
    if name == "pure_rotation":
        xy1, xy2, valid = _pure_rotation()
        key = jax.random.PRNGKey(4)
    else:
        xy1, xy2, valid, key, _ = _scene(name)
    ref = J.initialize_two_view(xy1, xy2, valid, jnp.asarray(K), key)
    out = _port_init(xy1, xy2, valid, key)
    assert bool(out.success) == bool(ref.success)
    assert bool(out.used_h) == bool(ref.used_h)
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(out.good.numpy(), np.asarray(ref.good))
    if bool(ref.success):
        np.testing.assert_allclose(out.T21.numpy(), np.asarray(ref.T21), atol=POSE_TOL)
        good = np.asarray(ref.good)
        np.testing.assert_allclose(out.points.numpy()[good], np.asarray(ref.points)[good],
                                   rtol=PTS_RTOL, atol=PTS_RTOL)


def test_initialize_two_view_draws_its_own_samples():
    """Without ``samples`` the port draws from a generator: the same seed
    gives the same result, and the general scene initializes."""
    xy1, xy2, valid, _, (R, *_) = _scene("general")
    outs = [T.initialize_two_view(_t(xy1), _t(xy2), _t(valid), _t(K),
                                  generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert bool(outs[0].success) and not bool(outs[0].used_h)
    assert torch.equal(outs[0].T21, outs[1].T21) and torch.equal(outs[0].good, outs[1].good)
    assert _rot_deg(outs[0].T21.numpy()[:3, :3], R) < 1.0


# -- the tracker's pieces --------------------------------------------------------


@pytest.mark.parametrize("n_good", [200, 201, 2, 1])
def test_median_depth_scale(n_good):
    """np.median's mean of the two middle depths at an even count (the
    lower middle alone would be torch.median's), the middle one at an odd
    count; the scale 1 / median in float64, rounded to float32 as the
    reference's numpy arithmetic does."""
    rng = np.random.default_rng(n_good)
    pts = rng.uniform(1.0, 9.0, (512, 3)).astype(np.float32)
    good = np.zeros(512, bool)
    good[rng.choice(512, n_good, replace=False)] = True
    med = float(np.median(pts[good][:, 2]))
    want = np.float32(1.0 / max(med, 1e-6))
    got = ttracking.median_depth_scale(_t(pts), _t(good))
    assert got.dtype == torch.float32 and got.numpy() == want
    if n_good % 2 == 0:
        lower = np.float32(1.0 / float(torch.median(_t(pts[good][:, 2]))))
        assert lower != want  # the test tells the two medians apart


def test_init_bindings_last_writer_wins():
    """Rows that failed still write NO_POINT to their target, and targets
    repeat: the reference's scatter order (the last row wins) decides."""
    rng = np.random.default_rng(1)
    n, m = 64, 200
    idx = rng.integers(0, n, m).astype(np.int32)  # many repeats
    ok = rng.random(m) < 0.5
    pids = rng.integers(0, 5000, m).astype(np.int32)
    ref = jnp.full(n, jtracking.NO_POINT, jnp.int32).at[jnp.asarray(idx)].set(
        jnp.where(jnp.asarray(ok), jnp.asarray(pids), jtracking.NO_POINT), mode="drop")
    out = ttracking.init_bindings(n, _t(idx).long(), _t(ok), _t(pids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _random_frame(rng, n, ties: bool):
    resp = rng.random(n).astype(np.float32)
    if ties:
        resp = np.round(resp * 8) / 8  # many equal responses
    fields = dict(
        xy=rng.uniform(0, 320, (n, 2)).astype(np.float32),
        level=rng.integers(0, 4, n).astype(np.int32),
        angle=rng.uniform(0, 6.28, n).astype(np.float32),
        response=resp,
        desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        valid=rng.random(n) < 0.8,
        ur=np.full(n, -1.0, np.float32),
        depth=np.full(n, -1.0, np.float32),
    )
    return fields


@pytest.mark.parametrize("ties", [True, False])
def test_downselect_frame_matches(ties):
    rng = np.random.default_rng(2)
    f = _random_frame(rng, 2048, ties)
    bindings = np.where(rng.random(2048) < 0.2, rng.integers(0, 900, 2048), -1).astype(np.int32)
    jframe = jtracking.Frame(**{k: jnp.asarray(v) for k, v in f.items()})
    ref_f, ref_b = jtracking.Tracker._downselect_frame(jframe, jnp.asarray(bindings), 1024)
    tf = dict(f, desc=f["desc"].view(np.int32))
    out_f, out_b = ttracking.Tracker._downselect_frame(
        Frame(**{k: _t(v) for k, v in tf.items()}), _t(bindings), 1024)
    np.testing.assert_array_equal(out_b.numpy(), np.asarray(ref_b))
    for name in Frame._fields:
        want = np.asarray(getattr(ref_f, name))
        got = getattr(out_f, name).numpy()
        if name == "desc":
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=name)


def _features_pair(rng, n):
    """Two feature sets of ``n`` slots: the second a moved, partly
    re-described copy of the first, with invalid slots and octaves 0-3."""
    a = _random_frame(rng, n, False)
    b = dict(a)
    b["xy"] = (a["xy"] + rng.normal(0, 20, (n, 2))).astype(np.float32)
    flip = rng.random((n, 8 * 32)) < 0.06  # ~15 bits of 256 differ
    bits = np.packbits(flip.reshape(n, 8, 32), axis=-1, bitorder="little").view(np.uint32)
    b["desc"] = a["desc"] ^ bits.reshape(n, 8)
    b["angle"] = (a["angle"] + rng.normal(0, 0.05, n)).astype(np.float32)
    b["valid"] = rng.random(n) < 0.85
    perm = rng.permutation(n)
    b = {k: v[perm] for k, v in b.items()}
    return a, b


def test_search_for_initialization_matches():
    rng = np.random.default_rng(5)
    a, b = _features_pair(rng, 1024)
    names = ("xy", "level", "angle", "response", "desc", "valid")
    ja, jb = (JFeatures(**{k: jnp.asarray(f[k]) for k in names}) for f in (a, b))
    ta, tb = (Features(**{k: _t(f[k].view(np.int32) if k == "desc" else f[k]) for k in names})
              for f in (a, b))
    ref = jmatcher.search_for_initialization(ja, jb)
    out = tmatcher.search_for_initialization(ta, tb)
    ok = np.asarray(ref.ok)
    assert ok.sum() > 100
    np.testing.assert_array_equal(out.ok.numpy(), ok)
    np.testing.assert_array_equal(out.idx.numpy()[ok], np.asarray(ref.idx)[ok])
    np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))
