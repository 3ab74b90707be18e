"""The port's viewer and AR overlay against the reference's on the CPU.

``draw_map`` (keyframes, covisibility edges, trajectories, the follow
window) and ``draw_frame`` of a map and frame converted from the
reference's render the same PNG pixels as the reference's (matplotlib's Agg
in one process: decoded pixels equal, no tolerance); without matplotlib
(the GPU machine has none) the same calls draw with PIL.  ``LiveViewer``
draws, and reads the device, only on a keyframe interval or a loop.
``fit_plane_ransac`` given the reference's hypothesis indices as
``samples=`` finds the same inliers, the normal up to sign and the centroid
within 1e-5; ``cube_vertices`` and ``project_points`` are equal; and the
reference's two ``TestArOverlay`` cases run on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.utils import ar as jar
from orbslam2_tpu.utils import viewer as jviewer
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.utils import ar, viewer
from orbslam2_tpu_torch.utils.camera import make_camera

from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def _ref_map(rng):
    """8 keyframes (3 valid, one more dropped), 128 points, and keyframe
    slots bound to shared points so that covisibility edges are drawn."""
    K, P, N = 8, 128, 32
    m = jms.make_empty_map(K, P, N)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(K, 3)).astype(np.float32)
    kf_point = np.full((K, N), -1, np.int32)
    for k in range(4):
        kf_point[k, :24] = rng.choice(40, 24, replace=False)
    return m._replace(
        pt_pos=jnp.asarray(rng.normal(size=(P, 3)), jnp.float32),
        pt_valid=jnp.asarray(np.arange(P) < 100),
        kf_pose_cw=jnp.asarray(poses),
        kf_point=jnp.asarray(kf_point),
        kf_kp_valid=jnp.asarray(kf_point >= 0),
        kf_valid=jnp.asarray(np.isin(np.arange(K), [0, 1, 3])),
        n_kf=jnp.int32(4),
    )


def _port_map(m):
    return convert.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}, "cpu")


@pytest.mark.parametrize("follow", [False, True])
def test_draw_map_matches_the_reference(tmp_path, rng, follow):
    m = _ref_map(rng)
    kw = dict(trajectory=np.tile(np.eye(4), (5, 1, 1)) + rng.normal(0, 0.1, (5, 4, 4)),
              gt_trajectory=np.tile(np.eye(4), (5, 1, 1)), min_covis_weight=5)
    if follow:
        kw.update(follow=np.array([0.2, 0.0, -0.1]), follow_radius=2.0)
    assert int(np.asarray(jms.covisibility(m))[0, 1]) >= 5  # edges are drawn
    assert jviewer.draw_map(m, str(tmp_path / "ref.png"), **kw)
    assert viewer.draw_map(_port_map(m), str(tmp_path / "port.png"), **kw)
    assert np.array_equal(_pixels(tmp_path / "port.png"), _pixels(tmp_path / "ref.png"))


def test_draw_frame_matches_the_reference(tmp_path, rng):
    img = rng.uniform(0, 255, (120, 160))
    kp = rng.uniform(10, 150, (50, 2))
    tracked = rng.uniform(size=50) > 0.5
    assert jviewer.draw_frame(img, kp, tracked, str(tmp_path / "ref.png"), "OK | 42 matches")
    assert viewer.draw_frame(img, kp, tracked, str(tmp_path / "port.png"), "OK | 42 matches")
    assert np.array_equal(_pixels(tmp_path / "port.png"), _pixels(tmp_path / "ref.png"))


def test_without_matplotlib_pil_draws(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(viewer, "_HAS_MPL", False)
    m = _port_map(_ref_map(rng))
    assert viewer.draw_map(m, str(tmp_path / "map.png"), trajectory=np.tile(np.eye(4), (5, 1, 1)),
                           follow=np.zeros(3), follow_radius=1.0)
    assert viewer.draw_frame(rng.uniform(0, 255, (120, 160)), rng.uniform(10, 150, (50, 2)),
                             rng.uniform(size=50) > 0.5, str(tmp_path / "frame.png"), "OK")
    cam = make_camera(320.0, 320.0, 160.0, 120.0, width=320, height=240)
    plane = ar.Plane(normal=torch.tensor([0.0, 0.0, -1.0]), point=torch.tensor([0.0, 0.0, 3.0]),
                     n_inliers=torch.tensor(100), ok=torch.tensor(True))
    ar.draw_ar_overlay(np.full((240, 320), 128, np.uint8), np.eye(4), cam, plane,
                       str(tmp_path / "ar.png"), size=0.5)
    assert _pixels(tmp_path / "map.png").shape == (880, 880, 4)
    assert _pixels(tmp_path / "frame.png").shape == (120, 160, 4)
    overlay = _pixels(tmp_path / "ar.png")
    assert overlay.shape == (240, 320, 4)
    assert ((overlay[..., 1] == 255) & (overlay[..., 0] == 0)).any()  # the cube's lines


class _System:
    """A system whose map and trajectory count their reads."""

    def __init__(self, m):
        import types

        self._map, self.reads = m, 0
        self.tracker = types.SimpleNamespace(metrics={"keyframes_created": 0}, _host_n_kf=None,
                                             last_T=torch.eye(4))
        self.loop_closer = types.SimpleNamespace(loop_edges=[])

    @property
    def map(self):
        self.reads += 1
        return self._map

    def poses_wc(self):
        self.reads += 1
        return np.tile(np.eye(4), (3, 1, 1))


def test_live_viewer_snapshots_only_on_events(tmp_path, rng):
    """``LiveViewer.update`` reads neither the map nor the trajectory on a
    frame that draws nothing; it draws every ``every_kf`` keyframes (the
    chunked tracker's host count first, else the tracker's metric) and on
    each new loop edge.  (That a run with the viewer repeats one without it
    bit for bit: ``test_torch_live.py``.)"""
    system = _System(_port_map(_ref_map(rng)))
    lv = viewer.LiveViewer(str(tmp_path), every_kf=2, follow_radius=1.0)
    events = []
    for kc, host, loops in [(0, None, 0), (1, None, 0), (2, None, 0), (3, None, 0), (3, None, 1),
                            (3, 4, 1), (3, 5, 1), (3, 6, 1)]:
        system.tracker.metrics["keyframes_created"] = kc
        system.tracker._host_n_kf = host
        system.loop_closer.loop_edges = [(0, 1, None)] * loops
        reads, snaps = system.reads, lv.n_snaps
        lv.update(system)
        events.append(lv.n_snaps - snaps)
        assert (system.reads > reads) == bool(events[-1])
    assert events == [0, 0, 1, 0, 1, 1, 0, 1]
    assert sorted(p.name for p in tmp_path.glob("map_*.png")) == [
        "map_0000_kf.png", "map_0001_loop.png", "map_0002_kf.png", "map_0003_kf.png"]
    lv.finish(system)
    assert (tmp_path / "map_final.png").exists()


def _plane_points(seed, n_on=300, n_off=60):
    rng = np.random.default_rng(seed)
    n = np.array([0.2, 0.9, 0.1])
    n /= np.linalg.norm(n)
    u = np.cross(n, [1, 0, 0])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    ab = rng.uniform(-2, 2, (n_on, 2))
    pts_on = np.array([0, 1.0, 0]) + ab[:, :1] * u + ab[:, 1:2] * v
    pts_on += rng.normal(0, 0.005, pts_on.shape)
    pts = np.concatenate([pts_on, rng.uniform(-3, 3, (n_off, 3))]).astype(np.float32)
    return pts, n


@pytest.mark.parametrize("seed, th, drop", [(0, 0.02, 0), (1, 0.05, 7), (2, 0.01, 3)])
def test_plane_ransac_matches_the_reference(seed, th, drop):
    pts, _ = _plane_points(seed)
    valid = np.ones(len(pts), bool)
    if drop:
        valid[::drop] = False
    key = jax.random.PRNGKey(seed)
    ref = jar.fit_plane_ransac(jnp.asarray(pts), jnp.asarray(valid), key, inlier_th=th)
    # The reference's hypothesis indices, drawn as fit_plane_ransac draws them.
    w = valid.astype(np.float32)
    w = w / max(w.sum(), 1.0)
    idx = np.asarray(jax.random.choice(key, len(pts), shape=(256, 3), p=jnp.asarray(w)))
    out = ar.fit_plane_ransac(torch.from_numpy(pts), torch.from_numpy(valid),
                              samples=torch.from_numpy(np.array(idx)), inlier_th=th)
    assert int(out.n_inliers) == int(ref.n_inliers) and bool(out.ok) == bool(ref.ok)
    n_ref, n_out = np.asarray(ref.normal), out.normal.numpy()
    assert min(np.abs(n_out - n_ref).max(), np.abs(n_out + n_ref).max()) <= 1e-5
    np.testing.assert_allclose(out.point.numpy(), np.asarray(ref.point), atol=1e-5, rtol=0)

    port_plane = ar.Plane(*(torch.from_numpy(np.asarray(x)) for x in ref))
    anchor = np.array([0.1, 1.0, 0.2])
    for kw in ({}, {"anchor": anchor, "size": 0.5}):
        v_ref = jar.cube_vertices(ref, **kw)
        v_out = ar.cube_vertices(port_plane, **kw)
        assert np.array_equal(v_out, v_ref)
    cam = make_camera(320.0, 320.0, 160.0, 120.0, width=320, height=240)
    T = np.eye(4)
    T[:3, 3] = [0.0, -1.0, 4.0]
    uv_ref, front_ref = jar.project_points(T, cam, v_ref)
    uv_out, front_out = ar.project_points(torch.from_numpy(T), cam, v_out)
    assert np.array_equal(uv_out, uv_ref) and np.array_equal(front_out, front_ref)


def test_plane_ransac_draws_from_a_generator():
    pts, _ = _plane_points(0)
    valid = torch.ones(len(pts), dtype=torch.bool)
    outs = [ar.fit_plane_ransac(torch.from_numpy(pts), valid,
                                generator=torch.Generator().manual_seed(4)) for _ in range(2)]
    assert int(outs[0].n_inliers) == int(outs[1].n_inliers) >= 250
    assert torch.equal(outs[0].normal, outs[1].normal)


class TestArOverlay:
    """``tests/test_aux.py::TestArOverlay`` on the port."""

    def test_plane_ransac_recovers_synthetic_plane(self):
        pts, n = _plane_points(0)
        plane = ar.fit_plane_ransac(torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool),
                                    generator=torch.Generator().manual_seed(1), inlier_th=0.02)
        assert bool(plane.ok)
        assert int(plane.n_inliers) >= 250
        n_est = plane.normal.numpy()
        assert abs(float(n_est @ n)) > 0.99, f"normal {n_est} vs {n}"

    def test_overlay_writes_png(self, tmp_path):
        cam = make_camera(320.0, 320.0, 160.0, 120.0, width=320, height=240)
        plane = ar.Plane(normal=torch.tensor([0.0, 0.0, -1.0]), point=torch.tensor([0.0, 0.0, 3.0]),
                         n_inliers=torch.tensor(100), ok=torch.tensor(True))
        img = np.full((240, 320), 128, np.uint8)
        p = tmp_path / "ar.png"
        ar.draw_ar_overlay(img, np.eye(4), cam, plane, str(p), size=0.5)
        assert p.exists() and p.stat().st_size > 1000
