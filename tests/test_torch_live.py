"""The port's live drivers against the reference's on the CPU.

``ApproxTimeSync`` emits the same pairs, in the same order, with the same
``dropped`` counts as the reference's on seeded jittered, out-of-order and
gapped streams, and passes the reference's three sync cases.
``LiveDriver`` over ``tests/test_live.py``'s 14-frame 320x240 RGB-D stream
(jittered depth stamps, alternating arrival order) gives the reference's
states, paths, keyframes and poses (``torch_drivers.check_pair``: poses
within 2e-4 m and rad, the reference's RANSAC draws; the reference's own
0.05 m gate on that stream is red, ROADMAP Queue 3).  The port's
``SlamSystem`` fed the same frames in order, with ``LiveViewer.update``
after every frame (a snapshot at every keyframe), repeats that run bit for
bit: the driver and the viewer add nothing.  Stereo topics out of order
through a rectification hook reach the system paired and rectified, in
order.
"""

import numpy as np
import pytest

from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu.utils.live import ApproxTimeSync as JApproxTimeSync
from orbslam2_tpu.utils.live import LiveDriver as JLiveDriver
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.utils.live import ApproxTimeSync, LiveDriver

from test_slam_e2e import small_settings
from torch_carried_tracker import JaxSampler
from torch_drivers import check_pair, make_pair, record
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _streams(seed, n=60, kind="jitter"):
    """Seeded (side, t, payload) messages of two streams at 30 Hz."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n):
        t = i / 30.0
        if kind == "gaps" and rng.uniform() < 0.2:
            continue  # a frame missing on both sides
        ta = t + rng.normal(0, 0.004)
        tb = t + rng.uniform(-0.025, 0.025)
        if kind == "gaps" and rng.uniform() < 0.25:
            msgs.append(("a", ta, f"a{i}"))  # b lost
            continue
        msgs += [("a", ta, f"a{i}"), ("b", tb, f"b{i}")]
    if kind == "out_of_order":
        # Arrival order shuffled within windows of 4 messages.
        for k in range(0, len(msgs), 4):
            window = msgs[k:k + 4]
            rng.shuffle(window)
            msgs[k:k + 4] = window
    return msgs


@pytest.mark.parametrize("kind", ["jitter", "out_of_order", "gaps"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slop, queue", [(0.02, 10), (0.01, 3)])
def test_sync_matches_the_reference(kind, seed, slop, queue):
    runs = []
    for cls in (ApproxTimeSync, JApproxTimeSync):
        got = []
        s = cls(slop=slop, queue_size=queue, callback=lambda *p, got=got: got.append(p))
        returned = []
        for side, t, payload in _streams(seed, kind=kind):
            returned += (s.put_a if side == "a" else s.put_b)(t, payload)
        assert returned == got
        runs.append((got, s.dropped))
    assert runs[0] == runs[1]
    assert runs[0][0], "no pair emitted"


class TestApproxTimeSync:
    """``tests/test_live.py::TestApproxTimeSync`` on the port."""

    def test_pairs_jittered_streams(self):
        got = []
        s = ApproxTimeSync(slop=0.02, callback=lambda t, a, b: got.append((t, a, b)))
        for i in range(10):
            s.put_a(i * 0.1, f"a{i}")
            s.put_b(i * 0.1 + 0.008, f"b{i}")  # 8 ms apart, within the slop
        assert len(got) == 10
        assert all(a[1:] == b[1:] for _, a, b in got)

    def test_drops_unmatched(self):
        got = []
        s = ApproxTimeSync(slop=0.01, callback=lambda t, a, b: got.append(t))
        s.put_a(0.0, "a0")
        s.put_b(0.5, "b0")  # 0.5 s apart: no pair, a0 dropped
        s.put_a(0.501, "a1")
        assert len(got) == 1 and s.dropped == 1

    def test_prefers_closest(self):
        got = []
        s = ApproxTimeSync(slop=0.1, callback=lambda t, a, b: got.append((a, b)))
        s.put_a(0.00, "a0")
        s.put_a(0.05, "a1")
        s.put_b(0.06, "b0")
        assert got == [("a1", "b0")]  # a1, 10 ms away, beats a0, 60 ms away


def _feed_rgbd(drivers, seq, on_frame=None):
    """test_live.py's feed: jittered depth stamps, alternating order."""
    rng = np.random.default_rng(0)
    for i in range(len(seq.images)):
        t = float(seq.timestamps[i])
        jit = float(rng.uniform(0, 0.005))
        for drv in drivers:
            if i % 2:
                drv.feed_depth(seq.depths[i], t + jit)
                drv.feed_rgb(seq.images[i], t)
            else:
                drv.feed_rgb(seq.images[i], t)
                drv.feed_depth(seq.depths[i], t + jit)
        if on_frame is not None:
            on_frame()


@pytest.fixture(scope="module")
def rgbd_runs():
    s = small_settings(bf=32.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=14, n_points=400, with_depth=True,
                             seed=11)
    ref, port = make_pair(s)
    drivers = (JLiveDriver(ref, "rgbd", slop=0.02), LiveDriver(port, "rgbd", slop=0.02))
    logs = {"ref": [], "port": []}

    def on_frame():
        logs["ref"].append(record(ref))
        logs["port"].append(record(port))

    _feed_rgbd(drivers, seq, on_frame)
    for drv in drivers:
        drv.shutdown()
    return dict(s=s, seq=seq, ref=ref, port=port, drivers=drivers, logs=logs)


def test_live_rgbd_matches_the_reference(rgbd_runs):
    r = rgbd_runs
    assert [d.frames for d in r["drivers"]] == [14, 14]
    assert [d.dropped for d in r["drivers"]] == [0, 0]
    check_pair(r["ref"], r["port"], r["logs"], r["seq"].poses_wc)


def test_live_rgbd_repeats_the_system_fed_in_order(rgbd_runs, tmp_path):
    from orbslam2_tpu_torch.utils.viewer import LiveViewer

    r = rgbd_runs
    port, seq = r["port"], r["seq"]
    direct = SlamSystem(convert.settings_from_reference(r["s"]), "rgbd", device="cpu")
    direct.tracker._ransac_samples = JaxSampler(r["ref"].tracker.init_key)
    lv = LiveViewer(str(tmp_path / "snaps"), every_kf=1, follow_radius=1.0)
    for i in range(14):
        direct.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
        lv.update(direct)
    direct.shutdown()
    assert np.array_equal(port.poses_wc(), direct.poses_wc())
    assert port.tracker.metrics == direct.tracker.metrics
    kc = direct.tracker.metrics["keyframes_created"]
    assert kc >= 1 and lv.n_snaps == kc == len(list((tmp_path / "snaps").glob("map_*_kf.png")))
    # shutdown(path) writes the keyframe trajectory, as the ROS node does.
    path = tmp_path / "KeyFrameTrajectory.txt"
    r["drivers"][1].shutdown(str(path))
    assert len(path.read_text().strip().split("\n")) == int(port.map.kf_valid.sum())


class _Recorder:
    """A system that records what a driver hands it."""

    def __init__(self):
        self.calls = []

    def track_stereo(self, left, right, t):
        self.calls.append((left, right, t))


def test_live_stereo_with_rectify_hook():
    """``test_live.py::test_stereo_stream_with_rectify_hook``'s feed: stereo
    topics out of order, 3 ms apart, through a rectification hook, which
    runs on every image; each pair reaches the system rectified, in order,
    at the later stamp."""
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (12, 8, 10)).astype(np.float32)
    right = rng.uniform(0, 255, (12, 8, 10)).astype(np.float32)
    system = _Recorder()
    seen = []

    def rect(img):
        seen.append(img)
        return img + 1.0

    drv = LiveDriver(system, "stereo", slop=0.02, rectify=(rect, rect))
    for i in range(12):
        t = i / 30.0
        if i % 2:
            drv.feed_stereo_right(right[i], t + 0.003)
            drv.feed_stereo_left(left[i], t)
        else:
            drv.feed_stereo_left(left[i], t)
            drv.feed_stereo_right(right[i], t + 0.003)
    assert drv.frames == 12 and drv.dropped == 0 and len(seen) == 24
    for i, (a, b, t) in enumerate(system.calls):
        assert np.array_equal(a, left[i] + 1.0) and np.array_equal(b, right[i] + 1.0)
        assert t == i / 30.0 + 0.003


def test_live_driver_refuses_an_unknown_sensor():
    with pytest.raises(ValueError, match="unknown sensor"):
        LiveDriver(None, "lidar")
