"""The port's dataset loaders and EuRoC rectification against the
reference's on the CPU.

TUM (mono and RGB-D), KITTI (``times.txt``, ``image_0``, ``image_1``) and
EuRoC (``cam0/data``, ``cam1/data``, a timestamp file) layouts are written
to a temporary directory from seeded arrays; each port loader must yield
exactly the reference's timestamps, paths and arrays.  The rectification
maps and the bilinear remap must equal the reference's bit for bit; the
reference's own three rectification cases run on the port.
"""

import numpy as np
import pytest
from PIL import Image

from orbslam2_tpu.utils import datasets as jds
from orbslam2_tpu_torch.utils import datasets as ds
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H, W = 24, 32


def _gray(rng):
    return rng.integers(0, 256, (H, W)).astype(np.uint8)


def _equal_streams(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype == np.float32 and np.array_equal(u, v)
            else:
                assert u == v


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    rng = np.random.default_rng(0)
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rgb, assoc = ["# color images", "# timestamp filename"], []
    for i in range(5):
        ts = 1305031100.0 + i / 30.0
        Image.fromarray(_gray(rng)).save(root / f"rgb/{ts:.6f}.png")
        Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16)).save(
            root / f"depth/{ts + 0.004:.6f}.png")
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        assoc.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts + 0.004:.6f} depth/{ts + 0.004:.6f}.png")
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n\n")
    (root / "assoc.txt").write_text("# associations\n" + "\n".join(assoc) + "\n")
    return root


def test_tum_lists_and_frames(tum_dir):
    root, assoc = str(tum_dir), str(tum_dir / "assoc.txt")
    assert ds.load_tum_rgb_list(root) == jds.load_tum_rgb_list(root)
    assert len(ds.load_tum_rgb_list(root)) == 5
    assert ds.load_tum_associations(assoc, root) == jds.load_tum_associations(assoc, root)
    _equal_streams(ds.iter_tum_mono(root), jds.iter_tum_mono(root))
    _equal_streams(ds.iter_tum_rgbd(root, assoc), jds.iter_tum_rgbd(root, assoc))
    # 16-bit depth decodes to its raw values (the system divides by
    # DepthMapFactor).
    _, _, depth = next(ds.iter_tum_rgbd(root, assoc))
    assert depth.max() > 255


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(1)
    (root / "image_0").mkdir()
    (root / "image_1").mkdir()
    for i in range(4):
        Image.fromarray(_gray(rng)).save(root / f"image_0/{i:06d}.png")
        Image.fromarray(_gray(rng)).save(root / f"image_1/{i:06d}.png")
    (root / "times.txt").write_text("".join(f"{i * 0.1036:.6e}\n" for i in range(4)))
    return root


@pytest.mark.parametrize("stereo", [False, True])
def test_kitti_sequence(kitti_dir, stereo):
    root = str(kitti_dir)
    assert np.array_equal(ds.load_kitti_times(root), jds.load_kitti_times(root))
    _equal_streams(ds.iter_kitti(root, stereo=stereo), jds.iter_kitti(root, stereo=stereo))
    assert (next(ds.iter_kitti(root, stereo=stereo))[2] is None) == (not stereo)


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc")
    rng = np.random.default_rng(2)
    (root / "cam0" / "data").mkdir(parents=True)
    (root / "cam1" / "data").mkdir(parents=True)
    stamps = [str(1403636579763555584 + 50000000 * i) for i in range(4)]
    for st in stamps:
        Image.fromarray(_gray(rng)).save(root / "cam0" / "data" / f"{st}.png")
        Image.fromarray(_gray(rng)).save(root / "cam1" / "data" / f"{st}.png")
    (root / "stamps.txt").write_text("\n".join(stamps) + "\n\n")
    return root


@pytest.mark.parametrize("stereo", [False, True])
def test_euroc_sequence(euroc_dir, stereo):
    root, stamps = str(euroc_dir), str(euroc_dir / "stamps.txt")
    assert ds.load_euroc_timestamps(stamps) == jds.load_euroc_timestamps(stamps)
    _equal_streams(ds.iter_euroc(root, stamps, stereo=stereo),
                   jds.iter_euroc(root, stamps, stereo=stereo))


def _euroc_calibration():
    # EuRoC's cam0 block (Examples/Stereo/EuRoC.yaml's LEFT.*).
    K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]])
    D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
    R = np.array([[0.999966347530033, -0.001422739138722922, 0.008079580483432283],
                  [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
                  [-0.008089410156878961, -0.007044357138835809, 0.9999424675829176]])
    P = np.array([[435.2046959714599, 0, 367.4517211914062, 0],
                  [0, 435.2046959714599, 252.2008514404297, 0], [0, 0, 1, 0]])
    return K, D, R, P


def test_rectify_maps_and_remap_equal_the_reference():
    """``build_rectify_maps`` and ``remap_bilinear`` are the reference's
    numpy, bit for bit (np.array_equal), on EuRoC's calibration at 752x480
    and on a seeded image."""
    K, D, R, P = _euroc_calibration()
    mx, my = ds.build_rectify_maps(K, D, R, P, 752, 480)
    jx, jy = jds.build_rectify_maps(K, D, R, P, 752, 480)
    assert mx.dtype == np.float32 and np.array_equal(mx, jx) and np.array_equal(my, jy)
    img = np.random.default_rng(3).uniform(0, 255, (480, 752)).astype(np.float32)
    out = ds.remap_bilinear(img, mx, my)
    assert out.dtype == np.float32 and np.array_equal(out, jds.remap_bilinear(img, jx, jy))
    assert (out > 0).mean() > 0.9


class TestRectification:
    """``tests/test_viewer_rectify.py::TestRectification`` on the port."""

    def test_identity_maps(self):
        K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
        mx, my = ds.build_rectify_maps(K, np.zeros(4), np.eye(3), K, 160, 120)
        u, v = np.meshgrid(np.arange(160), np.arange(120))
        np.testing.assert_allclose(mx, u, atol=1e-3)
        np.testing.assert_allclose(my, v, atol=1e-3)

    def test_rectified_rotation_consistency(self):
        K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
        a = 0.02  # a rotation about y
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        mx, my = ds.build_rectify_maps(K, np.zeros(4), R, K, 160, 120)
        ray = np.linalg.inv(K) @ np.array([100.0, 60.0, 1.0])
        src_ray = R.T @ ray  # the map applies ray @ R, that is R^T ray
        src_px = K @ (src_ray / src_ray[2])
        np.testing.assert_allclose(mx[60, 100], src_px[0], atol=1e-2)
        np.testing.assert_allclose(my[60, 100], src_px[1], atol=1e-2)

    def test_remap_bilinear_translation(self):
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
        u, v = np.meshgrid(np.arange(50, dtype=np.float32), np.arange(40, dtype=np.float32))
        out = ds.remap_bilinear(img, u + 0.5, v)
        expect = 0.5 * (img[:, :-1] + img[:, 1:])  # a half-pixel shift averages neighbours
        np.testing.assert_allclose(out[:, :48], expect[:, :48], atol=1e-4)
