"""The PyTorch port stands alone: it imports without JAX, dispatches by
tensor device, runs on the card unless asked for the CPU, and refuses what
it has not ported yet."""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu_torch.models import map_state
from orbslam2_tpu_torch.models.local_mapping import LocalMapper
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.models.tracking import Tracker
from orbslam2_tpu_torch.ops import fast, hamming
from orbslam2_tpu_torch.ops.extractor import OrbExtractor

REPO = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "orbslam2_tpu_torch",
    "orbslam2_tpu_torch.config",
    "orbslam2_tpu_torch.convert",
    "orbslam2_tpu_torch.kernels",
    "orbslam2_tpu_torch.utils.camera",
    "orbslam2_tpu_torch.utils.synthetic",
    "orbslam2_tpu_torch.solvers.lie",
    "orbslam2_tpu_torch.solvers.pose_opt",
    "orbslam2_tpu_torch.ops.pyramid",
    "orbslam2_tpu_torch.ops.fast",
    "orbslam2_tpu_torch.ops.select",
    "orbslam2_tpu_torch.ops.orb",
    "orbslam2_tpu_torch.ops.extractor",
    "orbslam2_tpu_torch.ops.hamming",
    "orbslam2_tpu_torch.ops.matcher",
    "orbslam2_tpu_torch.ops.stereo",
    "orbslam2_tpu_torch.ops.twoview",
    "orbslam2_tpu_torch.solvers.ba_kernels",
    "orbslam2_tpu_torch.solvers.local_ba",
    "orbslam2_tpu_torch.models.frame",
    "orbslam2_tpu_torch.models.map_state",
    "orbslam2_tpu_torch.models.tracking",
    "orbslam2_tpu_torch.models.track_fused",
    "orbslam2_tpu_torch.models.local_mapping",
    "orbslam2_tpu_torch.models.system",
]


def _settings():
    return Settings(
        camera=CameraSettings(fx=320.0, fy=320.0, cx=160.0, cy=120.0,
                              width=320, height=240, bf=32.0),
        orb=OrbSettings(n_features=500, n_levels=4),
        tpu=TpuSettings(max_keypoints=512, max_keyframes=16, max_points=4096),
    )


def test_port_imports_without_jax():
    # A None entry in sys.modules makes any `import jax` raise ImportError.
    code = (
        "import sys, importlib; sys.modules['jax'] = None\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "assert not any(k in ('jax', 'orbslam2_tpu')"
        " or k.startswith(('jax.', 'orbslam2_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("kwargs, item", [
    (dict(sensor="mono", enable_mapping=False, enable_loop_closing=False), "item 13"),
    (dict(sensor="rgbd", enable_loop_closing=False, mapping_device="cpu"), "item 10"),
    (dict(sensor="rgbd", enable_mapping=False), "item 15"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False, chunk=8), "item 11"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False, pipeline=True),
     "item 11"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False,
          async_mapping=True), "item 10"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False, mesh=object()),
     "item 17"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False,
          vocabulary=object()), "item 14"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        SlamSystem(_settings(), **kwargs, device="cpu")


def test_tracker_refuses_mapper_database_loop_closer():
    # A mapper that is not this package's LocalMapper is refused; the BoW
    # database and loop closing are not ported yet.
    with pytest.raises(TypeError, match="LocalMapper"):
        Tracker(_settings(), local_mapper=object(), device="cpu")
    for kw in ("database", "loop_closer"):
        with pytest.raises(NotImplementedError):
            Tracker(_settings(), **{kw: object()}, device="cpu")


def test_stereo_system_constructs_on_cpu():
    s = SlamSystem(_settings(), "stereo", enable_loop_closing=False, device="cpu")
    assert s.sensor == "stereo"
    assert isinstance(s.local_mapper, LocalMapper)
    assert s.local_mapper.n_tri_neighbors == min(s.settings.tpu.tri_neighbors_stereo, 15)
    assert s.local_mapper._bf == s.settings.camera.bf


def test_mono_still_raises():
    with pytest.raises(NotImplementedError, match="monocular tracking.*item 13"):
        SlamSystem(_settings(), "mono", enable_loop_closing=False, device="cpu")
    with pytest.raises(ValueError, match="unknown sensor"):
        SlamSystem(_settings(), "lidar", enable_loop_closing=False, device="cpu")


def test_slice_system_constructs_on_cpu():
    s = SlamSystem(_settings(), "rgbd", enable_mapping=False, enable_loop_closing=False,
                   device="cpu")
    assert s.tracker.map.pt_pos.device.type == "cpu"
    assert s.metrics()["n_keyframes"] == 0
    assert s.tracker.local_mapper is None


def test_mapping_system_constructs_on_cpu():
    s = SlamSystem(_settings(), "rgbd", enable_loop_closing=False, device="cpu")
    assert isinstance(s.tracker.local_mapper, LocalMapper)
    assert s.tracker.local_mapper is s.local_mapper
    assert Tracker(_settings(), local_mapper=LocalMapper(_settings(), sensor="rgbd"),
                   device="cpu").local_mapper is not None


@pytest.mark.parametrize("entry", [SlamSystem.__init__, Tracker.__init__, OrbExtractor.__init__])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_map_device_has_no_default():
    assert inspect.signature(map_state.make_empty_map).parameters["device"].default is (
        inspect.Parameter.empty)


def test_default_device_never_falls_back_to_the_cpu():
    """With no card, a default-device system fails where torch first
    touches CUDA; it never moves to the CPU."""
    if torch.cuda.is_available():
        s = SlamSystem(_settings(), "rgbd", enable_loop_closing=False)
        assert s.tracker.map.pt_pos.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        SlamSystem(_settings(), "rgbd", enable_loop_closing=False)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (40, 50)).astype(np.float32))
    kernels.reset_launch_counts()
    assert torch.equal(fast.fast_score_nms(img), fast.nms3x3(fast.fast_score(img)))
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (5, 8)).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 8)).astype(np.int32))
    assert torch.equal(hamming.hamming_matrix(a, b), hamming._hamming_plain(a, b))
    assert set(kernels.LAUNCHES) == {
        "fast_score_nms", "hamming_matrix", "projection_best2", "ba_normal_equations",
        "ba_chi2"}
    assert set(kernels.LAUNCHES.values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors():
    # The wrappers never fall back: a tensor that is not on a CUDA device
    # is an error (checked before any build is attempted).
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fast_score_nms_levels_cuda([torch.zeros(8, 8)])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hamming_matrix_cuda(torch.zeros(2, 8, dtype=torch.int32),
                                    torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.projection_best2_cuda(
            torch.zeros(2, 2), torch.ones(2), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, 8, dtype=torch.int32), torch.ones(2, dtype=torch.bool),
            torch.zeros(2, 2), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, 8, dtype=torch.int32), torch.ones(2, dtype=torch.bool), 1)
    C, N = 2, 5
    ba = (torch.eye(4).repeat(C, 1, 1), torch.zeros(C, 3, N), torch.zeros(C, 2, N),
          torch.zeros(C, N), torch.ones(C, N), torch.ones(C, N, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ba_normal_equations_cuda(*ba, (1.0, 1.0, 0.0, 0.0, 0.0), True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ba_chi2_cuda(*ba, (1.0, 1.0, 0.0, 0.0, 0.0))


def test_build_is_keyed_by_the_sources():
    p = kernels.library_path()
    assert p.parent.parent == kernels.BUILD_ROOT
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    for name in kernels._SOURCES:
        assert (kernels._CSRC / name).is_file()
