"""The PyTorch port stands alone: it imports without JAX, dispatches by
tensor device, and refuses what it has not ported yet."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.config import CameraSettings, OrbSettings, Settings, TpuSettings
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.models.tracking import Tracker
from orbslam2_tpu_torch.ops import fast, hamming

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
    "orbslam2_tpu_torch.models.frame",
    "orbslam2_tpu_torch.models.map_state",
    "orbslam2_tpu_torch.models.tracking",
    "orbslam2_tpu_torch.models.track_fused",
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
    (dict(sensor="stereo", enable_mapping=False, enable_loop_closing=False), "item 12"),
    (dict(sensor="rgbd", enable_loop_closing=False), "item 9"),
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
        SlamSystem(_settings(), **kwargs)


def test_tracker_refuses_mapper_database_loop_closer():
    for kw in ("local_mapper", "database", "loop_closer"):
        with pytest.raises(NotImplementedError):
            Tracker(_settings(), **{kw: object()})


def test_slice_system_constructs_on_cpu():
    s = SlamSystem(_settings(), "rgbd", enable_mapping=False, enable_loop_closing=False)
    assert s.tracker.map.pt_pos.device.type == "cpu"
    assert s.metrics()["n_keyframes"] == 0


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (40, 50)).astype(np.float32))
    kernels.reset_launch_counts()
    assert torch.equal(fast.fast_score_nms(img), fast.nms3x3(fast.fast_score(img)))
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (5, 8)).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 8)).astype(np.int32))
    assert torch.equal(hamming.hamming_matrix(a, b), hamming._hamming_plain(a, b))
    assert kernels.LAUNCHES == {"fast_score_nms": 0, "hamming_matrix": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    # The wrappers never fall back: a tensor that is not on a CUDA device
    # is an error (checked before any build is attempted).
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fast_score_nms_cuda(torch.zeros(8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hamming_matrix_cuda(torch.zeros(2, 8, dtype=torch.int32),
                                    torch.zeros(2, 8, dtype=torch.int32))


def test_build_is_keyed_by_the_sources():
    p = kernels.library_path()
    assert p.parent.parent == kernels.BUILD_ROOT
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    for name in kernels._SOURCES:
        assert (kernels._CSRC / name).is_file()
