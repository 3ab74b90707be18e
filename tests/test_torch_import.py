"""The PyTorch port stands alone: it imports without JAX, dispatches by
tensor device, runs on the card unless asked for the CPU, builds the
reference's keyframe database in every system, and refuses what it has not
ported yet."""

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
from orbslam2_tpu_torch.models.kf_database import KeyframeDatabase
from orbslam2_tpu_torch.models.local_mapping import LocalMapper
from orbslam2_tpu_torch.models.loop_closing import LoopCloser
from orbslam2_tpu_torch.models.system import SlamSystem, _default_vocabulary
from orbslam2_tpu_torch.models.tracking import Tracker
from orbslam2_tpu_torch.ops import fast, hamming
from orbslam2_tpu_torch.ops.extractor import OrbExtractor
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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
    "orbslam2_tpu_torch.ops.sim3_solve",
    "orbslam2_tpu_torch.ops.pnp",
    "orbslam2_tpu_torch.ops.bow",
    "orbslam2_tpu_torch.utils.native",
    "orbslam2_tpu_torch.utils.vocab",
    "orbslam2_tpu_torch.solvers.ba_kernels",
    "orbslam2_tpu_torch.solvers.local_ba",
    "orbslam2_tpu_torch.solvers.sim3_opt",
    "orbslam2_tpu_torch.solvers.pose_graph",
    "orbslam2_tpu_torch.solvers.global_ba",
    "orbslam2_tpu_torch.models.frame",
    "orbslam2_tpu_torch.models.map_state",
    "orbslam2_tpu_torch.models.tracking",
    "orbslam2_tpu_torch.models.track_fused",
    "orbslam2_tpu_torch.models.local_mapping",
    "orbslam2_tpu_torch.models.kf_database",
    "orbslam2_tpu_torch.models.loop_closing",
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
    (dict(sensor="rgbd", enable_mapping=False, async_mapping=True), "item 10"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False, chunk=8), "item 11"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False, pipeline=True),
     "item 11"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False,
          async_mapping=True), "item 10"),
    (dict(sensor="rgbd", enable_mapping=False, enable_loop_closing=False, mesh=object()),
     "item 17"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        SlamSystem(_settings(), **kwargs, device="cpu")


def test_tracker_refuses_mapper_database_loop_closer():
    # A mapper, database or loop closer that is not this package's is
    # refused; this package's are accepted.
    with pytest.raises(TypeError, match="LocalMapper"):
        Tracker(_settings(), local_mapper=object(), device="cpu")
    with pytest.raises(TypeError, match="KeyframeDatabase"):
        Tracker(_settings(), database=object(), device="cpu")
    db = KeyframeDatabase(_default_vocabulary(), 16, device="cpu")
    assert Tracker(_settings(), database=db, device="cpu").database is db
    with pytest.raises(TypeError, match="LoopCloser"):
        Tracker(_settings(), loop_closer=object(), device="cpu")
    lc = LoopCloser(_settings(), db, fix_scale=True, device="cpu")
    assert Tracker(_settings(), database=db, loop_closer=lc, device="cpu").loop_closer is lc
    with pytest.raises(TypeError, match="KeyframeDatabase"):
        LoopCloser(_settings(), object(), fix_scale=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        LoopCloser(_settings(), db, fix_scale=True, mesh=object(), device="cpu")


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_default_system_closes_loops(sensor):
    # The reference's defaults: mapping and loop closing on, scale fixed.
    s = SlamSystem(_settings(), sensor, device="cpu")
    assert isinstance(s.loop_closer, LoopCloser)
    assert s.tracker.loop_closer is s.loop_closer
    assert s.loop_closer.db is s.database
    assert s.loop_closer.fix_scale
    assert isinstance(s.tracker.local_mapper, LocalMapper)
    assert s.metrics()["n_loop_closures"] == 0
    assert SlamSystem(_settings(), sensor, enable_loop_closing=False,
                      device="cpu").loop_closer is None


def test_vocabulary_is_accepted():
    """``vocabulary=`` takes this package's Vocabulary (the database is
    built on it) and refuses anything else."""
    rng = np.random.default_rng(0)
    from orbslam2_tpu_torch.ops.bow import train_vocabulary

    vocab = train_vocabulary(rng.integers(0, 2**32, (500, 8), dtype=np.uint32), k=5, levels=2)
    s = SlamSystem(_settings(), "rgbd", enable_mapping=False, enable_loop_closing=False,
                   vocabulary=vocab, device="cpu")
    assert s.vocabulary is vocab and s.database.vocab.n_words == 25
    assert s.tracker.database is s.database
    with pytest.raises(TypeError, match="Vocabulary"):
        SlamSystem(_settings(), "rgbd", enable_loop_closing=False, vocabulary=object(),
                   device="cpu")


def test_every_system_builds_the_default_database():
    s = SlamSystem(_settings(), "stereo", enable_loop_closing=False, device="cpu")
    assert s.database.vocab.n_words == 1000 and not s.database.sparse
    assert s.database.bow.shape == (16, 1000) and s.database.bow.device.type == "cpu"
    assert s.tracker.database is s.database
    assert s.metrics()["relocalizations"] == 0


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


def test_loop_closer_runs_after_each_keyframe_without_a_mapper():
    # The tracker hands every keyframe to the loop closer after local
    # mapping, and with no local mapper too (the reference's order).
    from orbslam2_tpu_torch.utils import synthetic

    s = SlamSystem(_settings(), "rgbd", enable_mapping=False, device="cpu")
    calls = []
    inner = s.loop_closer.process_keyframe

    def recorded(m, kf_id, abort=None):
        calls.append(kf_id)
        return inner(m, kf_id, abort)

    s.loop_closer.process_keyframe = recorded
    seq = synthetic.make_sequence(_settings().camera_model(), n_frames=12, n_points=400,
                                  with_depth=True, seed=11)
    for i in range(12):
        s.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
    created = s.tracker.metrics["keyframes_created"]
    assert created >= 1 and calls == list(range(1, created + 1))
