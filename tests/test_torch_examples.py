"""The port's example CLIs on the CPU.

``examples/torch_run_dataset.py --device cpu`` runs as a subprocess over
``tests/test_dataset_driver.py``'s 14-frame 320x240 TUM RGB-D fixture
(PNGs on disk, an association file, a reference-format settings YAML) and
writes both trajectory files and the map, equal to the port's
``SlamSystem`` fed the decoded frames in this process (the reference's
``test_dataset_e2e.py`` on the port); ``tests/test_evaluate.py``'s system
check runs on that trajectory.  Every other ``examples/torch_*.py`` runs ``main([...,
"--device", "cpu"])`` at its smallest size, exits 0 and writes its
outputs.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import Settings
from orbslam2_tpu_torch.models.system import SlamSystem
from orbslam2_tpu_torch.utils import datasets

from test_dataset_driver import tum_dir  # noqa: F401  (the fixture)
from test_evaluate import _write_tum
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _example(name):
    """``examples/<name>.py`` as the module ``name`` (registered, so that
    its functions pickle into worker processes)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture(scope="module")
def dataset_runs(tum_dir, tmp_path_factory):  # noqa: F811
    """The dataset CLI as a subprocess over the fixture, and the port's
    SlamSystem fed the frames decoded in this process."""
    root, seq = tum_dir
    tmp = tmp_path_factory.mktemp("torch_run_dataset")
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_run_dataset.py"), "--dataset", "tum",
         "--sensor", "rgbd", "--path", str(root), "--assoc", str(root / "assoc.txt"),
         "--settings", str(root / "settings.yaml"), "--out", str(out),
         "--save-map", str(out / "map.npz"), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp)
    settings = Settings.from_yaml(str(root / "settings.yaml"), sensor="rgbd")
    system = SlamSystem(settings, "rgbd", device="cpu")
    for ts, image, depth in datasets.iter_tum_rgbd(str(root), str(root / "assoc.txt")):
        system.track_rgbd(image, depth, ts)
    system.shutdown()
    return dict(proc=proc, out=out, tmp=tmp, system=system, seq=seq)


def test_run_dataset_cli_equals_the_system_in_process(dataset_runs):
    r = dataset_runs
    proc, out, tmp = r["proc"], r["out"], r["tmp"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "median tracking time" in proc.stdout and "frames: 14 read" in proc.stdout
    traj = (out / "CameraTrajectory.txt").read_text()
    assert len(traj.strip().split("\n")) == 14
    r["system"].save_trajectory_tum(str(tmp / "traj.txt"))
    r["system"].save_keyframe_trajectory_tum(str(tmp / "kf.txt"))
    assert traj == (tmp / "traj.txt").read_text()
    assert (out / "KeyFrameTrajectory.txt").read_text() == (tmp / "kf.txt").read_text()
    # The saved map is the system's.
    from orbslam2_tpu_torch.utils.checkpoint import load_map

    m, saved = r["system"].map, load_map(str(out / "map.npz"), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(m, saved))


def test_matches_system_trajectory_output(dataset_runs, tmp_path):
    """``tests/test_evaluate.py::test_matches_system_trajectory_output`` on
    the port: the CLI's saved TUM trajectory, evaluated by
    examples/evaluate.py against a ground-truth file, reproduces
    ``synthetic.ate_rmse`` of the system's poses."""
    from orbslam2_tpu_torch.utils import synthetic

    seq = dataset_runs["seq"]
    _write_tum(tmp_path / "gt.txt", seq.timestamps, seq.poses_wc)
    res = _example("torch_run_dataset").load_evaluate().evaluate_files(
        str(dataset_runs["out"] / "CameraTrajectory.txt"), str(tmp_path / "gt.txt"),
        max_diff=0.05)
    direct = synthetic.ate_rmse(dataset_runs["system"].poses_wc(), seq.poses_wc,
                                with_scale=False)
    assert res["pairs"] == 14
    assert abs(res["ate_rmse_m"] - direct) < 5e-3, (res, direct)


def test_run_synthetic(tmp_path, capsys):
    """Its exit code is its ATE gate (0 below 0.2 m).  At this size the
    sequence loses track in both packages (the reference's
    ``run_synthetic.py --sensor stereo --frames 6``: ATE 0.5141 m, the
    port's 0.5150 m; ROADMAP Queue 3), so the code is checked against the
    ATE it prints."""
    out = tmp_path / "out"
    rc = _example("torch_run_synthetic").main(
        ["--sensor", "stereo", "--frames", "2", "--out", str(out), "--viewer",
         "--viewer-every", "1", "--profile", "--device", "cpu"])
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt",
                 "CameraTrajectory_kitti.txt", "map.png", "frame.png", "map_final.png"):
        assert (out / name).stat().st_size > 0, name
    assert json.loads((out / "trace" / "trace.json").read_text())["traceEvents"]
    line = [x for x in capsys.readouterr().out.split("\n") if x.startswith("ATE RMSE")]
    ate = float(line[0].split(": ")[1].split(" m")[0])
    assert rc == (0 if ate < 0.2 else 1)


def test_run_matrix(tmp_path, capsys):
    out = tmp_path / "matrix.json"
    assert _example("torch_run_matrix").main(
        ["--frames", "3", "--cells", "rgbd_640", "--workers", "2", "--cache-dir",
         str(tmp_path), "--out", str(out), "--device", "cpu"]) == 0
    (row,) = json.loads(out.read_text())
    assert row["cell"] == "rgbd_640" and row["frames"] == 3 and row["device"] == "cpu"
    assert np.isfinite(row["ate_rmse_m"]) and 0 <= row["tracked_pct"] <= 100
    # The render split over two processes is the single-process render.
    cached = np.load(tmp_path / "torch_matrix_rgbd_640_3.npz")
    from orbslam2_tpu_torch.utils import synthetic

    settings, radius, room, n_pts = _example("torch_run_matrix").cell_settings(640, 480, 1000)
    seq = synthetic.make_loop_sequence(settings.camera_model(), n_frames=3,
                                       circle_radius=radius, n_points=n_pts, seed=5,
                                       room_half=room, with_depth=True)
    assert np.array_equal(cached["images"], seq.images)
    assert np.array_equal(cached["depths"], seq.depths)
    assert np.array_equal(cached["poses"], seq.poses_wc)


def test_live_demo(tmp_path):
    assert _example("torch_live_demo").main(
        ["--frames", "3", "--out", str(tmp_path), "--device", "cpu"]) == 0
    assert (tmp_path / "KeyFrameTrajectory.txt").stat().st_size > 0


def test_ar_demo(tmp_path):
    assert _example("torch_ar_demo").main(
        ["--frames", "3", "--out", str(tmp_path), "--device", "cpu"]) == 0
    assert [p.name for p in sorted(tmp_path.glob("ar_*.png"))] == [
        "ar_000.png", "ar_001.png", "ar_002.png"]


def test_eval_mono_circle(capsys):
    assert _example("torch_eval_mono_circle").main(["--frames", "4", "--device", "cpu"]) == 0
    assert "frames=4" in capsys.readouterr().out


def test_run_reference_scale(tmp_path, capsys):
    assert _example("torch_run_reference_scale").main(
        ["--frames", "6", "--width", "320", "--height", "96", "--features", "512",
         "--cache", str(tmp_path / "seq.npz"), "--out", str(tmp_path / "out"),
         "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().split("\n")[-1])
    assert report["frames"] == 6 and report["device"] == "cpu"
    assert (tmp_path / "out" / "CameraTrajectory.txt").stat().st_size > 0
