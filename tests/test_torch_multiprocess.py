"""The port's sharded BA step across operating-system processes, as
``tests/test_multiprocess.py`` runs the JAX package's: two processes of
``tools/torch_multiproc_worker.py``, one rank each, joined by
``initialize_distributed`` (gloo, through a file under the test's
directory: no port to collide with), solve one problem with its 8 cameras
sharded over them and then alone.  Gates: the reference test's, the
sharded solve converged (below a quarter of the starting error) and
within 2e-4 of the one-process solve; and both ranks report the same.

``graft_entry_torch.dryrun_multichip`` runs its five steps on two CPU
ranks.
"""

import json
import os
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_distributed_ba(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs = [], []
    for rank in range(2):
        out = tmp_path / f"rank{rank}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "torch_multiproc_worker.py"),
             f"file://{tmp_path}/init", "2", str(rank), str(out), "--backend", "gloo",
             "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    results = [json.loads(o.read_text()) for o in outs]
    for r in results:
        assert r["world_size"] == 2 and r["n_cams"] == 8
        assert r["err_global_mesh"] < 0.25 * r["err_before"], r
        assert r["pose_max_abs_gap"] < 2e-4, r
    a, b = results
    assert (a["err_global_mesh"], a["pose_max_abs_gap"]) == (b["err_global_mesh"],
                                                             b["pose_max_abs_gap"])


def test_worker_refuses_one_process(tmp_path):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_multiproc_worker.py"),
         f"file://{tmp_path}/init", "1", "0", str(tmp_path / "out.json"), "--backend", "gloo",
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert res.returncode != 0 and "one process" in res.stderr


def test_dryrun_multichip_on_two_cpu_ranks():
    sys.path.insert(0, REPO)
    import graft_entry_torch

    graft_entry_torch.dryrun_multichip(2, device="cpu", backend="gloo")


@pytest.mark.parametrize("path", ["graft_entry_torch.py", "tools/torch_multiproc_worker.py"])
def test_entry_points_import_nothing_of_jax(path):
    import ast

    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "orbslam2_tpu"), (path, name)
