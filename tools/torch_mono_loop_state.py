"""Write the reference's state just before its first mono loop correction.

    JAX_PLATFORMS=cpu python tools/torch_mono_loop_state.py [PATH]

Runs ``tests/test_slam_e2e.py::test_mono_loop_closure_production_config``
through the JAX reference on the CPU (``torch_reference_ate.py
--mono-loop``, about 9 minutes) and writes, to ``PATH`` (default
``tests/torch_mono_loop_state.npz``), the state that the first
``LoopCloser.process_keyframe`` that adds a loop edge started from:

* ``map.<field>``: every ``MapState`` field;
* ``db.<name>``: the keyframe database's arrays, and ``vocab.<field>`` its
  vocabulary (k=10, L=4, trained on every 6th frame);
* ``edges.S`` and ``key``: the loop closer's earlier edges' Sim3s and its
  RANSAC key; ``draws``: the (128, 3) Sim3 RANSAC samples the call drew;
* ``out.kf_pose_cw`` and ``out.pt_pos``: the corrected map's poses and
  points;
* ``meta``: JSON of the keyframe id and frame, the streaks, the last loop
  keyframe, the earlier edges' keyframes, the database's layout and the
  run's result (edge, S_CL, scale, frames lost, ATE).

``tests/test_torch_mono_loop.py`` and ``chip_smoke.py``'s ``mono_loop``
phase load it (``chip_smoke.mono_loop_state``).  Prints the run's JSON line
and the file's size.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

DEFAULT = ROOT / "tests" / "torch_mono_loop_state.npz"


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch_reference_ate as ra

    path = Path(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT
    result = ra.mono_loop_main(save=path)
    if result["fired_kf"] is None:
        print("the reference fired no loop: nothing written", file=sys.stderr)
        return 1
    print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
