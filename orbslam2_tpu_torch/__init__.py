"""orbslam2_tpu_torch — the PyTorch/CUDA port of ``orbslam2_tpu``.

The JAX package is the reference; this package mirrors its module paths and
public names (``ops/``, ``solvers/``, ``models/``, ``utils/``) so each
function has a counterpart of the same name.  It imports torch and numpy,
never jax.  The kernels that the JAX package wrote in Pallas are CUDA C++
sources under ``csrc/``, built and bound by ``kernels.py``; every wrapper
launches its kernel for a CUDA tensor and takes its plain PyTorch version
for a CPU tensor.

Ported so far: mono, stereo and RGB-D tracking with keyframe insertion
through the per-frame, pipelined and chunked drivers; local mapping, in
line or in a worker thread on map snapshots (async mapping); place
recognition with relocalization; loop closing; localization-only mode;
the System lifecycle (``reset``, ``shutdown``); and the drivers and
utilities: dataset loaders, map checkpoints, the live and AR drivers and
the viewer (``utils/``), with the ``examples/torch_*.py`` CLIs.  The
multi-device solvers are not ported yet (see ROADMAP.md).
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (Lie ops, pose optimization normal equations, the pyramid
# resampling matmuls) needs true f32 products, as the reference's
# ``jax_default_matmul_precision="highest"``: no TF32 in cuBLAS or cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import Settings, OrbSettings, CameraSettings, TpuSettings  # noqa: E402,F401
