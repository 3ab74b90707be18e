"""Carry a reference tracker's whole state into the port's tracker, and
replay the reference's RANSAC draws in the port.

``carry_tracker(ref_system, port_system)`` copies the JAX ``SlamSystem``'s
map, keyframe database and tracker state (pose, velocity, last frame and
bindings, reference keyframe, trajectory, counters) into the port's
``SlamSystem`` on the CPU.  ``JaxSampler(key)`` stands in for the port
tracker's ``_ransac_samples``: it splits ``key`` once per RANSAC call, as
the reference's ``_relocalize`` does, and draws with
``jax.random.choice`` and the reference's weights.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu_torch import convert


@functools.partial(jax.jit, static_argnames=("iters", "k"))
def _choice(key, valid, iters, k):
    w = valid.astype(jnp.float32)
    p = w / jnp.maximum(w.sum(), 1.0)
    return jax.random.choice(key, valid.shape[0], shape=(iters, k), replace=True, p=p)


class JaxSampler:
    """The reference's RANSAC samples, key split by key split."""

    def __init__(self, key):
        self.key = key
        self.calls = 0

    def __call__(self, valid: torch.Tensor, iters: int, k: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        out = _choice(sub, jnp.asarray(valid.cpu().numpy()), iters, k)
        return torch.from_numpy(np.array(out, np.int64)).to(valid.device)


def carry_tracker(ref_system, port_system, device="cpu"):
    ref, port = ref_system.tracker, port_system.tracker
    port.map = convert.map_state_from_numpy(jax.tree.map(np.array, ref.map), device)
    port_system.database = port.database = convert.database_from_numpy(ref.database, device)
    t = functools.partial(convert.tensor_from_numpy, device=device)
    port.state = int(ref.state)
    port.frame_id = ref.frame_id
    port.last_frame = convert.frame_from_numpy(jax.tree.map(np.array, ref.last_frame), device)
    port.last_T = t(np.asarray(ref.last_T, np.float32))
    port.last_bindings = t(ref.last_bindings)
    port.velocity = None if ref.velocity is None else t(np.asarray(ref.velocity, np.float32))
    port.ref_kf = int(ref.ref_kf)
    port.last_kf_frame_id = int(ref.last_kf_frame_id)
    port._no_kf_before = int(ref._no_kf_before)
    port.localization_only = ref.localization_only
    port.trajectory = [(fid, np.asarray(T_cr), int(r), bool(lost))
                       for fid, T_cr, r, lost in ref.trajectory]
    port.n_tracked_history = [int(n) for n in ref.n_tracked_history]
    for k in ("frames", "frames_lost", "relocalizations", "keyframes_created",
              "last_inliers", "track_path"):
        port.metrics[k] = ref.metrics[k]
    port_system.timestamps = list(ref_system.timestamps)
    port._ransac_samples = JaxSampler(ref.init_key)
    return port_system
