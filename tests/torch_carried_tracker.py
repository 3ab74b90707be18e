"""Carry a reference tracker's whole state into the port's tracker, and
replay the reference's RANSAC draws in the port.

``carry_tracker(ref_system, port_system)`` copies the JAX ``SlamSystem``'s
map, keyframe database, loop closer (streaks, edges, last loop keyframe,
metrics) and tracker state (pose, velocity, last frame and bindings,
reference keyframe, mono initialization's reference frame, trajectory,
counters, and the pipelined and chunked
drivers' chained context and keyframe queue) into the port's
``SlamSystem`` on the CPU; the reference must have no frame in flight
(``flush()`` it first).  ``JaxSampler(key)`` stands in for the port tracker's and loop
closer's ``_ransac_samples``: it splits ``key`` once per RANSAC call, as
the reference's ``_relocalize``, ``_mono_initialize`` and ``_sim3_pipeline`` do, and draws with
``jax.random.choice`` and the reference's weights.
``record_sim3_gates(loop_closer, log)`` logs every verified loop
candidate's gate scalars and outcome, in either package.
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
    if ref._pending_chunk is not None or ref._chunk_buf or ref._pending:
        raise ValueError("the reference tracker has frames in flight: flush() it first")
    port.map = convert.map_state_from_numpy(jax.tree.map(np.array, ref.map), device)
    port_system.database = port.database = convert.database_from_numpy(ref.database, device)
    t = functools.partial(convert.tensor_from_numpy, device=device)
    port.state = int(ref.state)
    port.frame_id = ref.frame_id
    port.last_frame = convert.frame_from_numpy(jax.tree.map(np.array, ref.last_frame), device)
    # Mono initialization's reference frame, while the map is not made.
    port.init_ref = (None if ref.init_ref is None else
                     convert.frame_from_numpy(jax.tree.map(np.array, ref.init_ref), device))
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
    # The pipelined and chunked drivers' chained context and queue state.
    if ref._next_ctx is not None:
        port._next_ctx = convert.track_ctx_from_numpy(jax.tree.map(np.asarray, ref._next_ctx),
                                                      device)
    port._kf_queue = [int(k) for k in ref._kf_queue]
    port._kf_deferred = bool(ref._kf_deferred)
    if ref._host_kf_valid is not None:
        port._host_kf_valid = np.asarray(ref._host_kf_valid, bool)
        port._host_n_kf = int(ref._host_n_kf)
    port._fused_sensor = getattr(ref, "_fused_sensor", None)
    for k in ("frames", "frames_lost", "relocalizations", "keyframes_created",
              "last_inliers", "track_path"):
        port.metrics[k] = ref.metrics[k]
    port_system.timestamps = list(ref_system.timestamps)
    port._ransac_samples = JaxSampler(ref.init_key)
    if ref_system.loop_closer is not None:
        lc = convert.loop_closer_from_numpy(ref_system.loop_closer, port_system.settings,
                                            port.database, device)
        lc._ransac_samples = JaxSampler(jnp.asarray(lc.reference_key))
        port_system.loop_closer = port.loop_closer = lc
    return port_system


def record_sim3_gates(loop_closer, log):
    """Wrap ``loop_closer._apply_sim3_gates`` to append each verified
    candidate's keyframes, gate scalars, pass and outcome to ``log``."""
    inner = loop_closer._apply_sim3_gates

    def gates(m, kf_c, kf_l, res, **kw):
        out = inner(m, kf_c, kf_l, res, **kw)
        n_matches, n_distinct, _, _, ransac_ok, n_inliers, n_proj = res[:7]
        log.append({"kf_c": int(kf_c), "kf_l": int(kf_l), "n_matches": int(n_matches),
                    "n_distinct": int(n_distinct), "ransac_ok": bool(ransac_ok),
                    "n_inliers": int(n_inliers), "n_proj": int(n_proj),
                    "retry": bool(kw), "accepted": out is not None,
                    "S_CL": None if out is None else np.asarray(out).tolist()})
        return out

    loop_closer._apply_sim3_gates = gates
