"""Run the JAX ``SlamSystem`` and the port's side by side through one of
the tracker's drivers (pipelined, chunked, async mapping) on the CPU, and
hold the port to the reference.

``run_pair`` feeds both systems the same RGB-D frames (or mono images,
with ``depths`` None) and logs, after each call, the tracker's state,
path, relocalization and keyframe counts; ``check_pair`` asserts those
logs, the keyframes' frame ids, the trajectory's frames and lost flags
equal, the poses within POS_TOL_M and ROT_TOL_RAD (or the caller's
``pos_tol``) and |ATE_port - ATE_ref| <= ATE_TOL_M (Sim3-aligned with
``with_scale``, as mono wants).
"""

import jax
import numpy as np

from orbslam2_tpu.models.system import SlamSystem as JSlamSystem
from orbslam2_tpu.ops.bow import train_vocabulary
from orbslam2_tpu.ops.extractor import OrbExtractor
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import SlamSystem

from torch_carried_tracker import JaxSampler

POS_TOL_M = 2e-4
ROT_TOL_RAD = 2e-4
ATE_TOL_M = 1e-3


def rot_angle(R) -> float:
    R = np.asarray(R, np.float64)
    return float(np.arctan2(np.linalg.norm(R - R.T) / np.sqrt(2.0), np.trace(R) - 1.0))


def record(system):
    tr = system.tracker
    m = tr.metrics
    return (int(tr.state), m["track_path"], m["relocalizations"], m["keyframes_created"])


def sequence_vocabulary(settings, images, frames):
    """A vocabulary (k=10, L=4) trained on the descriptors of ``frames``,
    for both packages, as the reference's tests train theirs."""
    ex = OrbExtractor(settings.orb, settings.tpu)
    descs = np.concatenate([np.asarray(f.desc)[np.asarray(f.valid)]
                            for f in (ex(images[i]) for i in frames)])
    vocab = train_vocabulary(descs, k=10, levels=4, seed=0)
    return vocab, convert.vocabulary_from_numpy(jax.tree.map(np.asarray, vocab))


def make_pair(settings, vocab=None, port_vocab=None, sensor="rgbd", **kw):
    """The reference's and the port's system with the same options; the
    port draws the reference's RANSAC samples."""
    ref = JSlamSystem(settings, sensor, vocabulary=vocab, **kw)
    port = SlamSystem(convert.settings_from_reference(settings), sensor, vocabulary=port_vocab,
                      device="cpu", **kw)
    port.tracker._ransac_samples = JaxSampler(ref.tracker.init_key)
    return ref, port


def count_requeues(system):
    """A list that logs, for each chunk the tracker resolves, the number
    of frames its relocalization walk put back into the buffer."""
    tr = system.tracker
    inner = tr._resolve_chunk_inner
    log = []

    def resolve(sensor, fid0, buf, out):
        n0 = len(tr._chunk_buf)
        res = inner(sensor, fid0, buf, out)
        log.append(len(tr._chunk_buf) - n0)
        return res

    tr._resolve_chunk_inner = resolve
    return log


def run_pair(ref, port, images, depths, feed, before=None):
    """Feed frames ``feed`` to both systems (call ``before(j, i)`` ahead of
    call j), then shut both down; returns the per-call logs.  With
    ``depths`` None the frames are mono images."""
    logs = {"ref": [], "port": []}
    for j, i in enumerate(feed):
        if before is not None:
            before(j, i)
        for name, system in (("ref", ref), ("port", port)):
            if depths is None:
                system.track_monocular(images[i], float(j))
            else:
                system.track_rgbd(images[i], depths[i], float(j))
            logs[name].append(record(system))
    ref.shutdown()
    port.shutdown()
    return logs


def kf_frames(system):
    m = system.map
    valid = np.asarray(m.kf_valid)
    return np.asarray(m.kf_frame_id)[valid].tolist()


def trajectory_frames(system):
    return [(int(fid), bool(lost)) for fid, _, _, lost in system.tracker.trajectory]


def check_pair(ref, port, logs, gt, poses=True, pos_tol=POS_TOL_M, rot_tol=ROT_TOL_RAD,
               with_scale=False):
    """The port against the reference after ``run_pair``; ``poses=False``
    leaves the poses to the caller and holds only |dATE|."""
    assert logs["port"] == logs["ref"]
    assert kf_frames(port) == kf_frames(ref)
    assert trajectory_frames(port) == trajectory_frames(ref)
    out, want = port.poses_wc(), ref.poses_wc()
    assert out.shape == want.shape == (len(gt), 4, 4)
    if poses:
        dt = np.abs(out[:, :3, 3] - want[:, :3, 3]).max(axis=1)
        dr = [rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(out, want)]
        assert dt.max() <= pos_tol, dt
        assert max(dr) <= rot_tol, dr
    d_ate = abs(jsyn.ate_rmse(out, gt, with_scale=with_scale)
                - jsyn.ate_rmse(want, gt, with_scale=with_scale))
    assert d_ate <= ATE_TOL_M, d_ate
