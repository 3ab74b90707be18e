"""The async mapping pipeline against the reference's on the CPU.

* ``merge_tracking_stats`` and ``adopt_mapped_state`` on constructed maps
  (8 keyframes x 16 features, 64 points): no job keyframe, a job keyframe
  moved by 0.1 rad and 5 cm, a culled-and-reused point slot, a tracker /
  worker slot collision, the binding scrub.  Integer and boolean fields
  equal; float fields within 1e-6.
* The schedule made deterministic: in both packages ``poll`` (and
  ``wait``) join the worker without setting ``abort_gba``, so each job is
  adopted at the first frame boundary after it was submitted.  RGB-D,
  24 frames of ``make_sequence(seed=3)``, ``small_settings(bf=160)``,
  mapping on, loop closing off.  Per call, state, path and keyframe
  counts equal; the frames of each adoption, the job keyframes and
  ``jobs_run`` equal; keyframe frame ids and the trajectory's lost flags
  equal; poses within 2e-4 m and rad; |dATE| <= 1e-3 m.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.models import async_pipeline as jap
from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.utils import synthetic as jsyn
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import async_pipeline as tap

from test_slam_e2e import small_settings
from torch_drivers import check_pair, make_pair, run_pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FLOAT_TOL = 1e-6
K, N, P = 8, 16, 64


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    A = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * A + (1 - np.cos(angle)) * A @ A


def _pose(rng):
    T = np.eye(4)
    T[:3, :3] = _rot(rng.normal(size=3), rng.uniform(0.1, 1.0))
    T[:3, 3] = rng.normal(size=3)
    return T


def _maps(case):
    """(mapped, snapshot, tracked, job_kf) as dicts of numpy arrays."""
    rng = np.random.default_rng(["none", "moved", "reused", "collision", "scrub"].index(case))
    snap = {k: np.array(v) for k, v in jms.make_empty_map(K, P, N)._asdict().items()}
    n_kf, n_pt = 3, 24
    for k in range(n_kf):
        snap["kf_pose_cw"][k] = _pose(rng)
    snap["kf_xy"][:n_kf] = rng.uniform(0, 300, (n_kf, N, 2))
    snap["kf_level"][:n_kf] = rng.integers(0, 4, (n_kf, N))
    snap["kf_angle"][:n_kf] = rng.uniform(-3, 3, (n_kf, N))
    snap["kf_desc"][:n_kf] = rng.integers(0, 2**32, (n_kf, N, 8), dtype=np.uint32)
    snap["kf_ur"][:n_kf] = rng.uniform(0, 300, (n_kf, N))
    snap["kf_kp_valid"][:n_kf] = True
    snap["kf_point"][:n_kf] = rng.integers(-1, n_pt, (n_kf, N))
    snap["kf_valid"][:n_kf] = True
    snap["kf_frame_id"][:n_kf] = [0, 3, 6]
    snap["kf_parent"][:n_kf] = [-1, 0, 1]
    snap["pt_pos"][:n_pt] = rng.normal(size=(n_pt, 3))
    nrm = rng.normal(size=(n_pt, 3))
    snap["pt_normal"][:n_pt] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    snap["pt_desc"][:n_pt] = rng.integers(0, 2**32, (n_pt, 8), dtype=np.uint32)
    snap["pt_min_dist"][:n_pt] = rng.uniform(0.1, 1, n_pt)
    snap["pt_max_dist"][:n_pt] = rng.uniform(2, 5, n_pt)
    snap["pt_ref_kf"][:n_pt] = rng.integers(0, n_kf, n_pt)
    snap["pt_first_kf"][:n_pt] = rng.integers(0, n_kf, n_pt)
    snap["pt_valid"][:n_pt] = True
    snap["pt_visible"][:n_pt] = rng.integers(1, 20, n_pt)
    snap["pt_found"][:n_pt] = rng.integers(1, 10, n_pt)
    snap["n_kf"], snap["n_pt"] = np.int32(n_kf), np.int32(n_pt)

    # Tracking since the snapshot: statistics, keyframe row 3 with its
    # close-depth points at the high end of the pool (slots 60-63).
    trk = {k: v.copy() for k, v in snap.items()}
    trk["pt_visible"][:n_pt] += rng.integers(0, 5, n_pt)
    trk["pt_found"][:n_pt] += rng.integers(0, 3, n_pt)
    for name in ("kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_ur", "kf_kp_valid"):
        trk[name][3] = snap[name][0]
    trk["kf_pose_cw"][3] = _pose(rng)
    row = rng.integers(-1, n_pt, N)
    row[:4] = [60, 61, 62, 63]
    row[4] = 7  # a point the worker culls in the "scrub" case
    trk["kf_point"][3] = row
    trk["kf_valid"][3], trk["kf_frame_id"][3], trk["kf_parent"][3] = True, 9, 2
    new = slice(60, 64)
    trk["pt_pos"][new] = rng.normal(size=(4, 3))
    trk["pt_normal"][new] = [[0, 0, 1]] * 4
    trk["pt_desc"][new] = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
    trk["pt_min_dist"][new], trk["pt_max_dist"][new] = 0.5, 3.0
    trk["pt_ref_kf"][new] = trk["pt_first_kf"][new] = 3
    trk["pt_valid"][new] = True
    trk["pt_visible"][new] = trk["pt_found"][new] = 1
    trk["n_kf"], trk["n_pt"] = np.int32(4), np.int32(n_pt + 4)

    # The worker: BA moved poses and points, triangulated points at the low
    # free slots (24-27) and its own statistics.
    mapped = {k: v.copy() for k, v in snap.items()}
    mapped["kf_pose_cw"][1, :3, 3] += 1e-3
    mapped["pt_pos"][:n_pt] += rng.normal(scale=1e-2, size=(n_pt, 3))
    mapped["pt_visible"][:n_pt] += 1
    tri = slice(24, 28)
    mapped["pt_pos"][tri] = rng.normal(size=(4, 3))
    mapped["pt_first_kf"][tri] = mapped["pt_ref_kf"][tri] = 2
    mapped["pt_valid"][tri] = True
    mapped["pt_visible"][tri] = mapped["pt_found"][tri] = 2
    mapped["n_pt"] = np.int32(n_pt + 4)
    job_kf = 2
    if case == "none":
        job_kf = None
    if case == "moved":
        D = np.eye(4)
        D[:3, :3] = _rot([0.3, -1.0, 0.2], 0.1)
        D[:3, 3] = [0.05, 0.0, 0.0]
        mapped["kf_pose_cw"][2] = snap["kf_pose_cw"][2] @ D
    if case == "reused":
        # Point 5 culled and its slot reused by a worker point.
        mapped["pt_first_kf"][5] = 2
        mapped["pt_visible"][5] = mapped["pt_found"][5] = 1
    if case == "collision":
        # The worker's triangulation took slot 62 too.
        mapped["pt_valid"][62] = True
        mapped["pt_first_kf"][62] = 2
        mapped["pt_pos"][62] = [9.0, 9.0, 9.0]
    if case == "scrub":
        mapped["pt_valid"][7] = False
    for d in (snap, trk, mapped):
        d["kf_pose_cw"] = d["kf_pose_cw"].astype(np.float32)
    return mapped, snap, trk, job_kf


def _compare(got, want):
    for name in jms.MapState._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=FLOAT_TOL, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", ["none", "moved", "reused", "collision", "scrub"])
def test_merge_and_adopt(case):
    mapped, snap, trk, job_kf = _maps(case)
    j = [jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()}) for d in (mapped, snap, trk)]
    t = [convert.map_state_from_numpy(d, "cpu") for d in (mapped, snap, trk)]
    _compare(tap.merge_tracking_stats(*t), jap.merge_tracking_stats(*j))
    want = jap.adopt_mapped_state(*j, None if job_kf is None else jnp.int32(job_kf))
    got = tap.adopt_mapped_state(*t, job_kf)
    _compare(got, want)
    if case == "reused":
        assert int(got.pt_visible[5]) == 1  # no foreign delta
    if case == "collision":
        assert got.pt_pos[62].tolist() == [9.0, 9.0, 9.0]
        assert int(got.kf_point[3, 2]) == -1  # the tracker's binding dropped
    if case == "scrub":
        assert int(got.kf_point[3, 4]) == -1
    if case == "moved":
        assert not np.allclose(got.kf_pose_cw[3].numpy(), trk["kf_pose_cw"][3], atol=1e-3)


def _joined(pipeline, finish):
    """Replace ``poll`` and ``wait`` by a join of the worker that leaves
    ``abort_gba`` alone."""

    def join(self, *args, **kwargs):
        if self._thread is None:
            return None
        self._thread.join()
        return finish(self)

    pipeline.poll = types.MethodType(join, pipeline)
    pipeline.wait = types.MethodType(join, pipeline)


def _log_adoptions(system, log):
    tr = system.tracker
    inner = tr._adopt

    def adopt(result):
        if result is not None:
            log.append((tr.frame_id, int(result[2])))
        return inner(result)

    tr._adopt = adopt


@pytest.fixture(scope="module")
def schedule():
    s = small_settings(bf=160.0)
    seq = jsyn.make_sequence(s.camera_model(), n_frames=24, with_depth=True, seed=3)
    ref, port = make_pair(s, enable_loop_closing=False, async_mapping=True)
    _joined(ref.mapping_pipeline, jap.AsyncMappingPipeline._finish)
    _joined(port.mapping_pipeline, tap.AsyncMappingPipeline._finish)
    adoptions = {"ref": [], "port": []}
    _log_adoptions(ref, adoptions["ref"])
    _log_adoptions(port, adoptions["port"])
    logs = run_pair(ref, port, seq.images, seq.depths, range(24))
    return dict(seq=seq, ref=ref, port=port, logs=logs, adoptions=adoptions)


def test_deterministic_schedule_matches_the_reference(schedule):
    ref, port = schedule["ref"], schedule["port"]
    check_pair(ref, port, schedule["logs"], schedule["seq"].poses_wc)
    assert schedule["adoptions"]["port"] == schedule["adoptions"]["ref"]
    assert port.mapping_pipeline.jobs_run == ref.mapping_pipeline.jobs_run >= 2
    assert len(schedule["adoptions"]["ref"]) == ref.mapping_pipeline.jobs_run
    assert not port.tracker._kf_queue and port.mapping_pipeline.accept_keyframes()
