"""A mono loop correction with the scale free: the port's
``LoopCloser._correct_loop`` against the reference's on the CPU, on a
carried mono map.

The reference's mono ``SlamSystem`` maps ``mono_seq`` with the pipelined
driver (``torch_carried_map.carried_mono_map``: 8 keyframes, every
observation without a right coordinate).  Both packages'
``_correct_loop`` (``enable_gba`` on, the scale free) take the same S_CL
between the first and the last keyframe: their relative pose with a Sim3
scale of 0.8.  Held to the reference: the essential graph's poses (1e-4)
and per-keyframe scales (1e-5), the corrected poses (1e-4) and points
(1e-3 m + 1e-3 |X|, the rule of ``test_torch_global_ba.py``), the loop
edge and the GBA's segment decisions; the map's integer and boolean
fields (bindings after the fuse and the GBA's unbinding, validity) equal.
``test_torch_mono_loop_fixture.py`` holds the reference's own mono loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.models import loop_closing as jlc
from orbslam2_tpu.solvers import pose_graph as jpg
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models import loop_closing as tlc
from orbslam2_tpu_torch.models.kf_database import KeyframeDatabase
from orbslam2_tpu_torch.solvers import pose_graph as tpg

from torch_carried_map import carried_mono_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

POSE_TOL = 1e-4       # essential graph and corrected poses, entries of T_cw
SCALE_TOL = 1e-5      # the essential graph's per-keyframe scales
PT_TOL, PT_RTOL = 1e-3, 1e-3   # points, as test_torch_global_ba.py
S_SCALE = 0.8


def _scale(S):
    return float(np.cbrt(np.linalg.det(np.asarray(S, np.float64)[:3, :3])))


def _recording(module, log):
    inner = module.optimize_essential_graph

    def recorded(*a, **kw):
        out = inner(*a, **kw)
        log.append((kw["fix_scale"], np.asarray(out[0]), np.asarray(out[1])))
        return out

    return recorded


@pytest.fixture(scope="module")
def corrected():
    s, ts, m, _ = carried_mono_map()
    ids = np.nonzero(m.kf_valid)[0]
    kf_l, kf_c = int(ids[0]), int(ids[-1])
    assert len(ids) >= 4 and (m.kf_ur[m.kf_valid] < 0).all()
    S = (m.kf_pose_cw[kf_c] @ np.linalg.inv(m.kf_pose_cw[kf_l])).astype(np.float32)
    S[:3, :] *= S_SCALE
    assert abs(_scale(S) - S_SCALE) < 1e-6

    graphs = {"ref": [], "port": []}
    jm = jax.tree.map(jnp.asarray, m)
    # _correct_loop reads neither database.
    ref_lc = jlc.LoopCloser(s, None, fix_scale=False)
    db = KeyframeDatabase(convert.vocabulary_from_numpy(dict(
        node_desc=np.zeros((1, 8), np.uint32), children=np.full((1, 1), -1, np.int32),
        word_id=np.zeros(1, np.int32), idf=np.ones(1, np.float32), levels=1)), 4, device="cpu")
    port_lc = tlc.LoopCloser(ts, db, fix_scale=False, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpg, "optimize_essential_graph", _recording(jpg, graphs["ref"]))
        mp.setattr(tpg, "optimize_essential_graph", _recording(tpg, graphs["port"]))
        want = jax.tree.map(np.asarray, ref_lc._correct_loop(jm, kf_c, kf_l, jnp.asarray(S)))
        got = port_lc._correct_loop(convert.map_state_from_numpy(m, "cpu"), kf_c, kf_l, S)
    return dict(m=m, kf=(kf_l, kf_c), graphs=graphs, ref_lc=ref_lc, port_lc=port_lc,
                want=want, got=got)


def test_the_essential_graph_frees_the_scale(corrected):
    graphs, m = corrected["graphs"], corrected["m"]
    kf_l, kf_c = corrected["kf"]
    # The essential graph ran once in each, with the scale free.
    assert [g[0] for g in graphs["ref"]] == [g[0] for g in graphs["port"]] == [False]
    (_, T_ref, s_ref), (_, T_port, s_port) = graphs["ref"][0], graphs["port"][0]
    kv = m.kf_valid
    np.testing.assert_allclose(T_port[kv], T_ref[kv], atol=POSE_TOL)
    np.testing.assert_allclose(s_port[kv], s_ref[kv], atol=SCALE_TOL)
    # The correction moved the current side and rescaled it.
    assert np.abs(s_ref[kv] - 1.0).max() > 0.05
    assert np.abs(T_ref[kf_c] - m.kf_pose_cw[kf_c]).max() > 1e-3


def test_the_loop_edge_and_the_gba_decisions(corrected):
    port_lc, ref_lc = corrected["port_lc"], corrected["ref_lc"]
    assert [(a, b) for a, b, _ in port_lc.loop_edges] == [(a, b) for a, b, _ in
                                                          ref_lc.loop_edges] == [corrected["kf"]]
    np.testing.assert_array_equal(port_lc.loop_edges[0][2], np.asarray(ref_lc.loop_edges[0][2]))
    assert port_lc.metrics == ref_lc.metrics


def test_corrected_poses_and_points(corrected):
    want, got = corrected["want"], corrected["got"]
    kv = want.kf_valid
    np.testing.assert_allclose(got.kf_pose_cw.numpy()[kv], want.kf_pose_cw[kv], atol=POSE_TOL)
    pv = want.pt_valid
    X = want.pt_pos[pv]
    err = np.abs(got.pt_pos.numpy()[pv] - X).max(-1)
    assert (err <= PT_TOL + PT_RTOL * np.linalg.norm(X, axis=-1)).all(), err.max()


def test_integer_map_fields_equal(corrected):
    want, got = corrected["want"], corrected["got"]
    for name in ("kf_point", "kf_valid", "pt_valid", "pt_ref_kf", "kf_parent", "n_kf", "n_pt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
