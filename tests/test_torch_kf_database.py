"""Keyframe database: ``orbslam2_tpu_torch.models.kf_database`` against
``orbslam2_tpu.models.kf_database`` on the CPU, dense and sparse.

Two maps: one the reference tracker built from a synthetic RGB-D sequence
(``tests/torch_carried_map.py``), and a hand-made one whose covisibility
chains exercise the group accumulation (``TestGroupedCandidateScoring`` of
``tests/test_loop_components.py``).  The reference's database state is
carried across with ``convert.database_from_numpy``; the port's own
insertions are checked against it too.

Tolerances: candidate ids, covisibility groups, words, feature node ids and
entry flags exact; BoW weights within 1e-6; accumulated scores within 1e-5
(float sums in another order).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbslam2_tpu.models.kf_database as jkdb
import orbslam2_tpu_torch.models.kf_database as tkdb
from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.ops import bow as jbow
from orbslam2_tpu_torch import convert

from torch_carried_map import carried_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W_TOL = 1e-6
ACC_TOL = 1e-5


def rand_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


@contextlib.contextmanager
def forced_sparse(on):
    """Both packages' dense/sparse switch forced to sparse (as
    TestSparseDatabase does to the reference)."""
    old = jkdb._DENSE_MAX_WORDS, tkdb._DENSE_MAX_WORDS
    if on:
        jkdb._DENSE_MAX_WORDS = tkdb._DENSE_MAX_WORDS = 1
    try:
        yield
    finally:
        jkdb._DENSE_MAX_WORDS, tkdb._DENSE_MAX_WORDS = old


def _np_map(m):
    return jax.tree.map(np.array, m)


def _build(vocab, m_np, kfs, sparse, feat_capacity):
    """Reference and port databases filled by their own add_keyframe with
    the keyframes ``kfs`` of the numpy map ``m_np``."""
    with forced_sparse(sparse):
        ref = jkdb.KeyframeDatabase(vocab, m_np.kf_valid.shape[0], feat_capacity=feat_capacity)
        port = tkdb.KeyframeDatabase(convert.vocabulary_from_numpy(vocab), m_np.kf_valid.shape[0],
                                     feat_capacity=feat_capacity, device="cpu")
    assert ref.sparse == port.sparse == sparse
    for k in kfs:
        ref.add_keyframe(k, jnp.asarray(m_np.kf_desc[k]), jnp.asarray(m_np.kf_kp_valid[k]))
        port.add_keyframe(k, convert.tensor_from_numpy(m_np.kf_desc[k], "cpu"),
                          convert.tensor_from_numpy(m_np.kf_kp_valid[k], "cpu"))
    return ref, port


def _carried(ref, sparse):
    with forced_sparse(sparse):
        return convert.database_from_numpy(ref, "cpu")


def assert_same_state(port, ref):
    np.testing.assert_array_equal(port.has_entry.numpy(), np.asarray(ref.has_entry))
    np.testing.assert_array_equal(port.db_nodes.numpy(), np.asarray(ref.db_nodes))
    if ref.sparse:
        np.testing.assert_array_equal(port.db_words.numpy(), np.asarray(ref.db_words))
        np.testing.assert_allclose(port.db_weights.numpy(), np.asarray(ref.db_weights), atol=W_TOL)
    else:
        np.testing.assert_allclose(port.bow.numpy(), np.asarray(ref.bow), atol=W_TOL)


def assert_same_loop(out, ref):
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_allclose(out[1], ref[1], atol=ACC_TOL)
    assert out[2] == ref[2]


@pytest.fixture(scope="module")
def tracked():
    """The reference tracker's map of 14 frames and a vocabulary trained on
    its keyframes' descriptors."""
    _, _, m_np, _ = carried_map(n_frames=14)
    n_kf = int(m_np.n_kf)
    descs = np.concatenate([m_np.kf_desc[k][m_np.kf_kp_valid[k]] for k in range(n_kf)])
    vocab = jbow.train_vocabulary(descs, k=10, levels=3, seed=0)
    return m_np, vocab, list(range(n_kf))


@pytest.fixture(scope="module")
def grouped():
    """TestGroupedCandidateScoring's map: a query appearance, a true
    revisit (KF2) with corroborating neighbours (1-2-3), and an alias (KF7)
    whose neighbours (6-7-8) look like nothing."""
    rng = np.random.default_rng(17)
    K, N, P = 16, 64, 1024
    m = jms.make_empty_map(K, P, N)
    q_desc = rand_desc(rng, N)
    near = q_desc.copy()
    near[: N // 8] = rand_desc(rng, N // 8)
    other = rand_desc(rng, N)
    descs = {2: q_desc.copy(), 1: near.copy(), 3: near.copy(), 7: q_desc.copy()}
    kf_desc = np.zeros((K, N, 8), np.uint32)
    for k in range(12):
        kf_desc[k] = descs.get(k, other.copy() if k in (6, 8) else rand_desc(rng, N))
    kf_point = np.full((K, N), -1, np.int32)
    for a, b, base in ((1, 2, 0), (2, 3, 40), (6, 7, 200), (7, 8, 240)):
        ids = np.arange(base, base + 30)
        kf_point[a, 0:30] = ids
        kf_point[b, 30:60] = ids
    pt_valid = np.zeros(P, bool)
    pt_valid[np.unique(kf_point[kf_point >= 0])] = True
    m = m._replace(
        kf_desc=jnp.asarray(kf_desc), kf_kp_valid=jnp.ones((K, N), bool).at[12:].set(False),
        kf_valid=jnp.arange(K) < 12, kf_point=jnp.asarray(kf_point),
        pt_valid=jnp.asarray(pt_valid), n_kf=jnp.int32(12),
    )
    from orbslam2_tpu.models.system import _default_vocabulary

    return _np_map(m), _default_vocabulary(), list(range(12)), q_desc


def _queries(m_np, kfs, seed):
    """Each keyframe's own descriptors and a perturbed copy of one."""
    rng = np.random.default_rng(seed)
    qs = [(m_np.kf_desc[k], m_np.kf_kp_valid[k]) for k in kfs]
    d = m_np.kf_desc[kfs[len(kfs) // 2]].copy()
    flip = rng.uniform(size=d.shape) < 0.3
    d[flip] ^= rand_desc(rng, int(flip.sum()) // 8 + 1).reshape(-1)[: int(flip.sum())]
    qs.append((d, m_np.kf_kp_valid[kfs[len(kfs) // 2]]))
    return qs


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("which", ["tracked", "grouped"])
def test_insertion_and_relocalization_candidates(request, which, sparse):
    m_np, vocab, kfs = request.getfixturevalue(which)[:3]
    ref, port = _build(vocab, m_np, kfs, sparse, feat_capacity=m_np.kf_desc.shape[1])
    assert_same_state(port, ref)
    carried = _carried(ref, sparse)
    m_t = convert.map_state_from_numpy(m_np, "cpu")
    n_found = 0
    for d, v in _queries(m_np, kfs, seed=len(kfs)):
        want = ref.detect_relocalization_candidates(m_np, jnp.asarray(d), jnp.asarray(v))
        td, tv = convert.tensor_from_numpy(d, "cpu"), convert.tensor_from_numpy(v, "cpu")
        for db in (port, carried):
            np.testing.assert_array_equal(db.detect_relocalization_candidates(m_t, td, tv), want)
        np.testing.assert_array_equal(port.frame_nodes(td, tv).numpy(),
                                      np.asarray(ref.frame_nodes(jnp.asarray(d), jnp.asarray(v))))
        n_found += len(want)
    assert n_found > len(kfs)
    for k in kfs:
        np.testing.assert_array_equal(port.nodes_for(k).numpy(), np.asarray(ref.nodes_for(k)))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("which", ["tracked", "grouped"])
def test_loop_candidates(request, which, sparse):
    m_np, vocab, kfs = request.getfixturevalue(which)[:3]
    ref, _ = _build(vocab, m_np, kfs, sparse, feat_capacity=m_np.kf_desc.shape[1])
    port = _carried(ref, sparse)
    m_t = convert.map_state_from_numpy(m_np, "cpu")
    extra = m_np.kf_valid.astype(np.int32)
    for k in kfs:
        want = ref.detect_loop_candidates(m_np, k, extras=jnp.asarray(extra))
        got = port.detect_loop_candidates(m_t, k, extras=[torch.from_numpy(extra)])
        assert_same_loop(got, want)
        np.testing.assert_array_equal(got[3][0], np.asarray(want[3]))
    assert port.host_syncs == len(kfs)  # one device read per query


@pytest.mark.parametrize("sparse", [False, True])
def test_remap(grouped, sparse):
    m_np, vocab, kfs, q = grouped
    ref, port = _build(vocab, m_np, kfs, sparse, feat_capacity=64)
    # A compaction that drops keyframes 0, 5 and 9: the others slide down.
    kf_map = np.full(m_np.kf_valid.shape[0], -1, np.int64)
    kept = [k for k in kfs if k not in (0, 5, 9)]
    kf_map[kept] = np.arange(len(kept))
    ref.remap(kf_map)
    port.remap(kf_map)
    assert_same_state(port, ref)
    # Queries on the compacted map agree.
    m2 = jax.tree.map(np.array, jms.compact_map(jax.tree.map(jnp.asarray, m_np))[0])
    want = ref.detect_relocalization_candidates(m2, jnp.asarray(q), jnp.ones(64, bool))
    got = port.detect_relocalization_candidates(convert.map_state_from_numpy(m2, "cpu"),
                                                convert.tensor_from_numpy(q, "cpu"),
                                                torch.ones(64, dtype=torch.bool))
    np.testing.assert_array_equal(got, want)
    assert len(want) >= 1


def test_fetch_reads_mixed_dtypes_at_once():
    ts = [torch.tensor([1.5, -2.0]), torch.tensor([[3, 4]], dtype=torch.int64),
          torch.tensor([True, False, True]), torch.tensor(7, dtype=torch.int32)]
    out = tkdb.fetch(ts)
    for a, t in zip(out, ts):
        np.testing.assert_array_equal(a, t.numpy())
        assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape)


def test_covisible_rows_are_the_reference_rows(tracked):
    from orbslam2_tpu_torch.models import map_state as tms

    m_np, _, kfs = tracked
    m_t = convert.map_state_from_numpy(m_np, "cpu")
    ids = kfs + [0, 15]
    rows = tms.covisible_rows(m_t, torch.tensor(ids))
    jm = jax.tree.map(jnp.asarray, m_np)
    for i, k in enumerate(ids):
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(jms.covisible_row(jm, jnp.int32(k))))
    assert int(rows.sum()) > 0


# -- TestGroupedCandidateScoring / TestSparseDatabase on the port ------------


class TestGroupedCandidateScoring:
    def test_aliased_candidate_rejected_by_group_accumulation(self, grouped):
        m_np, vocab, kfs, q_desc = grouped
        _, db = _build(vocab, m_np, kfs, False, feat_capacity=64)
        m = convert.map_state_from_numpy(m_np, "cpu")
        q = convert.tensor_from_numpy(q_desc, "cpu")
        ones = torch.ones(64, dtype=torch.bool)
        scores = db._scores(q, ones).numpy()
        assert scores[7] >= 0.95 * scores[2], (scores[2], scores[7])
        ids = db.detect_relocalization_candidates(m, q, ones, n_candidates=2)
        assert len(ids) >= 1
        assert ids[0] == 2, f"true revisit must rank first, got {ids}"
        assert 7 not in ids.tolist(), f"aliased KF admitted: {ids}"


class TestSparseDatabase:
    def test_sparse_database_matches_dense(self, rng):
        from orbslam2_tpu_torch.models import map_state as tms
        from orbslam2_tpu_torch.ops import bow as tbow

        vocab = tbow.train_vocabulary(rand_desc(rng, 4000), k=10, levels=3, seed=0)
        m = tms.make_empty_map(8, 64, 32, device="cpu")
        m = m._replace(kf_valid=torch.ones(8, dtype=torch.bool),
                       n_kf=torch.tensor(8, dtype=torch.int32))
        dbs = []
        for force_sparse in (False, True):
            with forced_sparse(force_sparse):
                db = tkdb.KeyframeDatabase(vocab, 8, feat_capacity=128, device="cpu")
            assert db.sparse == force_sparse
            for k in range(6):
                d = rand_desc(np.random.default_rng(1000 + k), 100)
                db.add_keyframe(k, convert.tensor_from_numpy(d, "cpu"),
                                torch.ones(100, dtype=torch.bool))
            dbs.append(db)
        q = convert.tensor_from_numpy(rand_desc(np.random.default_rng(99), 100), "cpu")
        ones = torch.ones(100, dtype=torch.bool)
        np.testing.assert_allclose(dbs[1]._scores(q, ones)[:6].numpy(),
                                   dbs[0]._scores(q, ones)[:6].numpy(), atol=1e-5)
        np.testing.assert_array_equal(dbs[0].detect_relocalization_candidates(m, q, ones),
                                      dbs[1].detect_relocalization_candidates(m, q, ones))
