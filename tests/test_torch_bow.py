"""Bag-of-words place recognition: ``orbslam2_tpu_torch.ops.bow`` against
``orbslam2_tpu.ops.bow`` on the same seeded descriptors, on the CPU.

Tolerances: vocabularies (trained or built in), words and feature node ids
exact; dense and sparse BoW weights and L1 scores within 1e-6 (each word's
equal terms are counted and multiplied where the reference adds them one by
one).  The rest mirrors ``TestBow`` and ``TestSparseBow`` of
``tests/test_loop_components.py`` on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models.system import _default_vocabulary as ref_default_vocabulary
from orbslam2_tpu.ops import bow as jbow
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.system import _default_vocabulary
from orbslam2_tpu_torch.ops import bow as tbow
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-6


def rand_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def perturb_desc(rng, d, n_bits):
    """Flip n_bits random bits of each descriptor."""
    out = d.copy()
    bits = rng.integers(0, 256, size=(len(d), n_bits))
    for i in range(len(d)):
        for b in bits[i]:
            out[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _t(a):
    return convert.tensor_from_numpy(a, "cpu")


def assert_same_vocabulary(port, ref):
    np.testing.assert_array_equal(port.node_desc.numpy(), np.asarray(ref.node_desc).view(np.int32))
    for name in ("children", "word_id", "idf"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    assert port.levels == ref.levels and port.n_words == ref.n_words


@pytest.fixture(scope="module")
def vocabs():
    rng = np.random.default_rng(7)
    train = rand_desc(rng, 4000)
    ref = jbow.train_vocabulary(train, k=10, levels=3, seed=0)
    return ref, tbow.train_vocabulary(train, k=10, levels=3, seed=0)


@pytest.mark.parametrize("k, levels, seed", [(5, 2, 1), (10, 3, 0), (4, 4, 3)])
def test_train_vocabulary_gives_the_reference_arrays(k, levels, seed):
    descs = rand_desc(np.random.default_rng(seed), 1500)
    assert_same_vocabulary(tbow.train_vocabulary(descs, k=k, levels=levels, seed=seed),
                           jbow.train_vocabulary(descs, k=k, levels=levels, seed=seed))


def test_default_vocabulary_is_the_reference_one():
    port = _default_vocabulary()
    assert_same_vocabulary(port, ref_default_vocabulary())
    assert port.n_words == 1000 and port.node_desc.device.type == "cpu"


def test_vocabulary_from_numpy_carries_the_arrays(vocabs):
    ref, _ = vocabs
    assert_same_vocabulary(convert.vocabulary_from_numpy(ref), ref)


@pytest.mark.parametrize("n_valid", [300, 170, 0])
def test_words_nodes_and_rows_agree(vocabs, n_valid):
    ref, port = vocabs
    rng = np.random.default_rng(n_valid)
    d = rand_desc(rng, 300)
    valid = np.arange(300) < n_valid
    row_r, words_r, nodes_r = jbow.BowTransformer(ref)(jnp.asarray(d), jnp.asarray(valid))
    row_p, words_p, nodes_p = tbow.BowTransformer(port)(_t(d), _t(valid))
    np.testing.assert_array_equal(words_p.numpy(), np.asarray(words_r))
    np.testing.assert_array_equal(nodes_p.numpy(), np.asarray(nodes_r))
    np.testing.assert_allclose(row_p.numpy(), np.asarray(row_r), atol=TOL)
    sw_r, swt_r = jbow.sparse_bow(words_r, ref.idf, ref.n_words)
    sw_p, swt_p = tbow.sparse_bow(words_p, port.idf, port.n_words)
    np.testing.assert_array_equal(sw_p.numpy(), np.asarray(sw_r))
    np.testing.assert_allclose(swt_p.numpy(), np.asarray(swt_r), atol=TOL)


def test_descent_ties_take_the_first_child():
    # Few items per node: train_vocabulary fills the empty branches with
    # copies of their parent's centre, so children tie at equal distance
    # and the descent must take the first, as jnp.argmin does.
    rng = np.random.default_rng(5)
    train = rand_desc(rng, 40)
    ref = jbow.train_vocabulary(train, k=10, levels=3, seed=0)
    port = tbow.train_vocabulary(train, k=10, levels=3, seed=0)
    children = np.asarray(ref.children)
    desc = np.asarray(ref.node_desc)
    dup = [(desc[children[n]][:, None] == desc[children[n]][None]).all(-1).sum()
           for n in range(len(children)) if children[n, 0] >= 0]
    assert max(dup) > 10  # the tree has tied children
    d = np.concatenate([train, rand_desc(rng, 60)])
    w_r, n_r = jbow._descend(jnp.asarray(d), ref.node_desc, ref.children, ref.word_id, 3)
    w_p, n_p = tbow._descend(_t(d), port.node_desc, port.children, port.word_id, 3)
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_r))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))


def test_weighted_idf_rows_and_scores(vocabs):
    # ORBvoc-style idf weights (not all 1): each word's terms are counted
    # and multiplied in the port.
    ref, port = vocabs
    idf = np.random.default_rng(3).uniform(0.1, 3.0, ref.n_words).astype(np.float32)
    ref, port = ref._replace(idf=jnp.asarray(idf)), port._replace(idf=torch.from_numpy(idf))
    rng = np.random.default_rng(4)
    q, d = rand_desc(rng, 400), rand_desc(rng, 400)
    q[200:] = q[:200]  # repeated words
    valid = np.ones(400, bool)
    rows_r = [jbow.BowTransformer(ref)(jnp.asarray(x), jnp.asarray(valid)) for x in (q, d)]
    rows_p = [tbow.BowTransformer(port)(_t(x), _t(valid)) for x in (q, d)]
    for (br, wr, _), (bp, wp, _) in zip(rows_r, rows_p):
        np.testing.assert_allclose(bp.numpy(), np.asarray(br), atol=TOL)
    db_r = jnp.stack([rows_r[1][0], rows_r[0][0]])
    db_p = torch.stack([rows_p[1][0], rows_p[0][0]])
    np.testing.assert_allclose(tbow.l1_scores(rows_p[0][0], db_p).numpy(),
                               np.asarray(jbow.l1_scores(rows_r[0][0], db_r)), atol=TOL)
    sp_r = [jbow.sparse_bow(w, ref.idf, ref.n_words) for _, w, _ in rows_r]
    sp_p = [tbow.sparse_bow(w, port.idf, port.n_words) for _, w, _ in rows_p]
    s_r = jbow.l1_scores_sparse(*sp_r[0], jnp.stack([sp_r[1][0], sp_r[0][0]]),
                                jnp.stack([sp_r[1][1], sp_r[0][1]]), ref.n_words)
    s_p = tbow.l1_scores_sparse(*sp_p[0], torch.stack([sp_p[1][0], sp_p[0][0]]),
                                torch.stack([sp_p[1][1], sp_p[0][1]]), port.n_words)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), atol=TOL)
    np.testing.assert_allclose(s_p[1].item(), 1.0, atol=1e-5)


def test_popcount32_counts_the_uint32_bits():
    from orbslam2_tpu_torch.ops.hamming import popcount32

    a = rand_desc(np.random.default_rng(0), 500).reshape(-1)
    want = np.unpackbits(a.view(np.uint8)).reshape(-1, 32).sum(1)
    np.testing.assert_array_equal(popcount32(_t(a)).numpy(), want)


# -- TestBow / TestSparseBow of tests/test_loop_components.py on the port ----


class TestBow:
    def test_vocab_shapes_and_determinism(self, rng):
        descs = rand_desc(rng, 2000)
        v1 = tbow.train_vocabulary(descs, k=5, levels=2, seed=1)
        v2 = tbow.train_vocabulary(descs, k=5, levels=2, seed=1)
        assert v1.n_words == 25
        assert torch.equal(v1.node_desc, v2.node_desc)

    def test_similar_frames_score_high(self, rng):
        vocab = tbow.train_vocabulary(rand_desc(rng, 4000), k=10, levels=3, seed=0)
        tf = tbow.BowTransformer(vocab)
        base = rand_desc(rng, 300)
        near = perturb_desc(rng, base, 12)
        far = rand_desc(rng, 300)
        valid = torch.ones(300, dtype=torch.bool)
        b0, _, _ = tf(_t(base), valid)
        b1, _, _ = tf(_t(near), valid)
        b2, _, _ = tf(_t(far), valid)
        scores = tbow.l1_scores(b0, torch.stack([b1, b2])).numpy()
        assert scores[0] > scores[1] + 0.1, scores
        assert np.all(scores <= 1.0 + 1e-5) and np.all(scores >= -1e-5)

    def test_words_stable_under_noise(self, rng):
        vocab = tbow.train_vocabulary(rand_desc(rng, 4000), k=10, levels=3, seed=0)
        tf = tbow.BowTransformer(vocab)
        base = rand_desc(rng, 200)
        near = perturb_desc(rng, base, 6)
        valid = torch.ones(200, dtype=torch.bool)
        _, w0, _ = tf(_t(base), valid)
        _, w1, _ = tf(_t(near), valid)
        assert (w0 == w1).float().mean().item() > 0.35


class TestSparseBow:
    def test_sparse_matches_dense(self, rng):
        vocab = tbow.train_vocabulary(rand_desc(rng, 4000), k=10, levels=3, seed=0)
        tf = tbow.BowTransformer(vocab)
        valid = torch.ones(300, dtype=torch.bool)
        b1, w1, _ = tf(_t(rand_desc(rng, 300)), valid)
        b2, w2, _ = tf(_t(rand_desc(rng, 300)), valid)
        sw1, swt1 = tbow.sparse_bow(w1, vocab.idf, vocab.n_words)
        sw2, swt2 = tbow.sparse_bow(w2, vocab.idf, vocab.n_words)
        dense = tbow.l1_scores(b1, b2[None])[0].item()
        sparse = tbow.l1_scores_sparse(sw1, swt1, sw2[None], swt2[None], vocab.n_words)[0].item()
        np.testing.assert_allclose(sparse, dense, atol=1e-5)
        self_s = tbow.l1_scores_sparse(sw1, swt1, sw1[None], swt1[None], vocab.n_words)[0].item()
        np.testing.assert_allclose(self_s, 1.0, atol=1e-5)

    def test_partial_validity(self, rng):
        vocab = tbow.train_vocabulary(rand_desc(rng, 2000), k=8, levels=2, seed=1)
        valid = _t(np.arange(100) < 60)
        _, w, _ = tbow.BowTransformer(vocab)(_t(rand_desc(rng, 100)), valid)
        sw, swt = tbow.sparse_bow(w, vocab.idf, vocab.n_words)
        assert abs(swt.sum().item() - 1.0) < 1e-5
        assert int((sw >= 0).sum()) <= 60
