"""The port's native host library and vocabulary IO
(``orbslam2_tpu_torch.utils.native`` / ``utils.vocab``) against the
reference's (``orbslam2_tpu.utils.native`` / ``utils.vocab``) on the same
files, and ``TestNativeParsers`` / ``TestOrbvocScale`` of
``tests/test_native.py`` and ``TestVocabIO`` of ``tests/test_aux.py`` on
the port.  Every comparison is exact (parsed text and packed arrays).
"""

import time

import numpy as np
import pytest
import torch

from orbslam2_tpu.utils import native as jnative
from orbslam2_tpu.utils import vocab as jvocab
from orbslam2_tpu_torch.ops import bow as tbow
from orbslam2_tpu_torch.utils import native, vocab
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable (no C++ toolchain)")


def make_voc_text(tmp_path, n_nodes=500, k=5, seed=0):
    rng = np.random.default_rng(seed)
    lines = [f"{k} 3 0 0"]
    descs, parents, leaves, weights = [], [], [], []
    for i in range(n_nodes):
        parent = int(rng.integers(0, max(i, 1)))
        leaf = int(rng.uniform() > 0.5)
        d = rng.integers(0, 256, 32)
        w = float(rng.uniform(0, 1))
        parents.append(parent)
        leaves.append(leaf)
        descs.append(d)
        weights.append(w)
        lines.append(f"{parent} {leaf} " + " ".join(str(int(x)) for x in d) + f" {w:.6f}")
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p), parents, leaves, np.stack(descs), weights


def complete_tree_text(path, k, L, seed=0):
    """A complete k-ary tree of depth L in ORBvoc.txt's format."""
    rng = np.random.default_rng(seed)
    parents, is_leaf, start = [], [], {0: 0}
    next_id = 1
    for lvl in range(1, L + 1):
        start[lvl] = next_id
        parents.append(start[lvl - 1] + np.arange(k ** lvl) // k)
        is_leaf.append(np.full(k ** lvl, lvl == L))
        next_id += k ** lvl
    parents, is_leaf = np.concatenate(parents), np.concatenate(is_leaf)
    descs = rng.integers(0, 256, (len(parents), 32))
    weights = np.where(is_leaf, rng.uniform(0.1, 1.0, len(parents)), 0.0)
    body = "\n".join(f"{p} {int(lf)} " + " ".join(map(str, d)) + f" {w:.6f}"
                     for p, lf, d, w in zip(parents.tolist(), is_leaf.tolist(), descs.tolist(),
                                            weights.tolist()))
    path.write_text(f"{k} {L} 0 0\n" + body + "\n")
    return str(path)


def assert_same_vocabulary(port, ref):
    np.testing.assert_array_equal(port.node_desc.numpy(), np.asarray(ref.node_desc).view(np.int32))
    for name in ("children", "word_id", "idf"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    assert port.levels == ref.levels


def test_builds_outside_the_native_source_dir():
    assert native.LIB_PATH.is_file()
    assert native.LIB_PATH.parent == native.BUILD_DIR
    assert "build" in native.BUILD_DIR.parts and native.SOURCE.parent.name == "native"


@pytest.mark.parametrize("n_nodes, k", [(500, 5), (300, 4)])
def test_orbvoc_parse_is_the_reference(tmp_path, n_nodes, k):
    path, *_ = make_voc_text(tmp_path, n_nodes=n_nodes, k=k)
    for a, b in zip(native.parse_orbvoc_fast(path), jnative.parse_orbvoc_fast(path)):
        np.testing.assert_array_equal(a, b)
    assert_same_vocabulary(vocab.load_orbvoc_text(path), jvocab.load_orbvoc_text(path))


def test_complete_tree_and_python_fallback(tmp_path, monkeypatch):
    path = complete_tree_text(tmp_path / "tree.txt", k=4, L=4)
    ref = jvocab.load_orbvoc_text(path)
    assert_same_vocabulary(vocab.load_orbvoc_text(path), ref)
    monkeypatch.setattr(vocab, "parse_orbvoc_fast", lambda p: None)
    assert_same_vocabulary(vocab.load_orbvoc_text(path), ref)
    assert ref.n_words == 4 ** 4


def test_npz_roundtrip_reads_the_reference_file(tmp_path):
    descs = np.random.default_rng(0).integers(0, 2**32, (1000, 8), dtype=np.uint32)
    v = tbow.train_vocabulary(descs, k=5, levels=2, seed=0)
    vocab.save_vocabulary(v, str(tmp_path / "port.npz"))
    assert_same_vocabulary(vocab.load_vocabulary(str(tmp_path / "port.npz")),
                           jvocab.load_vocabulary(str(tmp_path / "port.npz")))
    from orbslam2_tpu.ops import bow as jbow

    jvocab.save_vocabulary(jbow.train_vocabulary(descs, k=5, levels=2, seed=0),
                           str(tmp_path / "ref.npz"))
    assert_same_vocabulary(vocab.load_vocabulary(str(tmp_path / "ref.npz")),
                           jvocab.load_vocabulary(str(tmp_path / "ref.npz")))


# -- TestNativeParsers / TestOrbvocScale (tests/test_native.py) and
#    TestVocabIO (tests/test_aux.py) on the port -----------------------------


class TestNativeParsers:
    def test_orbvoc_matches_reference_data(self, tmp_path):
        path, parents, leaves, descs, weights = make_voc_text(tmp_path)
        header, p_a, l_a, d_a, w_a = native.parse_orbvoc_fast(path)
        assert header[0] == 5 and header[1] == 3
        np.testing.assert_array_equal(p_a, parents)
        np.testing.assert_array_equal(l_a, np.asarray(leaves, bool))
        np.testing.assert_array_equal(d_a, descs)
        np.testing.assert_allclose(w_a, weights, atol=5e-7)

    def test_float_table(self, tmp_path):
        p = tmp_path / "times.txt"
        p.write_text("# comment line\n0.0 1.5\n2.5\n3.75 nonnumeric 4.0\n")
        np.testing.assert_allclose(native.parse_float_table_fast(str(p)),
                                   [0.0, 1.5, 2.5, 3.75, 4.0])

    def test_pgm_decode(self, tmp_path):
        img = np.random.default_rng(0).integers(0, 256, (48, 64), dtype=np.uint8)
        p = tmp_path / "img.pgm"
        p.write_bytes(b"P5\n# comment\n64 48\n255\n" + img.tobytes())
        out = native.decode_pgm_fast(str(p))
        assert out.shape == (48, 64)
        np.testing.assert_array_equal(out.astype(np.uint8), img)

    def test_vocab_loader_uses_native(self, tmp_path):
        path, *_ = make_voc_text(tmp_path, n_nodes=300, k=4)
        v = vocab.load_orbvoc_text(path)
        assert v.n_words > 0 and v.node_desc.shape[0] == 301

    def test_native_parse_speed(self, tmp_path):
        path, *_ = make_voc_text(tmp_path, n_nodes=4000, k=8)
        t0 = time.perf_counter()
        native.parse_orbvoc_fast(path)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(path) as f:
            f.readline()
            for line in f:
                _ = [int(x) for x in line.split()[2:34]]
        assert t_native < time.perf_counter() - t0


class TestOrbvocScale:
    def test_complete_tree_through_the_sparse_database(self, tmp_path, monkeypatch):
        """TestOrbvocScale in miniature (k=8, L=4: 4096 words, the sparse
        path forced): parse, fill a sparse database, self-query."""
        from orbslam2_tpu_torch.models import kf_database as tkdb
        from orbslam2_tpu_torch.models import map_state as tms

        v = vocab.load_orbvoc_text(complete_tree_text(tmp_path / "big.txt", k=8, L=4))
        assert v.n_words == 8 ** 4
        monkeypatch.setattr(tkdb, "_DENSE_MAX_WORDS", 1)
        db = tkdb.KeyframeDatabase(v, 8, feat_capacity=512, device="cpu")
        assert db.sparse
        m = tms.make_empty_map(8, 64, 300, device="cpu")
        m = m._replace(kf_valid=torch.ones(8, dtype=torch.bool),
                       n_kf=torch.tensor(4, dtype=torch.int32))
        rng = np.random.default_rng(0)
        kf_desc = {}
        for kf in range(4):
            kf_desc[kf] = torch.from_numpy(
                rng.integers(0, 2**32, (300, 8), dtype=np.uint32).view(np.int32))
            db.add_keyframe(kf, kf_desc[kf], torch.ones(300, dtype=torch.bool))
        ids = db.detect_relocalization_candidates(m, kf_desc[2], torch.ones(300, dtype=torch.bool),
                                                  n_candidates=2)
        assert len(ids) >= 1 and ids[0] == 2, ids


class TestVocabIO:
    def test_npz_roundtrip(self, tmp_path, rng):
        v = tbow.train_vocabulary(rng.integers(0, 2**32, (1000, 8), dtype=np.uint32), k=5,
                                  levels=2, seed=0)
        p = str(tmp_path / "voc.npz")
        vocab.save_vocabulary(v, p)
        v2 = vocab.load_vocabulary(p)
        assert torch.equal(v.node_desc, v2.node_desc) and torch.equal(v.children, v2.children)
        assert v2.levels == 2

    def test_orbvoc_text_parse(self, tmp_path, rng):
        lines = ["2 1 0 0"]
        for parent, leaf in ((0, 1), (0, 1)):
            d = " ".join(str(int(x)) for x in rng.integers(0, 256, 32))
            lines.append(f"{parent} {leaf} {d} 0.5")
        p = tmp_path / "voc.txt"
        p.write_text("\n".join(lines) + "\n")
        v = vocab.load_orbvoc_text(str(p))
        assert v.n_words == 2
        assert int((v.word_id >= 0).sum()) == 2
        assert int(v.children[0, 0]) == 1
