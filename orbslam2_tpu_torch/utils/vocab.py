"""Vocabulary IO: ORBvoc.txt conversion and packed npz save / load.

Port of ``orbslam2_tpu/utils/vocab.py``.  The reference loads DBoW2's 44 MB
``ORBvoc.txt`` at startup; it converts once to the packed arrays of
``ops/bow.Vocabulary`` and loads the npz thereafter.

ORBvoc.txt format (DBoW2 TemplatedVocabulary::loadFromTextFile):
  line 1: 'k L scoring_type weighting_type'
  then one line per node (preorder, root implicit):
    parent_id is_leaf d0 d1 ... d31 weight

Every function returns a ``Vocabulary`` of CPU tensors; ``.to(device)``
moves it (``SlamSystem`` and ``KeyframeDatabase`` do).
"""

from __future__ import annotations

import numpy as np

from ..ops.bow import Vocabulary, vocabulary_from_arrays
from .native import parse_orbvoc_fast


def _parse_text(path: str):
    with open(path, "r") as f:
        header = f.readline().split()
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            p = line.split()
            if len(p) < 35:
                continue
            parents.append(int(p[0]))
            leaves.append(int(p[1]) != 0)
            descs.append([int(x) for x in p[2:34]])
            weights.append(float(p[34]))
    return (int(header[0]), int(header[1]), np.asarray(parents, np.int64).reshape(-1),
            np.asarray(leaves, bool).reshape(-1), np.asarray(descs, np.uint8).reshape(-1, 32),
            np.asarray(weights, np.float64).reshape(-1))


def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse DBoW2's ORBvoc.txt into a packed ``Vocabulary``: the native
    streaming parser (``utils/native.py``) when the C++ library builds,
    else the Python loop."""
    fast = parse_orbvoc_fast(path)
    if fast is not None:
        header, parents_a, leaves_a, descs_a, weights_a = fast
        k, L = int(header[0]), int(header[1])
    else:
        k, L, parents_a, leaves_a, descs_a, weights_a = _parse_text(path)
    n = len(parents_a) + 1  # + root
    node_desc = np.zeros((n, 32), np.uint8)
    node_parent = np.full(n, -1, np.int64)
    is_leaf = np.zeros(n, bool)
    weight = np.zeros(n, np.float64)
    node_desc[1:] = descs_a
    node_parent[1:] = parents_a
    is_leaf[1:] = leaves_a
    weight[1:] = weights_a

    # Children table, vectorized: group nodes by parent with a stable
    # argsort; a node's slot is its rank within its parent's group.
    children = np.full((n, k), -1, np.int32)
    if n > 1:
        ids = np.arange(1, n, dtype=np.int64)
        par = node_parent[1:]
        ok = (par >= 0) & (par < n)
        ids, par = ids[ok], par[ok]
        order = np.argsort(par, kind="stable")
        ps, ns = par[order], ids[order]
        first = np.r_[True, ps[1:] != ps[:-1]]
        grp_start = np.maximum.accumulate(np.where(first, np.arange(len(ps)), 0))
        pos = np.arange(len(ps)) - grp_start
        in_k = pos < k
        children[ps[in_k], pos[in_k]] = ns[in_k].astype(np.int32)

    word_id = np.full(n, -1, np.int32)
    leaf_ids = np.nonzero(is_leaf)[0]
    word_id[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
    idf = weight[leaf_ids].astype(np.float32)

    b = node_desc.reshape(n, 8, 4).astype(np.uint32)
    packed = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    return vocabulary_from_arrays(packed, children, word_id, idf, L)


def save_vocabulary(vocab: Vocabulary, path: str) -> None:
    """The reference's npz layout (node descriptors as uint32)."""
    np.savez_compressed(
        path,
        node_desc=vocab.node_desc.cpu().numpy().view(np.uint32),
        children=vocab.children.cpu().numpy(),
        word_id=vocab.word_id.cpu().numpy(),
        idf=vocab.idf.cpu().numpy(),
        levels=np.int32(vocab.levels),
    )


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    return vocabulary_from_arrays(z["node_desc"], z["children"], z["word_id"], z["idf"],
                                  int(z["levels"]))
