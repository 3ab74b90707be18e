"""Bag-of-binary-words place recognition.

Port of ``orbslam2_tpu/ops/bow.py`` (the role of DBoW2,
Thirdparty/DBoW2):

  * ``Vocabulary``: the tree as flat tensors (node descriptors as int32
    words holding the uint32 bits, a child table, leaf word ids, idf
    weights); ``train_vocabulary`` is the reference's numpy k-medians,
    copied, and gives the same arrays.
  * ``_descend``: all descriptors of a frame go down the tree together,
    one (N, k) Hamming step per level (plain torch: the k children's
    distances are gathers, not K2's matrix).
  * ``_bow_row`` / ``l1_scores``: a dense L1-normalized tf-idf row and
    DBoW2's L1 score against stacked database rows;
    ``sparse_bow`` / ``l1_scores_sparse``: the same at ORBvoc scale (10^6
    words) with one dense row, the query's, and gathers.

Each word's terms in a BoW row are equal (its idf weight), so the port
counts them with an integer scatter and multiplies: no float atomics (the
card's float ``index_add`` sums in a varying order) and no host read.  The
reference adds the copies one by one; the two agree within an ulp.

The sums that scores and norms are made of run in float64 and are rounded
to float32 once (``sum32``): the reference adds in sequence, and scores
that are equal in exact arithmetic come out equal there, which decides how
its candidate ranking breaks ties.  Float32 sums in torch's vectorized
order would round such ties apart; sums accurate to the last bit keep them
tied on the CPU and the card alike.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.map_state import scatter_add
from .hamming import popcount32


class Vocabulary(NamedTuple):
    """Flat hierarchical vocabulary.

    node_desc:  (n_nodes, 8) int32 node centres (the uint32 bits)
    children:   (n_nodes, k) int32 child node ids (-1 none)
    word_id:    (n_nodes,) int32 leaf word id, -1 for internal nodes
    idf:        (n_words,) float32 inverse document frequency weights
    levels:     tree depth
    """

    node_desc: torch.Tensor
    children: torch.Tensor
    word_id: torch.Tensor
    idf: torch.Tensor
    levels: int

    @property
    def n_words(self) -> int:
        return self.idf.shape[0]

    def to(self, device) -> "Vocabulary":
        return self._replace(**{k: getattr(self, k).to(device)
                                for k in ("node_desc", "children", "word_id", "idf")})


def vocabulary_from_arrays(node_desc, children, word_id, idf, levels: int) -> Vocabulary:
    """numpy arrays (node descriptors as uint32) -> a ``Vocabulary`` of CPU
    tensors."""
    desc = np.ascontiguousarray(np.asarray(node_desc, np.uint32)).view(np.int32)
    return Vocabulary(
        node_desc=torch.from_numpy(desc.copy()),
        children=torch.from_numpy(np.array(children, np.int32)),
        word_id=torch.from_numpy(np.array(word_id, np.int32)),
        idf=torch.from_numpy(np.array(idf, np.float32)),
        levels=int(levels),
    )


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 8) x (m, 8) uint32 -> (n, m) int popcount distance (numpy)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Median binary descriptor: per-bit majority vote. (n, 8) -> (8,)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # (n, 256)
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train_vocabulary_arrays(
    descriptors: np.ndarray, k: int = 10, levels: int = 3, seed: int = 0, iters: int = 8,
):
    """The reference's hierarchical k-medians over packed binary
    descriptors (numpy, unchanged): returns (node_desc uint32, children,
    word_id, idf).  Empty branches get copies of their parent centre so the
    tree stays complete."""
    rng = np.random.default_rng(seed)
    descriptors = np.asarray(descriptors, np.uint32).reshape(-1, 8)

    nodes_desc = [np.zeros(8, np.uint32)]  # root (unused center)
    children: list = [[]]
    node_items = {0: descriptors}
    frontier = [0]
    for level in range(levels):
        new_frontier = []
        for node in frontier:
            items = node_items.pop(node, None)
            if items is None or len(items) == 0:
                items = np.zeros((0, 8), np.uint32)
            if len(items) >= k:
                centers = items[rng.choice(len(items), k, replace=False)]
                for _ in range(iters):
                    d = _hamming_np(items, centers)
                    assign = d.argmin(1)
                    centers = np.stack(
                        [
                            _bit_majority(items[assign == j])
                            if np.any(assign == j)
                            else centers[j]
                            for j in range(k)
                        ]
                    )
                d = _hamming_np(items, centers)
                assign = d.argmin(1)
            else:
                centers = np.tile(nodes_desc[node][None, :], (k, 1))
                if len(items):
                    centers[: len(items)] = items
                assign = np.arange(len(items)) if len(items) else np.zeros(0, int)
            ids = []
            for j in range(k):
                nid = len(nodes_desc)
                nodes_desc.append(np.asarray(centers[j], np.uint32))
                children.append([])
                ids.append(nid)
                if level < levels - 1:
                    node_items[nid] = items[assign == j]
            children[node] = ids
            new_frontier.extend(ids)
        frontier = new_frontier

    n_nodes = len(nodes_desc)
    child_arr = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        for j, c in enumerate(ch):
            child_arr[i, j] = c
    word_id = np.full(n_nodes, -1, np.int32)
    leaves = [i for i in range(n_nodes) if not children[i] and i != 0]
    for w, i in enumerate(leaves):
        word_id[i] = w
    return np.stack(nodes_desc), child_arr, word_id, np.ones(len(leaves), np.float32)


def train_vocabulary(
    descriptors: np.ndarray, k: int = 10, levels: int = 3, seed: int = 0, iters: int = 8,
) -> Vocabulary:
    """Hierarchical k-medians (DBoW2's recipe; ORBvoc is k=10, L=6):
    packed uint32 descriptors (n, 8) -> a ``Vocabulary`` of CPU tensors."""
    return vocabulary_from_arrays(
        *train_vocabulary_arrays(descriptors, k, levels, seed, iters), levels)


def sum32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Sum in float64, rounded once to float32."""
    s = x.sum(dtype=torch.float64) if dim is None else x.sum(dim, dtype=torch.float64)
    return s.to(torch.float32)


def _descend(
    desc: torch.Tensor,
    node_desc: torch.Tensor,
    children: torch.Tensor,
    word_id: torch.Tensor,
    levels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched tree descent: (N, 8) descriptors -> (N,) word ids and (N,)
    FeatureVector node ids, the ancestor at depth max(1, L - 4) (DBoW2's
    levelsup=4; the reference keeps depth 1 for shallow vocabularies).
    Each level takes the first nearest child, as ``argmin``."""
    anc_depth = max(1, levels - 4)
    cur = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)  # root
    ancestor = cur
    for level in range(levels):
        ch = children[cur].long()  # (N, k)
        cd = node_desc[ch.clamp(min=0)]  # (N, k, 8)
        dist = popcount32(torch.bitwise_xor(cd, desc[:, None, :])).sum(-1)
        dist = torch.where(ch >= 0, dist, 1 << 30)
        best = torch.argmin(dist, dim=-1)
        cur = ch.gather(1, best[:, None])[:, 0]
        if level == anc_depth - 1:
            ancestor = cur
    return word_id[cur], ancestor.to(torch.int32)


class BowTransformer:
    """Frame descriptors -> dense tf-idf BoW row + word ids + feature node
    ids (TemplatedVocabulary::transform's BowVector and FeatureVector)."""

    def __init__(self, vocab: Vocabulary):
        self.vocab = vocab

    def __call__(self, desc: torch.Tensor, valid: torch.Tensor):
        v = self.vocab
        words, nodes = _descend(desc, v.node_desc, v.children, v.word_id, v.levels)
        words = torch.where(valid, words, -1)
        return _bow_row(words, v.idf, v.n_words), words, nodes


def _bow_row(words: torch.Tensor, idf: torch.Tensor, n_words: int) -> torch.Tensor:
    """Word ids (-1 none) -> L1-normalized dense tf-idf row (n_words,)."""
    counts = scatter_add(n_words, torch.where(words >= 0, words, n_words), 1)
    row = counts.to(torch.float32) * idf
    return row / torch.clamp(sum32(row.abs()), min=1e-9)


def l1_scores(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 score of a query row against every database row:
    1 - 0.5 * sum|q - d| (the scoring ORB-SLAM2's KeyFrameDatabase uses).
    (K, W) database x (W,) query -> (K,) scores in [0, 1]."""
    return 1.0 - 0.5 * sum32((database - query[None, :]).abs(), -1)


# ---------------------------------------------------------------------------
# Sparse (inverted-index-scale) scoring — for ORBvoc-sized vocabularies
# ---------------------------------------------------------------------------


def sparse_bow(words: torch.Tensor, idf: torch.Tensor, n_words: int, capacity: int = 0):
    """Frame words -> sparse L1-normalized BoW (word_ids, weights), each of
    the frame's length: a word's whole weight sits on its first slot in
    sorted order and its repeats get -1 / 0.  ``capacity`` is unused, as in
    the reference."""
    N = words.shape[0]
    w = torch.where(words >= 0, words, n_words)  # invalid -> sentinel bucket
    ws, _ = torch.sort(w, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ws.device), ws[1:] != ws[:-1]])
    real = first & (ws < n_words)
    run_id = torch.cumsum(first.to(torch.int32), 0) - 1
    run_len = scatter_add(N, run_id, 1)
    weight = torch.where(real, run_len[run_id].to(torch.float32)
                         * idf[torch.clamp(ws, max=n_words - 1)], 0.0)
    weight = weight / torch.clamp(sum32(weight), min=1e-9)
    return torch.where(real, ws, -1).to(torch.int32), weight


def l1_scores_sparse(
    query_words: torch.Tensor,    # (Nq,) int32 sparse word ids (-1 pad)
    query_weights: torch.Tensor,  # (Nq,) float32 (L1-normalized)
    db_words: torch.Tensor,       # (K, S) int32 (-1 pad)
    db_weights: torch.Tensor,     # (K, S) float32 (L1-normalized rows)
    n_words: int,
) -> torch.Tensor:
    """DBoW2's L1 score against a sparse database (ORBvoc scale): one dense
    row, the query's, and S gathers per database row.
    score = sum over common words of 0.5 (|q_w| + |d_w| - |q_w - d_w|).
    The query holds each word once (``sparse_bow``'s output), so its dense
    row is a plain scatter; -1 entries land on a dropped sentinel row."""
    ok = query_words >= 0
    q_dense = torch.zeros(n_words + 1, dtype=torch.float32, device=query_words.device)
    q_dense = q_dense.index_put((torch.where(ok, query_words, n_words).long(),),
                                torch.where(ok, query_weights, 0.0))[:n_words]
    d_ok = db_words >= 0
    q_at = q_dense[torch.where(d_ok, db_words, 0).long()] * d_ok
    dw = torch.where(d_ok, db_weights, 0.0)
    return 0.5 * sum32(q_at + dw - (q_at - dw).abs(), -1)
