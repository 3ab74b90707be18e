"""Keyframe place-recognition database.

Port of ``orbslam2_tpu/models/kf_database.py`` (``KeyFrameDatabase``,
src/KeyFrameDatabase.cc).  The inverted file over vocabulary words is

  * a dense (K, W) BoW matrix scored with one reduction (vocabularies up to
    ``_DENSE_MAX_WORDS`` words), or
  * a sparse per-keyframe word list scored by ``ops/bow.l1_scores_sparse``
    (one dense query row and gathers), which reaches ORBvoc's 10^6 words.

``detect_relocalization_candidates`` / ``detect_loop_candidates`` are the
reference's candidate logic (KeyFrameDatabase.cc:≈90-200): the
common-word prefilter (> 0.8 * maxCommonWords), the loop's min-score gate,
the covisibility-group accumulated score over each candidate's top-10
covisible keyframes, and each group's best keyframe cut at 0.75 *
bestAccScore.  The database also keeps each keyframe's feature node ids
(DBoW2's FeatureVector), which gate relocalization's matching.

Updates write the database's own tensors in place.  A query reads the
device once: the shortlist's scores, group winners and covisibility rows
come back in one copy, and the ranking runs on the host with numpy, as in
the reference (its ``np.argsort`` breaks real ties its own way).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import bow as bow_mod
from ..ops.select import topk_stable
from . import map_state as ms

_DENSE_MAX_WORDS = 1 << 17  # beyond this, dense (K, W) rows are wasteful
_MAX_SHORTLIST = 16         # candidates entering group accumulation


def fetch(tensors: Sequence[torch.Tensor]) -> list:
    """Tensors -> numpy arrays through one device-to-host copy: their bytes
    are concatenated on the device and split on the host."""
    parts = [t.detach().contiguous().reshape(-1) for t in tensors]
    raw = torch.cat([p.view(torch.uint8) for p in parts]).cpu().numpy()
    out, off = [], 0
    for t, p in zip(tensors, parts):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        n = p.numel() * dtype.itemsize
        out.append(np.frombuffer(raw[off:off + n].tobytes(), dtype).reshape(tuple(t.shape)))
        off += n
    return out


def _grouped_acc_scores(
    m: ms.MapState,
    short_ids: torch.Tensor,  # (S,) candidate keyframe ids
    short_ok: torch.Tensor,   # (S,)
    scores: torch.Tensor,     # (K,) L1 scores (0 where not shortlisted)
    shortlist: torch.Tensor,  # (K,) bool
    n_top: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each candidate's accumulated score over its top-10 covisible
    keyframes that are also shortlisted, the best-scoring keyframe of its
    group (itself included), and its covisibility row."""
    rows = ms.covisible_rows(m, short_ids)
    w, ids = topk_stable(rows, min(n_top, rows.shape[1]))
    in_grp = (w > 0) & shortlist[ids]
    s_ids = scores[ids]
    own = scores[short_ids.long()]
    acc = own + bow_mod.sum32(torch.where(in_grp, s_ids, 0.0), -1)
    cand = torch.where(in_grp, s_ids, -1.0)
    best_i = torch.argmax(cand, dim=-1)
    best_kf = torch.where(cand.amax(-1) > own, ids.gather(1, best_i[:, None])[:, 0],
                          short_ids.long())
    return torch.where(short_ok, acc, -1.0), best_kf, rows


class KeyframeDatabase:
    """Per-keyframe BoW state, updated at keyframe insertion.  ``device``
    defaults to the vocabulary's; ``host_syncs`` counts the device reads
    the queries made."""

    def __init__(self, vocab: bow_mod.Vocabulary, kf_capacity: int,
                 feat_capacity: int = 2048, device=None):
        self.device = torch.device(device) if device is not None else vocab.idf.device
        self.vocab = vocab.to(self.device)
        self.transformer = bow_mod.BowTransformer(self.vocab)
        self.sparse = vocab.n_words > _DENSE_MAX_WORDS
        kw = dict(device=self.device)
        if self.sparse:
            self.db_words = torch.full((kf_capacity, feat_capacity), -1, dtype=torch.int32, **kw)
            self.db_weights = torch.zeros((kf_capacity, feat_capacity), **kw)
        else:
            self.bow = torch.zeros((kf_capacity, vocab.n_words), **kw)
        self.has_entry = torch.zeros(kf_capacity, dtype=torch.bool, **kw)
        self._feat_capacity = feat_capacity
        # Per-keyframe feature node ids (the FeatureVector), allocated at
        # the first insertion with the frames' feature capacity.
        self.db_nodes: Optional[torch.Tensor] = None
        self.host_syncs = 0

    # -- updates -----------------------------------------------------------

    def add_keyframe(self, kf_id: int, desc: torch.Tensor, valid: torch.Tensor):
        row, words, nodes = self.transformer(desc, valid)
        if self.sparse:
            sw, swt = bow_mod.sparse_bow(words, self.vocab.idf, self.vocab.n_words)
            cap = self._feat_capacity
            n = min(sw.shape[0], cap)
            # fill_ passes the scalar to the kernel; assigning a Python
            # scalar copies it from the host and waits for the device.
            self.db_words[kf_id].fill_(-1)
            self.db_weights[kf_id].fill_(0.0)
            self.db_words[kf_id, :n] = sw[:n]
            self.db_weights[kf_id, :n] = swt[:n]
        else:
            self.bow[kf_id] = row
        if self.db_nodes is None:
            self.db_nodes = torch.full((self.has_entry.shape[0], nodes.shape[0]), -1,
                                       dtype=torch.int32, device=self.device)
        self.db_nodes[kf_id] = torch.where(valid, nodes, -1)
        self.has_entry[kf_id].fill_(True)
        return words, nodes

    def nodes_for(self, kf_id: int) -> Optional[torch.Tensor]:
        """(N,) feature node ids of a stored keyframe (-1 invalid), or None
        before any insertion."""
        return None if self.db_nodes is None else self.db_nodes[kf_id]

    def frame_nodes(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        _, _, nodes = self.transformer(desc, valid)
        return torch.where(valid, nodes, -1)

    # -- scoring -----------------------------------------------------------

    def _query_row(self, desc: torch.Tensor, valid: torch.Tensor):
        row, words, _ = self.transformer(desc, valid)
        return row, words

    def _scores_and_common(self, row, words) -> Tuple[torch.Tensor, torch.Tensor]:
        """L1 scores (K,) and common-word counts (K,) of a query."""
        W = self.vocab.n_words
        ok = words >= 0
        qmask = ms.scatter_max(W, torch.where(ok, words, W), ok.to(torch.float32))
        if self.sparse:
            sw, swt = bow_mod.sparse_bow(words, self.vocab.idf, W)
            scores = bow_mod.l1_scores_sparse(sw, swt, self.db_words, self.db_weights, W)
            d_ok = self.db_words >= 0
            common = (qmask[self.db_words.clamp(min=0).long()] * d_ok).sum(1)
        else:
            scores = bow_mod.l1_scores(row, self.bow)
            common = (self.bow > 0).to(torch.float32) @ qmask
        return scores, common

    def _scores(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self._scores_and_common(*self._query_row(desc, valid))[0]

    def _scores_for_kf(self, m: ms.MapState, kf_id: int):
        return self._scores_and_common(*self._query_row(m.kf_desc[kf_id], m.kf_kp_valid[kf_id]))

    # -- queries (the reference's candidate logic) ---------------------------

    def _grouped_candidates(
        self,
        m: ms.MapState,
        scores: torch.Tensor,
        common: torch.Tensor,
        eligible: torch.Tensor,
        n_candidates: int,
        extras: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, dict, object]:
        """The prefilter, group accumulation and cut shared by loop and
        relocalization queries.  Returns (ids, acc_scores, covis_groups,
        extras_host): covis_groups maps a candidate id to the set of
        keyframes covisible with it; ``extras`` (tensors) come back as numpy
        arrays in the same device read."""
        eligible = eligible & (common > 0)
        max_common = torch.where(eligible, common, 0.0).amax()
        shortlist = eligible & (common > 0.8 * max_common)
        sl_scores = torch.where(shortlist, scores, 0.0)
        top_s, short_ids = topk_stable(torch.where(shortlist, scores, -1.0),
                                       min(_MAX_SHORTLIST, shortlist.shape[0]))
        acc_d, best_kf_d, rows_d = _grouped_acc_scores(m, short_ids, top_s > 0.0, sl_scores,
                                                       shortlist)
        # ONE host read for the whole candidate decision.
        extras = list(extras or ())
        acc, best_kf, rows, sl, *extras_host = fetch([acc_d, best_kf_d, rows_d, short_ids,
                                                      *extras])
        self.host_syncs += 1
        extras_host = extras_host if extras else None
        if not (acc > 0).any():
            return np.zeros(0, np.int64), np.zeros(0), {}, extras_host
        cut = 0.75 * acc.max()
        keep = acc >= cut
        groups = {int(sl[i]): set(np.nonzero(rows[i] > 0)[0].tolist()) for i in range(len(sl))}
        # Group winners, strongest accumulated score first.
        order = np.argsort(-acc)
        seen, out_ids, out_acc = set(), [], []
        for i in order:
            if not keep[i]:
                continue
            k = int(best_kf[i])
            if k in seen:
                continue
            seen.add(k)
            out_ids.append(k)
            out_acc.append(float(acc[i]))
            if len(out_ids) >= n_candidates:
                break
        # Winners can collapse onto one keyframe on small, heavily covisible
        # maps: backfill with the entry keyframes of groups that passed the
        # cut, still by accumulated score.
        if len(out_ids) < n_candidates:
            for i in order:
                if not keep[i]:
                    continue
                k = int(sl[i])
                if k in seen:
                    continue
                seen.add(k)
                out_ids.append(k)
                out_acc.append(float(acc[i]))
                if len(out_ids) >= n_candidates:
                    break
        # A winner taken from best_kf borrows its entry keyframe's group.
        for i in order:
            k = int(best_kf[i])
            if k in seen and k not in groups:
                groups[k] = groups.get(int(sl[i]), set())
        return np.asarray(out_ids, np.int64), np.asarray(out_acc), groups, extras_host

    def detect_loop_candidates(
        self,
        m: ms.MapState,
        kf_id: int,
        n_candidates: int = 3,
        extras: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, dict, object]:
        """KeyFrameDatabase::DetectLoopCandidates (≈90): the prefilter,
        covisible exclusion, the min-score gate (the lowest score among the
        query's covisible keyframes) and group accumulation with the 0.75
        cut.  Returns (ids, acc_scores, covis_groups, extras_host)."""
        scores, common = self._scores_for_kf(m, kf_id)
        covis_row = ms.covisible_row(m, kf_id) > 0
        covis_scores = torch.where(covis_row & self.has_entry, scores, float("inf"))
        min_score = covis_scores.amin()
        min_score = torch.where(torch.isinf(min_score), 0.0, min_score)
        K = self.has_entry.shape[0]
        eligible = (
            self.has_entry & m.kf_valid & ~covis_row
            & (torch.arange(K, device=self.device) != kf_id)
            & (scores >= torch.clamp(min_score, min=1e-9))
        )
        return self._grouped_candidates(m, scores, common, eligible, n_candidates,
                                        extras=extras)

    def detect_relocalization_candidates(
        self,
        m: ms.MapState,
        frame_desc: torch.Tensor,
        frame_valid: torch.Tensor,
        n_candidates: int = 8,
    ) -> np.ndarray:
        """KeyFrameDatabase::DetectRelocalizationCandidates (≈200): the
        grouped logic without the covisible exclusion or min-score gate.
        Up to 8 candidates: the geometric verifier (P4P and the pose
        polish) is the real filter, so it gets alternatives."""
        scores, common = self._scores_and_common(*self._query_row(frame_desc, frame_valid))
        eligible = self.has_entry & m.kf_valid & (scores > 0)
        return self._grouped_candidates(m, scores, common, eligible, n_candidates)[0]

    # -- maintenance -------------------------------------------------------

    def remap(self, kf_new_from_old: np.ndarray):
        """Apply a keyframe-pool compaction (``map_state.compact_map``): row
        j becomes the row of the old id that moved to slot j; rows of
        dropped keyframes are cleared."""
        K = self.has_entry.shape[0]
        kf_map = np.asarray(kf_new_from_old)
        old_of_new = np.full(K, -1, np.int64)
        kept = np.nonzero(kf_map >= 0)[0]
        old_of_new[kf_map[kept]] = kept
        src = torch.from_numpy(np.maximum(old_of_new, 0)).to(self.device)
        live = torch.from_numpy(old_of_new >= 0).to(self.device)
        if self.sparse:
            self.db_words = torch.where(live[:, None], self.db_words[src], -1)
            self.db_weights = torch.where(live[:, None], self.db_weights[src], 0.0)
        else:
            self.bow = torch.where(live[:, None], self.bow[src], 0.0)
        if self.db_nodes is not None:
            self.db_nodes = torch.where(live[:, None], self.db_nodes[src], -1)
        self.has_entry = live & self.has_entry[src]

    def frame_bow(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.transformer(desc, valid)[0]
