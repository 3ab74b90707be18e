"""Loop closing: detection, Sim3 verification, correction, global BA.

Port of ``orbslam2_tpu/models/loop_closing.py`` (the LoopClosing thread,
src/LoopClosing.cc), run synchronously after local mapping:

  DetectLoop    (≈60): BoW candidates (``models/kf_database``) with the
                covisible-consistency requirement (a candidate's group
                persists over 3 consecutive keyframes).
  ComputeSim3   (≈160): SearchByBoW -> Sim3 RANSAC (``ops/sim3_solve``)
                -> SearchBySim3 -> OptimizeSim3 (``solvers/sim3_opt``) ->
                the loop neighbourhood's projection count -> a Sim3 polish
                on those projections, every stage enqueued and all gate
                scalars read back in one host read per candidate; then the
                host gates, the odometry-consistency gate among them.
  CorrectLoop   (≈330): the corrected Sim3 seeds the current covisible
                group, the essential graph is optimized
                (``solvers/pose_graph``), points follow their reference
                keyframes, SearchAndFuse rebinds the current group to the
                loop side, and global BA (``solvers/global_ba``) polishes in
                abortable segments that must keep the loop edges closed.

Every matching runs through ``ops/hamming.match_descriptors`` (K2) and
every joint GBA segment through ``solvers/local_ba.schur_ba_core`` (K4,
K5).  ``top_k`` over 0/1 scores is ``ops/select.topk_stable`` (lower index
first on ties, as JAX).  RANSAC samples come from ``generator``, seeded 7
on the map's device as the reference seeds its key, through
``_ransac_samples``.  ``host_syncs`` counts the device reads.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import Settings
from ..ops import pnp
from ..ops import pyramid as pyr_ops
from ..ops import sim3_solve
from ..ops.hamming import TH_HIGH, TH_LOW, match_descriptors, rotation_consistency
from ..ops.select import topk_stable
from ..solvers import pose_graph as pg
from ..solvers.global_ba import global_bundle_adjustment, run_joint_global_ba
from ..solvers.lie import (
    jacfwd_batched, se3_apply, se3_inverse, sim3_apply, sim3_exp, sim3_inverse_mat, sim3_to_mat,
)
from ..solvers.sim3_opt import lm_solve7, optimize_sim3, scale_keep
from ..utils.camera import CameraModel
from . import map_state as ms
from .kf_database import KeyframeDatabase, fetch

CHI2_LOOP_REFINE = 10.0
STAGE_PREFIX = "loop."  # profiler ranges: loop.<stage>


def loop_edge_residuals(T_cw: np.ndarray, loop_edges) -> list:
    """Per-loop-edge (translation, angle-deg) constraint residuals of the
    keyframe poses against the verified Sim3 measurements."""
    out = []
    for (ki, kj, S_ji) in loop_edges:
        rel = T_cw[kj] @ np.linalg.inv(T_cw[ki])
        D = rel @ np.linalg.inv(np.asarray(S_ji))
        s = np.cbrt(max(np.linalg.det(D[:3, :3]), 1e-12))
        dt = float(np.linalg.norm(D[:3, 3]))
        ang = float(np.degrees(np.arccos(np.clip(
            (np.trace(D[:3, :3] / s) - 1.0) / 2.0, -1.0, 1.0))))
        out.append((dt, ang))
    return out


def loop_edges_still_closed(before: list, after: list, scene_scale: float = 1.0) -> bool:
    """GBA acceptance guard: the loop edges' residuals must not grow by more
    than 25% plus a slack (3% of ``scene_scale``, the median keyframe
    baseline, at least 5 mm; 0.25 degrees)."""
    slack_t = max(0.005, 0.03 * scene_scale)
    for (dt0, a0), (dt1, a1) in zip(before, after):
        if dt1 > 1.25 * dt0 + slack_t or a1 > 1.25 * a0 + 0.25:
            return False
    return True


def _camera_centers(poses: np.ndarray, ids) -> np.ndarray:
    return np.stack([-poses[k][:3, :3].T @ poses[k][:3, 3] for k in ids])


class LoopCloser:
    """``process_keyframe(m, kf_id)`` after each keyframe's local mapping;
    returns the (possibly loop-corrected) map.  ``loop_edges`` holds the
    accepted (loop kf, current kf, S_CL) edges; ``metrics`` the rejections
    by stage.  ``enable_gba`` runs the global BA after the essential graph;
    ``gba_mode`` "joint" solves the whole map as one Schur problem and falls
    back to the alternation beyond its camera cap."""

    def __init__(
        self,
        settings: Settings,
        database: KeyframeDatabase,
        fix_scale: bool,
        enable_gba: bool = True,
        gba_mode: str = "joint",
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "LoopCloser(mesh=...) is not ported yet (ROADMAP Queue 1 item 17)")
        if not isinstance(database, KeyframeDatabase):
            raise TypeError(f"LoopCloser(database=...) takes this package's KeyframeDatabase, "
                            f"not {type(database).__name__}")
        self.enable_gba = enable_gba
        self.gba_mode = gba_mode
        self.settings = settings
        self.device = torch.device(device)
        self.cam = settings.camera_model()
        self.db = database
        self.fix_scale = fix_scale
        # Odometry-consistency gate: drift between two keyframes should not
        # exceed this fraction of the odometric path between them (with an
        # absolute floor for short paths).
        self.max_drift_frac = 0.15
        self.min_drift_abs = 0.5
        orb = settings.orb
        sigma2 = pyr_ops.level_sigma2(orb.n_levels, orb.scale_factor).astype(np.float32)
        self.sigma2 = torch.from_numpy(sigma2).to(self.device)
        self.inv_sigma2 = torch.from_numpy((1.0 / sigma2).astype(np.float32)).to(self.device)
        self.scale_factors = torch.from_numpy(
            pyr_ops.scale_factors(orb.n_levels, orb.scale_factor)).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(7)
        # Consistent groups of LoopClosing::DetectLoop: sorted group tuple ->
        # streak, in insertion order.
        self.candidate_streak: dict = {}
        # (kf_valid numpy, n_kf int) read with the last detection.
        self.pool_state = None
        self.last_loop_kf = -100
        self.loop_edges: List[Tuple[int, int, np.ndarray]] = []
        self.metrics: dict = {}
        self.host_syncs = 0
        self._abort = None

    # ------------------------------------------------------------------

    def _fetch(self, tensors) -> list:
        """One counted device-to-host read of ``tensors``."""
        self.host_syncs += 1
        return fetch(tensors)

    def _ransac_samples(self, valid: torch.Tensor, iters: int, k: int) -> torch.Tensor:
        """(iters, k) Sim3 RANSAC sample indices from the loop closer's
        generator."""
        return pnp.draw_samples(valid, iters, k, self.generator)

    def remap(self, kf_new_from_old):
        """Apply a keyframe-pool compaction (``map_state.compact_map``) to the
        host-held keyframe ids; the streak groups restart."""
        kf_map = np.asarray(kf_new_from_old)

        def r(k):
            return int(kf_map[k]) if 0 <= k < len(kf_map) else -1

        self.loop_edges = [(r(a), r(b), S) for a, b, S in self.loop_edges
                           if r(a) >= 0 and r(b) >= 0]
        self.last_loop_kf = r(self.last_loop_kf) if self.last_loop_kf >= 0 else -100
        self.candidate_streak = {}

    def process_keyframe(self, m: ms.MapState, kf_id: int, abort=None) -> ms.MapState:
        """Returns the (possibly loop-corrected) map.  ``abort`` is an
        optional ``threading.Event`` checked between GBA segments."""
        self._abort = abort
        self.pool_state = None
        # No detection within 10 keyframes of the last loop, nor before the
        # 8th keyframe (slot ids are monotonic: kf_id + 1 <= n_kf).
        if kf_id - self.last_loop_kf < 10 or kf_id + 1 < 8:
            return m
        syncs0 = self.db.host_syncs
        with record_function(STAGE_PREFIX + "detect"):
            cand_ids, _, covis_groups, extras = self.db.detect_loop_candidates(
                m, kf_id, extras=(m.kf_valid, m.n_kf))
        self.host_syncs += self.db.host_syncs - syncs0
        if extras is not None:
            kv, nk = extras
            self.pool_state = (kv, int(nk))
        # Consistency: a candidate (or its covisible group) must persist 3
        # consecutive keyframes; the first overlapping previous group wins.
        new_streak = {}
        fired = []
        for c in cand_ids:
            group = set(covis_groups.get(int(c), set())) | {int(c)}
            streak = 1
            for prev_group, prev_streak in self.candidate_streak.items():
                if group & set(prev_group):
                    streak = prev_streak + 1
                    break
            new_streak[tuple(sorted(group))] = streak
            if streak >= 3:
                fired.append(int(c))
        self.candidate_streak = new_streak
        if not fired:
            return m

        for loop_kf in fired:
            S_CL = self._compute_sim3(m, kf_id, loop_kf)
            if S_CL is None:
                continue
            m = self._correct_loop(m, kf_id, loop_kf, S_CL)
            self.last_loop_kf = kf_id
            self.candidate_streak = {}
            break
        return m

    # ------------------------------------------------------------------

    def _compute_sim3(self, m: ms.MapState, kf_c: int, kf_l: int):
        """Returns the packed Sim3 S_CL (current camera <- loop camera) as
        numpy, or None.  Pass 1 is the node-gated SearchByBoW at ratio
        0.75; a marginal candidate (5 <= matches, short of 20 matches or 10
        distinct) is matched again ungated at ratio 0.9, with RANSAC seeded
        from >= 4 inliers and SearchBySim3's windows 2.5x wider, and must
        clear the gates with >= 5 matches and >= 4 distinct (as the
        reference does, ADVICE r5: looser than its docstring)."""
        res = self._sim3_pipeline(m, kf_c, kf_l, node_gated=True, ratio=0.75)
        n_matches, n_distinct = res[0], res[1]
        if int(n_matches) >= 20 and int(n_distinct) >= 10:
            return self._apply_sim3_gates(m, kf_c, kf_l, res)
        if int(n_matches) < 5:
            return self._apply_sim3_gates(m, kf_c, kf_l, res)  # logs the reject
        self.metrics["sim3_bow_retries"] = self.metrics.get("sim3_bow_retries", 0) + 1
        res = self._sim3_pipeline(m, kf_c, kf_l, node_gated=False, ratio=0.9, ransac_min=4,
                                  sim3_radius_mult=2.5)
        return self._apply_sim3_gates(m, kf_c, kf_l, res, min_bow=5, min_distinct=4)

    def _sim3_pipeline(self, m: ms.MapState, kf_c: int, kf_l: int, node_gated: bool,
                       ratio: float, ransac_min: int = 20, sim3_radius_mult: float = 1.0):
        """ComputeSim3's device pipeline: SearchByBoW -> Sim3 RANSAC ->
        SearchBySim3 -> OptimizeSim3 -> neighbourhood projection -> refine.
        Every stage is enqueued whatever the previous one found (masked
        inputs keep degenerate cases finite) and all gate scalars, the
        refined Sim3 and the poses come back in ONE host read.  Returns
        (n_matches, n_distinct, n_bound_c, n_bound_l, ransac_ok, n_inliers,
        n_proj, S_ref, kf_pose_cw, kf_valid) as numpy."""
        with record_function(STAGE_PREFIX + "sim3_pipeline"):
            L = self.sigma2.shape[0]
            desc_c, desc_l = m.kf_desc[kf_c], m.kf_desc[kf_l]
            ok_c = m.kf_kp_valid[kf_c] & (m.kf_point[kf_c] >= 0)
            ok_l = m.kf_kp_valid[kf_l] & (m.kf_point[kf_l] >= 0)
            # Node-gated SearchByBoW (ORBmatcher.cc:≈250): only pairs under
            # the same vocabulary node.
            nodes_c = self.db.nodes_for(kf_c) if node_gated else None
            nodes_l = self.db.nodes_for(kf_l) if node_gated else None
            pair_mask = None
            if nodes_c is not None and nodes_l is not None:
                pair_mask = (nodes_c[:, None] == nodes_l[None, :]) & (nodes_c[:, None] >= 0)
            # One-directional nearest neighbour with the ratio gate and the
            # rotation histogram (SearchByBoW(KF, KF), ORBmatcher.cc:≈550).
            mres = match_descriptors(desc_c, ok_c, desc_l, ok_l, pair_mask=pair_mask,
                                     max_dist=TH_LOW, ratio=ratio)
            rot_ok = rotation_consistency(m.kf_angle[kf_c], m.kf_angle[kf_l], mres.idx, mres.ok)
            mres = mres._replace(ok=mres.ok & rot_ok)
            # Distinct loop-side targets (several current features can claim
            # the same loop feature).
            N_l = desc_l.shape[0]
            distinct = ms.scatter_max(N_l, torch.where(mres.ok, mres.idx, N_l), 1).sum()
            pid_c = torch.where(m.kf_point[kf_c] >= 0, m.kf_point[kf_c], 0).long()
            pid_l_all = torch.where(m.kf_point[kf_l] >= 0, m.kf_point[kf_l], 0).long()
            pid_l = pid_l_all[mres.idx]
            pair_ok = mres.ok & m.pt_valid[pid_c] & m.pt_valid[pid_l]

            # Each side's map points in its own camera frame.
            p_c = se3_apply(m.kf_pose_cw[kf_c], m.pt_pos[pid_c])
            p_l = se3_apply(m.kf_pose_cw[kf_l], m.pt_pos[pid_l])
            lvl_c = torch.clamp(m.kf_level[kf_c], 0, L - 1).long()
            lvl_l = torch.clamp(m.kf_level[kf_l][mres.idx], 0, L - 1).long()
            rres = sim3_solve.sim3_ransac(
                p_c, p_l, pair_ok, 9.21 * self.sigma2[lvl_c], 7.78 * self.sigma2[lvl_l],
                self.cam, samples=self._ransac_samples(pair_ok, 128, 3),
                fix_scale=self.fix_scale, min_inliers=ransac_min,
            )
            S0 = sim3_to_mat(rres.R12, rres.t12, rres.s12)

            # SearchBySim3: more matches by mutual projection under S0
            # (ORBmatcher.cc:≈810), windows widened for a coarse seed.
            idx_l2, agree = search_by_sim3(m, kf_c, kf_l, S0, self.cam, self.scale_factors,
                                           radius_mult=sim3_radius_mult)
            # Union with the BoW matches: existing pairs first.
            use_new = agree & ~mres.ok
            idx_union = torch.where(use_new, idx_l2, mres.idx)
            ok_union = mres.ok | use_new
            pid_l_u = pid_l_all[idx_union]
            pair_ok_u = ok_union & m.pt_valid[pid_c] & m.pt_valid[pid_l_u]
            p_l_u = se3_apply(m.kf_pose_cw[kf_l], m.pt_pos[pid_l_u])
            lvl_l_u = torch.clamp(m.kf_level[kf_l][idx_union], 0, L - 1).long()
            seed_inliers = torch.where(use_new, pair_ok_u, rres.inliers & pair_ok_u)
            ores = optimize_sim3(
                S0, p_c, p_l_u, m.kf_xy[kf_c], m.kf_xy[kf_l][idx_union],
                self.inv_sigma2[lvl_c], self.inv_sigma2[lvl_l_u], seed_inliers, self.cam,
                fix_scale=self.fix_scale,
            )
            # The final false-positive gate (LoopClosing.cc:≈300): the loop
            # neighbourhood's points projected into the current keyframe
            # under the refined Sim3 must give >= 40 matches.
            loop_group = (ms.covisible_row(m, kf_l) > 0) | (
                torch.arange(m.kf_capacity, device=m.kf_valid.device) == kf_l)
            proj = project_loop_matches(m, kf_c, kf_l, loop_group, ores.S12, self.cam,
                                        self.scale_factors)
            # Polish the Sim3 on those (many more, better spread) matches.
            lvl_m = torch.clamp(m.kf_level[kf_c][proj.idx], 0, L - 1).long()
            S_ref = refine_sim3_on_projections(
                ores.S12, proj.p_l, m.kf_xy[kf_c][proj.idx], self.inv_sigma2[lvl_m], proj.ok,
                self.cam, fix_scale=self.fix_scale,
            )
            # THE one host read of the candidate's verification.
            return self._fetch([
                mres.ok.sum(), distinct, ok_c.sum(), ok_l.sum(), rres.ok, ores.n_inliers,
                proj.n_matches, S_ref, m.kf_pose_cw, m.kf_valid,
            ])

    def _apply_sim3_gates(self, m: ms.MapState, kf_c: int, kf_l: int, res,
                          min_bow: int = 20, min_distinct: int = 10):
        """The host gate chain over ``_sim3_pipeline``'s read (ComputeSim3's
        accept conditions and the odometry-consistency gate).  Returns S_CL
        (4x4 float32 numpy), or None."""
        (n_matches, n_distinct, n_bound_c, n_bound_l, ransac_ok,
         n_inliers, n_proj, S, poses, valid) = res

        def reject(stage):
            self.metrics[f"sim3_reject_{stage}"] = self.metrics.get(f"sim3_reject_{stage}", 0) + 1
            return None

        if int(n_matches) < min_bow or int(n_distinct) < min_distinct:
            self.metrics.setdefault("bow_match_counts", []).append(
                (int(n_matches), int(n_distinct), int(n_bound_c), int(n_bound_l),
                 int(kf_c), int(kf_l)))
            return reject("bow")
        if not bool(ransac_ok):
            self.metrics.setdefault("ransac_reject_detail", []).append(
                (int(n_matches), int(kf_c), int(kf_l)))
            return reject("ransac")
        if int(n_inliers) < 20:
            self.metrics.setdefault("opt_reject_detail", []).append(
                (int(n_matches), int(n_inliers), int(kf_c), int(kf_l)))
            return reject("opt")
        if int(n_proj) < 40:
            self.metrics.setdefault("proj_reject_detail", []).append(
                (int(n_inliers), int(n_proj), int(kf_c), int(kf_l)))
            return reject("proj")

        # Odometry consistency: the correction a loop applies is drift,
        # bounded by a fraction of the odometric path between the two
        # keyframes; a far larger one is perceptual aliasing.
        T_rel_est = poses[kf_c] @ np.linalg.inv(poses[kf_l])
        s_est = float(np.cbrt(max(np.linalg.det(S[:3, :3]), 1e-12)))
        D = S @ np.linalg.inv(T_rel_est)
        dt = float(np.linalg.norm(D[:3, 3]))
        Rd = D[:3, :3] / np.cbrt(max(np.linalg.det(D[:3, :3]), 1e-12))
        ang = float(np.degrees(np.arccos(np.clip((np.trace(Rd) - 1.0) / 2.0, -1.0, 1.0))))
        lo, hi = sorted((int(kf_l), int(kf_c)))
        ids = [k for k in range(lo, hi + 1) if valid[k]]
        centers = _camera_centers(poses, ids)
        path_len = float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
        max_dt = max(self.max_drift_frac * path_len, self.min_drift_abs)
        max_ang = max(20.0, 0.5 * len(ids))
        # With a baseline the scale is observable and stays near 1; mono
        # scale drift is what the free-scale path corrects.
        max_ds = (1.0 + self.max_drift_frac) if self.fix_scale else 4.0
        if dt > max_dt or ang > max_ang or not (1 / max_ds <= s_est <= max_ds):
            self.metrics.setdefault("odom_reject_detail", []).append(
                (round(dt, 3), round(max_dt, 3), round(ang, 1), round(max_ang, 1),
                 round(s_est, 3), round(max_ds, 3)))
            return reject("odom")
        return np.array(S)

    # ------------------------------------------------------------------

    def _correct_loop(self, m: ms.MapState, kf_c: int, kf_l: int,
                      S_CL_host: np.ndarray) -> ms.MapState:
        """CorrectLoop (≈330) with the verified S_CL (4x4 numpy).  Edge
        measurements come from the pre-correction poses (NonCorrectedSim3);
        the corrected Sim3 of the current covisible group only seeds the
        optimization."""
        dev = m.kf_valid.device
        S_CL = torch.from_numpy(np.asarray(S_CL_host, np.float32)).to(dev)
        K = m.kf_capacity
        ar = torch.arange(K, device=dev)
        with record_function(STAGE_PREFIX + "pose_graph"):
            T_old_all = m.kf_pose_cw
            # S_i_w = (T_i_w T_C_w^-1) S_CL T_L_w for the current group.
            S_Cw_corr = S_CL @ T_old_all[kf_l]
            W = ms.covisibility(m)
            group_mask = ((W[kf_c] > 0) | (ar == kf_c)) & m.kf_valid
            T_wC = se3_inverse(T_old_all[kf_c])
            S_seed = (T_old_all @ T_wC) @ S_Cw_corr
            init_S = torch.where(group_mask[:, None, None], S_seed, T_old_all)

            self.loop_edges.append((kf_l, kf_c, np.asarray(S_CL_host, np.float32)))
            loop_i = torch.tensor([e[0] for e in self.loop_edges], dtype=torch.int64, device=dev)
            loop_j = torch.tensor([e[1] for e in self.loop_edges], dtype=torch.int64, device=dev)
            loop_S = torch.from_numpy(np.stack([e[2] for e in self.loop_edges])).to(dev)
            loop_v = torch.ones(len(self.loop_edges), dtype=torch.bool, device=dev)
            edges = pg.edges_from_map(T_old_all, m.kf_valid, m.kf_parent, W,
                                      loop_i, loop_j, loop_S, loop_v, min_covis_weight=100)
            fixed = ar == kf_l
            T_new, scales = pg.optimize_essential_graph(
                T_old_all, m.kf_valid, edges, fixed, init_S_cw=init_S, iters=20,
                fix_scale=self.fix_scale)

            # Each map point follows its reference keyframe's old -> new
            # similarity (Optimizer.cc:≈1050).
            pt_ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
            p_cam = se3_apply(T_old_all[pt_ref], m.pt_pos) * scales[pt_ref][:, None]
            p_after = se3_apply(se3_inverse(T_new[pt_ref]), p_cam)
            m = m._replace(
                kf_pose_cw=torch.where(m.kf_valid[:, None, None], T_new, m.kf_pose_cw),
                pt_pos=torch.where(m.pt_valid[:, None], p_after, m.pt_pos),
            )

        with record_function(STAGE_PREFIX + "fuse"):
            # SearchAndFuse (LoopClosing.cc:≈470): rebind the current group's
            # observations to the loop side's points, so that BA has
            # constraints across the seam.
            loop_group = (W[kf_l] > 0) | (ar == kf_l)
            seen_by_loop = ms.points_seen_by(m, loop_group) & m.pt_valid
            _, cand_pids = topk_stable(seen_by_loop.to(torch.float32), 2048)
            cand_valid = seen_by_loop[cand_pids]
            group_ids = np.nonzero(self._fetch([group_mask])[0])[0]
            for gk in group_ids[:12]:
                m = _fuse_into_keyframe(m, int(gk), cand_pids, cand_valid, self.cam,
                                        self.scale_factors)

        if self.enable_gba:
            m = self._run_gba(m)
        with record_function(STAGE_PREFIX + "point_stats"):
            m = ms.update_point_stats(m, self.scale_factors)
            # After update_point_stats, whose reference-keyframe descriptor
            # must give way to the min-median-Hamming one (MapPoint.cc:≈260).
            m = ms.compute_distinctive_descriptors(m)
        return m

    def _run_gba(self, m: ms.MapState) -> ms.MapState:
        """The configured GBA mode in segments, with an abort check between
        them (the reference's mbStopGBA).  "joint": (5 robust), (5 plain),
        (5 plain) Schur segments, the first with a 6x chi2 initial prune;
        beyond the camera cap, 3 alternation segments of 2 rounds.  Each
        segment's result is kept only if every loop edge stays closed
        (``loop_edges_still_closed``) and keyframe centres move by less than
        a fraction of the median baseline; otherwise GBA stops there.  Each
        guard reads the poses and validity once."""
        abort = self._abort

        def aborted():
            return abort is not None and abort.is_set()

        poses0, valid0 = self._fetch([m.kf_pose_cw, m.kf_valid])
        ids = np.nonzero(valid0)[0]
        if len(ids) >= 2:
            scene_scale = float(np.median(np.linalg.norm(
                np.diff(_camera_centers(poses0, ids), axis=0), axis=1)))
        else:
            scene_scale = 1.0
        res0 = loop_edge_residuals(poses0, self.loop_edges)

        def guards_ok(mm):
            poses1, valid1 = self._fetch([mm.kf_pose_cw, mm.kf_valid])
            if not loop_edges_still_closed(res0, loop_edge_residuals(poses1, self.loop_edges),
                                           scene_scale=scene_scale):
                return False
            ids_b = np.nonzero(valid0 & valid1)[0]
            if len(ids_b) == 0:
                return True
            disp = np.linalg.norm(_camera_centers(poses1, ids_b)
                                  - _camera_centers(poses0, ids_b), axis=1)
            return (float(np.median(disp)) <= 0.3 * scene_scale
                    and float(np.quantile(disp, 0.9)) <= 1.0 * scene_scale)

        def rejected():
            self.metrics["gba_rejected_segments"] = self.metrics.get(
                "gba_rejected_segments", 0) + 1

        if self.gba_mode == "joint":
            ran = False
            for k, seg in enumerate(((5, 0), (0, 5), (0, 5))):
                if aborted():
                    return m
                with record_function(STAGE_PREFIX + f"gba_segment{k}"):
                    self.host_syncs += 1  # run_joint_global_ba's validity read
                    m2 = run_joint_global_ba(m, self.cam, self.inv_sigma2, phase_iters=seg,
                                             initial_prune=6.0 if k == 0 else 0.0)
                    if m2 is m:  # beyond the camera cap: the alternation instead
                        break
                    if not guards_ok(m2):
                        rejected()
                        return m
                m, ran = m2, True
            if ran:
                return m
        for k in range(3):
            if aborted():
                return m
            with record_function(STAGE_PREFIX + f"gba_alternation{k}"):
                self.host_syncs += 1  # global_bundle_adjustment's plan
                m2 = global_bundle_adjustment(m, self.cam, self.inv_sigma2, rounds=2)
                if not guards_ok(m2):
                    rejected()
                    return m
            m = m2
        return m


# ---------------------------------------------------------------------------
# SearchAndFuse (LoopClosing.cc:≈470)
# ---------------------------------------------------------------------------


def _project_uv(cam: CameraModel, p_c: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(p_c[..., 2], min=1e-6)
    return torch.stack([cam.fx * p_c[..., 0] / z + cam.cx, cam.fy * p_c[..., 1] / z + cam.cy],
                       -1)


def _in_view(cam: CameraModel, z: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    return ((z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))


def _fuse_into_keyframe(
    m: ms.MapState,
    kf_id: int,
    cand_pids: torch.Tensor,    # (L,) loop-side point ids
    cand_valid: torch.Tensor,   # (L,)
    cam: CameraModel,
    scale_factors: torch.Tensor,
) -> ms.MapState:
    """Project loop-side points into one (corrected) keyframe and rebind
    the matching keypoint slots to them.  A slot bound to a different
    point gets the reference's full MapPoint::Replace (every observation
    of the duplicate rebound, the loop-side point survives); unbound slots
    are bound."""
    T = m.kf_pose_cw[kf_id]
    p_w = m.pt_pos[cand_pids]
    p_c = se3_apply(T, p_w)
    uv = _project_uv(cam, p_c)
    O_w = -(T[:3, :3].T @ T[:3, 3])
    dist = torch.linalg.norm(p_w - O_w, dim=-1)
    vis = cand_valid & m.pt_valid[cand_pids] & _in_view(cam, p_c[:, 2], uv)
    pred_level = ms.predict_scale(dist, m.pt_max_dist[cand_pids], scale_factors)
    d2 = ((uv[:, None, :] - m.kf_xy[kf_id][None, :, :]) ** 2).sum(-1)
    rr = (4.0 * scale_factors[pred_level]) ** 2
    lvl_ok = (m.kf_level[kf_id][None, :] - pred_level[:, None]).abs() <= 1
    mres = match_descriptors(
        m.pt_desc[cand_pids], vis, m.kf_desc[kf_id], m.kf_kp_valid[kf_id],
        pair_mask=(d2 <= rr[:, None]) & lvl_ok, max_dist=TH_LOW, ratio=1.0,
    )
    row = m.kf_point[kf_id]
    tgt = torch.where(mres.ok, mres.idx, 0)
    incoming = ms.scatter_last(torch.full_like(row, ms.NO_POINT), tgt,
                               torch.where(mres.ok, cand_pids, ms.NO_POINT).to(row.dtype))
    dup = (incoming >= 0) & (row >= 0) & (row != incoming)
    m = ms.apply_point_replacements(m, torch.where(dup, row, -1), incoming, dup)
    row2 = m.kf_point[kf_id]
    row_new = torch.where((row2 < 0) & (incoming >= 0), incoming, row2)
    kf_point = m.kf_point.clone()
    kf_point[kf_id] = row_new
    return m._replace(kf_point=kf_point)


# ---------------------------------------------------------------------------
# The loop neighbourhood's projection count (SearchByProjection with Scw,
# ORBmatcher.cc:≈160, LoopClosing::ComputeSim3's >= 40 gate)
# ---------------------------------------------------------------------------


class LoopProjMatches(NamedTuple):
    n_matches: torch.Tensor  # 0-d int
    p_l: torch.Tensor        # (L, 3) candidate points in the LOOP camera frame
    idx: torch.Tensor        # (L,) matched current-KF keypoint slot
    ok: torch.Tensor         # (L,)


def project_loop_matches(
    m: ms.MapState,
    kf_c: int,
    kf_l: int,
    loop_group: torch.Tensor,   # (K,) bool: the loop KF's covisible group
    S_CL: torch.Tensor,         # Sim3 current cam <- loop cam (4x4, sR | t)
    cam: CameraModel,
    scale_factors: torch.Tensor,
    n_cand: int = 2048,
) -> LoopProjMatches:
    """Match current-KF keypoints by projecting ``n_cand`` points seen by
    the loop KF's covisible group into the current image under S_CL
    (window 10 x the predicted level's scale, TH_LOW)."""
    seen = ms.points_seen_by(m, loop_group) & m.pt_valid
    _, pids = topk_stable(seen.to(torch.float32), n_cand)
    vis0 = seen[pids]
    p_l = se3_apply(m.kf_pose_cw[kf_l], m.pt_pos[pids])
    p_c = sim3_apply(S_CL, p_l)
    uv = _project_uv(cam, p_c)
    vis = vis0 & _in_view(cam, p_c[:, 2], uv)
    T_l = m.kf_pose_cw[kf_l]
    O_l = -(T_l[:3, :3].T @ T_l[:3, 3])
    dist = torch.linalg.norm(m.pt_pos[pids] - O_l, dim=-1)
    pred_level = ms.predict_scale(dist, m.pt_max_dist[pids], scale_factors)
    d2 = ((uv[:, None, :] - m.kf_xy[kf_c][None, :, :]) ** 2).sum(-1)
    rr = (10.0 * scale_factors[pred_level]) ** 2
    mres = match_descriptors(
        m.pt_desc[pids], vis, m.kf_desc[kf_c], m.kf_kp_valid[kf_c],
        pair_mask=d2 <= rr[:, None], max_dist=TH_LOW, ratio=1.0,
    )
    return LoopProjMatches(n_matches=mres.ok.sum(), p_l=p_l, idx=mres.idx, ok=mres.ok)


def refine_sim3_on_projections(
    S0: torch.Tensor,
    p_l: torch.Tensor,         # (L, 3) loop-camera-frame points
    uv_c: torch.Tensor,        # (L, 2) matched current-image keypoints
    inv_sigma2: torch.Tensor,  # (L,)
    valid: torch.Tensor,       # (L,)
    cam: CameraModel,
    fix_scale: bool = False,
    n_iters: int = 10,
) -> torch.Tensor:
    """One-directional Sim3 polish on the neighbourhood projection matches:
    Huber-weighted LM on the 7-dim tangent (scale frozen when
    ``fix_scale``), Jacobians in forward mode, every step on the device."""
    dev = p_l.device
    keep = scale_keep(fix_scale, dev)
    zero7 = torch.zeros(7, dtype=torch.float32, device=dev)
    w_obs = inv_sigma2 * valid.to(torch.float32)
    sqrt_w = torch.sqrt(w_obs)
    delta_h = CHI2_LOOP_REFINE ** 0.5

    def residual(xi, S):  # xi (..., 7) -> (..., L, 2)
        Sx = (sim3_exp(xi * keep) @ S)[..., None, :, :]
        return _project_uv(cam, sim3_apply(Sx, p_l)) - uv_c

    def weighted_err(S):
        r = residual(zero7, S)
        r2 = (r * r).sum(-1)
        rn = torch.sqrt(r2 * inv_sigma2 + 1e-12)
        wh = torch.clamp(delta_h / torch.clamp(rn, min=1e-12), max=1.0)
        return (w_obs * wh * r2).sum()

    S = S0
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        def flat(xi):
            r = residual(xi, S) * sqrt_w[:, None]
            return r.reshape(r.shape[:-2] + (-1,))

        r0, J = jacfwd_batched(flat, (zero7,), 0)
        rn = torch.sqrt((r0.view(-1, 2) ** 2).sum(-1) + 1e-12)
        wh = torch.sqrt(torch.clamp(delta_h / torch.clamp(rn, min=1e-12), max=1.0))
        r0 = (r0.view(-1, 2) * wh[:, None]).reshape(-1)
        J = (J.view(-1, 2, 7) * wh[:, None, None]).reshape(-1, 7)
        S_new = sim3_exp(lm_solve7(J, r0, lam) * keep) @ S
        accept = weighted_err(S_new) < weighted_err(S)
        S = torch.where(accept, S_new, S)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e3)
    return S


# ---------------------------------------------------------------------------
# SearchBySim3 (ORBmatcher::SearchBySim3, src/ORBmatcher.cc:≈810)
# ---------------------------------------------------------------------------


def search_by_sim3(
    m: ms.MapState,
    kf_c: int,
    kf_l: int,
    S_CL: torch.Tensor,
    cam: CameraModel,
    scale_factors: torch.Tensor,
    radius_mult: float = 1.0,
):
    """Bidirectional projection matching under a Sim3 estimate: the loop
    KF's bound points projected into the current image via S_CL, the
    current KF's into the loop image via S_CL^-1 (window 7 x radius_mult x
    the keypoint level's scale, TH_HIGH); pairs that agree both ways are
    kept.  Returns (idx (N,), agree (N,)): per current slot, its loop
    slot."""
    L = scale_factors.shape[0]

    def project_pts(S_ab, kf_b):
        # Points bound in kf_b, in kf_b's camera, mapped into kf_a's camera
        # by S_ab and projected into kf_a's image.
        pts_b = m.kf_point[kf_b]
        ok_b = (pts_b >= 0) & m.kf_kp_valid[kf_b] & m.pt_valid[pts_b.clamp(min=0).long()]
        pid = torch.where(ok_b, pts_b, 0).long()
        p_cam_a = sim3_apply(S_ab, se3_apply(m.kf_pose_cw[kf_b], m.pt_pos[pid]))
        uv = _project_uv(cam, p_cam_a)
        return uv, ok_b & _in_view(cam, p_cam_a[:, 2], uv)

    def one_way(S_ab, kf_a, kf_b):
        uv, vis = project_pts(S_ab, kf_b)
        r = 7.0 * radius_mult * scale_factors[torch.clamp(m.kf_level[kf_b], 0, L - 1).long()]
        d2 = ((uv[:, None, :] - m.kf_xy[kf_a][None, :, :]) ** 2).sum(-1)
        return match_descriptors(m.kf_desc[kf_b], vis, m.kf_desc[kf_a], m.kf_kp_valid[kf_a],
                                 pair_mask=d2 <= (r[:, None] ** 2), max_dist=TH_HIGH, ratio=1.0)

    m1 = one_way(S_CL, kf_c, kf_l)                     # loop -> current
    m2 = one_way(sim3_inverse_mat(S_CL), kf_l, kf_c)   # current -> loop
    # Keep current slot i where loop slot m2.idx[i] matched back to i.
    j = torch.where(m2.ok, m2.idx, 0)
    agree = m2.ok & m1.ok[j] & (m1.idx[j] == torch.arange(m2.idx.shape[0], device=j.device))
    return m2.idx, agree
