"""Loop closing: detection, Sim3 estimation, correction, essential graph,
global BA.

Port of orb_slam2_map_tpu/slam/loop_closing.py, replacing the
reference's LoopClosing thread (reference: src/LoopClosing.cc): BoW loop
detection with covisibility-consistency voting (3 consecutive, :43),
Sim3 RANSAC + refinement (:232-401), loop correction by Sim3 propagation
to the covisibility neighbourhood + point re-mapping + fusion
(:403-583), essential-graph optimization (src/Optimizer.cc:781), and a
global BA, synchronous or on a background worker with staged write-back
(:643-744).

The Sim3 stages run on the closer's device: the descriptor match of the
two keyframes' map-point-bound keypoints is one gated-NN kernel launch
(csrc/gated_nn.cu) with the dense gate has1 x has2, SearchBySim3 two
more, the projection widen and SearchAndFuse one per keyframe. The
bookkeeping is the JAX package's, host numpy.

Not ported: the JAX package's compile warm-up (prewarm, maybe_prewarm,
the power-of-two pose-graph buckets): PyTorch compiles nothing, and the
essential graph is solved at its exact size. Its multi-device
essential-graph branch waits for the multi-device slice (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..ops import matching
from ..optim import pose_graph, sim3_solver
from ..optim.global_ba import run_global_ba
from ..utils import profiling
from ..utils.device import default_device, host_tensor
from . import mapping_kernels
from .mapstore import MapStore


@dataclass
class _PairSnapshot:
    """Copies of the map rows the Sim3 computation reads, taken under the
    map lock so that the RANSAC/optimization stages can run without it
    (the reference likewise runs ComputeSim3 concurrently with
    LocalMapping, blocking only in CorrectLoop, src/LoopClosing.cc:
    403-427)."""

    kid: int
    cand: int
    obs2: np.ndarray         # loop-KF keypoint -> map point id
    has1: np.ndarray
    has2: np.ndarray
    desc1: np.ndarray
    desc2: np.ndarray
    level1: np.ndarray
    level2: np.ndarray
    xy1: np.ndarray
    xy2: np.ndarray
    Xc1_all: np.ndarray      # per-keypoint camera-frame point coords
    Xc2_all: np.ndarray
    min_dist1: np.ndarray
    max_dist1: np.ndarray
    min_dist2: np.ndarray
    max_dist2: np.ndarray


class LoopCloser:
    # caps of the Sim3 stages' match sets; overflows are counted and
    # logged, never silently dropped
    SIM3_RANSAC_PAD = 256
    SIM3_OPT_PAD = 512

    def __init__(self, cfg: SystemConfig, map_store: MapStore, place_db,
                 fix_scale: bool = True, run_global_ba: bool = True,
                 device=None):
        self.cfg = cfg
        self.map = map_store
        self.db = place_db
        self.fix_scale = fix_scale
        self.run_global_ba_flag = run_global_ba
        self.device = default_device(device)
        self.background_gba = None   # a parallel.background.BackgroundGBA
                                     # to run GBA off-thread
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        # (query kid, candidate covis group) of recently FAILED Sim3
        # attempts: the same candidate region re-fires on consecutive
        # keyframes; back off for a couple of keyframes before retrying it
        self._failed_sim3: List[Tuple[int, Set[int]]] = []
        self._empty_detect_rounds = 0
        self._last_periodic_gba_kid = 0
        self.last_loop_kf = 0
        self.loop_detected = False   # consumed by dense mapping rebuild
        self.n_loops_closed = 0
        self.n_sim3_attempts = 0     # Sim3 computations started
        self.closures: List[Tuple[int, int]] = []   # (query, loop) KFs
        # map lock for concurrent operation (a context manager): held for
        # detection, the input snapshot and the correction write-back,
        # not for the Sim3 RANSAC / widening / optimization
        self.lock = contextlib.nullcontext()
        # truncation counters: bumped when the Sim3 caps drop matches
        self.n_ransac_pad_truncations = 0
        self.n_opt_pad_truncations = 0
        # map-transform listeners: called (under the map lock) with the
        # 4x4 world-space SE3 `A` that the tracker's neighbourhood just
        # moved by (X_new = A @ X_old) whenever a loop correction or GBA
        # merge moves the map; consumers transform their cached poses
        # Tcw_new = Tcw_old @ A^-1 (Tracker.apply_map_transform)
        self.transform_listeners = []

    def _notify_transform(self, A: np.ndarray):
        if float(np.abs(A - np.eye(4)).max()) < 1e-9:
            return
        for fn in self.transform_listeners:
            fn(A)

    def enable_background_gba(self):
        """Run post-loop global BA on a worker with staged write-back
        (reference: src/LoopClosing.cc:571-575). The map owner must call
        poll_background() regularly to merge finished results."""
        from ..parallel.background import BackgroundGBA

        self.background_gba = BackgroundGBA(self.cfg, self.map,
                                            device=self.device)
        self.background_gba.on_transform = self._notify_transform
        return self.background_gba

    def poll_background(self) -> bool:
        if self.background_gba is not None:
            return self.background_gba.poll()
        return False

    # ------------------------------------------------------------------

    def process_keyframe(self, kid: int):
        """Detect + close a loop for one keyframe (reference:
        src/LoopClosing.cc:58-89 Run): detection and the input snapshot
        hold the map lock briefly, the Sim3 compute runs without it, the
        correction write-back takes it again."""
        with self.lock:
            self.db.maybe_refresh()
            cands = self._detect_loop(kid)
            if len(cands) == 0:
                self._maybe_periodic_gba(kid)
        if len(cands) == 0:
            return
        if self._compute_sim3_and_correct(kid, cands):
            self.last_loop_kf = kid
            self.n_loops_closed += 1
            self.loop_detected = True

    def _maybe_periodic_gba(self, kid: int):
        """Re-launch the background global BA every
        cfg.loop_closing.periodic_gba_kfs keyframes (0 = off, the
        default). The caller holds the map lock."""
        n = self.cfg.loop_closing.periodic_gba_kfs
        if (n <= 0 or self.background_gba is None
                or self.background_gba.running()
                or kid - self._last_periodic_gba_kid < n
                or self.map.n_keyframes() < 4):
            return
        with profiling.stage("loop_closing/periodic_gba_launch"):
            if self.background_gba.launch(iters=40):
                self._last_periodic_gba_kid = kid

    # ------------------------------------------------------------------

    def _detect_loop(self, kid: int) -> List[int]:
        """(reference: src/LoopClosing.cc:104-230)."""
        lcfg = self.cfg.loop_closing
        if self.map.n_keyframes() < lcfg.min_kfs_since_last_loop:
            return []
        if kid - self.last_loop_kf < lcfg.min_kfs_since_last_loop \
                and self.last_loop_kf > 0:
            return []
        min_score = self.db.min_score_vs_neighbors(kid)
        cands = self.db.detect_loop_candidates(kid, max(min_score, 0.01))
        if len(cands) > 0:
            # temporal gate: a loop is a revisit — candidates closer than
            # min_candidate_gap_frames are adjacent-segment reconnections
            gap = self.map.kf_frame_id[kid] - self.map.kf_frame_id[cands]
            cands = cands[gap >= lcfg.min_candidate_gap_frames]
        if len(cands) == 0:
            # deviation kept from the JAX package (the reference clears
            # the consistency groups on any empty round,
            # src/LoopClosing.cc:224-228): the chain survives exactly one
            # empty round
            if self._empty_detect_rounds == 0 and self.consistent_groups:
                self._empty_detect_rounds = 1
            else:
                self.consistent_groups = []
                self._empty_detect_rounds = 0
            return []
        self._empty_detect_rounds = 0

        # covisibility-consistency voting (:153-212)
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for c in cands:
            group = set(self.map.covisible_keyframes(int(c)).tolist())
            group.add(int(c))
            best_count = 0
            matched_any = False
            for prev_set, count in self.consistent_groups:
                if group & prev_set:
                    matched_any = True
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count if matched_any else 0))
            if best_count >= lcfg.covisibility_consistency_th:
                enough.append(int(c))
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------

    def _compute_sim3_and_correct(self, kid: int, cands: List[int]) -> bool:
        """(reference: src/LoopClosing.cc:232-401 + :403-583): BoW match ->
        Sim3 RANSAC -> SearchBySim3 widening -> Sim3 optimization ->
        projection widen with the loop neighbourhood's points, accepted
        only at >= sim3_min_total_matches total."""
        self._failed_sim3 = [(k, g) for k, g in self._failed_sim3
                             if kid - k <= 2]
        for cand in cands:
            cand_group = set(
                self.map.covisible_keyframes(int(cand)).tolist())
            cand_group.add(int(cand))
            if any(cand_group & g for _, g in self._failed_sim3):
                continue   # this region just failed; retry in >= 2 KFs
            with self.lock:
                snap = self._snapshot_pair(kid, int(cand))
            self.n_sim3_attempts += 1
            with profiling.stage("loop_closing/sim3_compute"):
                hyp = self._compute_sim3(snap)
            if hyp is None:
                self._failed_sim3.append((kid, cand_group))
                continue
            S12, mkp, mmp = hyp
            loop_points = self._loop_neighborhood_points(int(cand))
            alive = self.map.mp_exists[np.clip(mmp, 0, None)] & (mmp >= 0)
            mkp, mmp = mkp[alive], mmp[alive]
            with profiling.stage("loop_closing/widen"):
                mkp, mmp = self._widen_with_loop_points(
                    kid, int(cand), S12, loop_points, mkp, mmp)
            if len(mkp) < self.cfg.loop_closing.sim3_min_total_matches:
                continue
            # abort a stale background GBA before taking the map lock
            # (reference: src/LoopClosing.cc:409-427)
            if (self.run_global_ba_flag and self.background_gba is not None
                    and self.background_gba.running()):
                self.background_gba.abort()
                self.background_gba.wait(timeout=60.0)
            with self.lock:
                with profiling.stage("loop_closing/correct"):
                    if self._finalize_and_correct(kid, int(cand), S12,
                                                  loop_points, mkp, mmp):
                        self.closures.append((kid, int(cand)))
                        return True
        return False

    def _snapshot_pair(self, kid: int, cand: int) -> _PairSnapshot:
        """Copy the rows the Sim3 compute reads."""
        m = self.map
        obs1 = m.kf_obs[kid].copy()
        obs2 = m.kf_obs[cand].copy()
        has1 = (obs1 >= 0) & m.mp_exists[np.clip(obs1, 0, None)]
        has2 = (obs2 >= 0) & m.mp_exists[np.clip(obs2, 0, None)]
        R1, t1 = m.kf_R[kid], m.kf_t[kid]
        R2, t2 = m.kf_R[cand], m.kf_t[cand]
        mid1 = np.clip(obs1, 0, None)
        mid2 = np.clip(obs2, 0, None)
        return _PairSnapshot(
            kid=kid, cand=cand, obs2=obs2, has1=has1, has2=has2,
            desc1=m.kf_desc[kid].copy(), desc2=m.kf_desc[cand].copy(),
            level1=m.kf_level[kid].copy(), level2=m.kf_level[cand].copy(),
            xy1=m.kf_xy[kid].copy(), xy2=m.kf_xy[cand].copy(),
            Xc1_all=(m.mp_pos[mid1] @ R1.T + t1).astype(np.float32),
            Xc2_all=(m.mp_pos[mid2] @ R2.T + t2).astype(np.float32),
            min_dist1=m.mp_min_dist[mid1].copy(),
            max_dist1=m.mp_max_dist[mid1].copy(),
            min_dist2=m.mp_min_dist[mid2].copy(),
            max_dist2=m.mp_max_dist[mid2].copy())

    def _dev(self, a, dtype=torch.float32):
        return host_tensor(a, self.device, dtype)

    def _bow_match(self, s: _PairSnapshot):
        """Descriptor match between the two keyframes' map-point-bound
        keypoints: one gated-NN launch with the host-built gate
        has1 x has2, ratio 0.75, duplicates resolved. Returns the matched
        (rows of KF1, cols of KF2)."""
        gate = self._dev(s.has1[:, None] & s.has2[None, :], torch.bool)
        res = matching.gated_nn(self._dev(s.desc1), self._dev(s.desc2), gate,
                                max_dist=50.0, ratio=0.75)
        keep = matching.resolve_duplicates(res.idx, res.dist, res.ok,
                                           self.map.N).cpu().numpy()
        rows = np.nonzero(keep)[0]
        return rows, res.idx.cpu().numpy()[rows]

    def _truncate(self, what: str, n: int, cap: int, kid: int, cand: int):
        print(f"[loop_closing] Sim3 {what} cap: {n} matches > {cap} "
              f"(KF {kid} vs {cand}); keeping the first {cap}",
              file=sys.stderr)
        profiling.PROFILER.add_sample(f"loop_closing/sim3_{what}_truncated",
                                      float(n - cap))

    def _compute_sim3(self, s: _PairSnapshot, idx=None):
        """Sim3 hypothesis for a `_PairSnapshot`, computed without the map
        lock. Returns (S12, mkp, mmp) — the optimized current->loop Sim3
        plus the matched (current keypoint, loop map point) pairs — or
        None. `idx` [256, 3], when given, replaces the RANSAC's own draws
        (rows of the capped BoW match set)."""
        lcfg = self.cfg.loop_closing
        sigma2 = np.asarray(self.cfg.orb.level_sigma2, dtype=np.float32)
        kid, cand = s.kid, s.cand

        with profiling.stage("loop_closing/sim3_bow_match"):
            rows, cols = self._bow_match(s)
        if len(rows) < lcfg.sim3_min_bow_matches:
            return None
        cap = self.SIM3_RANSAC_PAD
        if len(rows) > cap:
            self.n_ransac_pad_truncations += 1
            self._truncate("ransac", len(rows), cap, kid, cand)
        rows_r, cols_r = rows[:cap], cols[:cap]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(kid))
        with profiling.stage("loop_closing/sim3_ransac"):
            rr = sim3_solver.sim3_ransac(
                self.cfg.camera, self._dev(s.Xc1_all[rows_r]),
                self._dev(s.Xc2_all[cols_r]),
                self._dev(sigma2[s.level1[rows_r]]),
                self._dev(sigma2[s.level2[cols_r]]),
                torch.ones(len(rows_r), dtype=torch.bool, device=self.device),
                generator=gen, n_hypotheses=256, fix_scale=self.fix_scale,
                min_inliers=lcfg.sim3_ransac_min_inliers,
                idx=None if idx is None else self._dev(idx, torch.int64))
            if not bool(rr.ok):
                return None

        # SearchBySim3 widening (reference: src/LoopClosing.cc:324 +
        # src/ORBmatcher.cc:1102-1326): mutual Sim3-guided projection
        # matches for keypoints outside the RANSAC-inlier set
        inl_mask = rr.inliers.cpu().numpy()
        rows_i, cols_i = rows_r[inl_mask], cols_r[inl_mask]
        already1 = np.zeros(self.map.N, bool)
        already2 = np.zeros(self.map.N, bool)
        already1[rows_i] = True
        already2[cols_i] = True
        b, i32 = torch.bool, torch.int32
        with profiling.stage("loop_closing/sim3_search"):
            wid = mapping_kernels.search_by_sim3(
                self.cfg, rr.R, rr.t, rr.s,
                self._dev(s.Xc1_all), self._dev(s.has1, b),
                self._dev(s.desc1), self._dev(s.level1, i32),
                self._dev(s.min_dist1), self._dev(s.max_dist1),
                self._dev(s.xy1), self._dev(already1, b),
                self._dev(s.Xc2_all), self._dev(s.has2, b),
                self._dev(s.desc2), self._dev(s.level2, i32),
                self._dev(s.min_dist2), self._dev(s.max_dist2),
                self._dev(s.xy2), self._dev(already2, b))
            w_ok, w_m12 = wid.ok.cpu().numpy(), wid.match12.cpu().numpy()
        w_rows = np.nonzero(w_ok)[0]

        # combined correspondence set -> Sim3 optimization (the reference
        # runs OptimizeSim3 over the widened vpMapPointMatches)
        a_rows = np.concatenate([rows_i, w_rows])
        a_cols = np.concatenate([cols_i, w_m12[w_rows]])
        cap = self.SIM3_OPT_PAD
        if len(a_rows) > cap:
            self.n_opt_pad_truncations += 1
            self._truncate("opt", len(a_rows), cap, kid, cand)
        a_rows, a_cols = a_rows[:cap], a_cols[:cap]
        with profiling.stage("loop_closing/sim3_optimize"):
            so = sim3_solver.optimize_sim3(
                self.cfg.camera, rr.R, rr.t, rr.s,
                self._dev(s.Xc1_all[a_rows]), self._dev(s.Xc2_all[a_cols]),
                self._dev(s.xy1[a_rows]), self._dev(s.xy2[a_cols]),
                self._dev(1.0 / sigma2[s.level1[a_rows]]),
                self._dev(1.0 / sigma2[s.level2[a_cols]]),
                torch.ones(len(a_rows), dtype=torch.bool, device=self.device),
                self.fix_scale)
            if int(so.n_inliers) < lcfg.sim3_min_opt_inliers:
                return None
        S12 = (so.R.cpu().numpy(), so.t.cpu().numpy(), float(so.s))

        # current-KF matched points after optimization (the reference's
        # mvpCurrentMatchedPoints): kp -> loop map point
        opt_inl = so.inliers.cpu().numpy()
        return S12, a_rows[opt_inl], s.obs2[a_cols[opt_inl]]

    def _finalize_and_correct(self, kid: int, cand: int, S12,
                              loop_points: np.ndarray,
                              mkp: np.ndarray, mmp: np.ndarray) -> bool:
        """Under the map lock: revalidate the hypothesis and the widened
        matches against the live map, re-apply the >= 40 total-matches
        gate (reference: src/LoopClosing.cc:340-395), then correct."""
        m = self.map
        if not (m.kf_exists[kid] and m.kf_exists[cand]):
            return False
        alive = m.mp_exists[np.clip(mmp, 0, None)] & (mmp >= 0)
        mkp, mmp = mkp[alive], mmp[alive]
        if len(mkp) < self.cfg.loop_closing.sim3_min_total_matches:
            return False
        if self.background_gba is not None:
            # a completed GBA staged on pre-correction poses must never
            # merge after this correction (it would undo it)
            self.background_gba.discard_staged()
        Tcw_old = m.kf_Tcw(kid)
        self._correct_loop(kid, cand, S12, loop_points, mkp, mmp)
        # the net world-space motion of the tracker's neighbourhood
        # (Sim3 propagation + essential graph), anchored at the current
        # KF: X_new = A @ X_old
        self._notify_transform(m.kf_Twc(kid) @ Tcw_old)
        return True

    def _loop_neighborhood_points(self, loop_kf: int) -> np.ndarray:
        """Map points seen by the loop KF + its covisible neighbours
        (reference mvpLoopMapPoints, src/LoopClosing.cc:340-358)."""
        m = self.map
        hood = [loop_kf] + m.covisible_keyframes(loop_kf).tolist()
        pts = [m.kf_obs[i][m.kf_obs[i] >= 0] for i in hood]
        if not pts:
            return np.asarray([], dtype=np.int64)
        pts = np.unique(np.concatenate(pts))
        return pts[m.mp_exists[pts]]

    def _widen_with_loop_points(self, kid: int, loop_kf: int, S12,
                                loop_points: np.ndarray,
                                mkp: np.ndarray, mmp: np.ndarray):
        """SearchByProjection with Scw at th=10 (reference:
        src/LoopClosing.cc:376-386 + src/ORBmatcher.cc:290-403): project
        the loop neighbourhood's points into the current KF with the
        corrected Sim3 and add matches on still-free keypoints."""
        m = self.map
        R12, t12, s12 = S12
        # Scw = S12 o T_loop_w, normalized to SE3 (R, t/s) as the
        # reference decomposes Scw before projecting
        R_scw = R12 @ m.kf_R[loop_kf]
        t_scw = s12 * (R12 @ m.kf_t[loop_kf]) + t12
        cand_pts = loop_points[~np.isin(loop_points, mmp)]
        if len(cand_pts) == 0:
            return mkp, mmp
        kp_free = m.kf_kp_valid[kid].copy()
        kp_free[mkp] = False
        b = torch.bool
        res = mapping_kernels.fuse_match(
            self.cfg, self._dev(R_scw), self._dev(t_scw / max(s12, 1e-12)),
            self._dev(m.mp_pos[cand_pts]), self._dev(m.mp_desc[cand_pts]),
            self._dev(m.mp_min_dist[cand_pts]),
            self._dev(m.mp_max_dist[cand_pts]),
            torch.ones(len(cand_pts), dtype=b, device=self.device),
            self._dev(m.kf_xy[kid]), self._dev(m.kf_level[kid], torch.int32),
            self._dev(kp_free, b), self._dev(m.kf_desc[kid]), 10.0)
        ok = res.ok.cpu().numpy()
        return (np.concatenate([mkp, res.kp_idx.cpu().numpy()[ok]]),
                np.concatenate([mmp, cand_pts[ok]]))

    # ------------------------------------------------------------------

    def _correct_loop(self, kid: int, loop_kf: int, S12,
                      loop_points: Optional[np.ndarray] = None,
                      mkp: Optional[np.ndarray] = None,
                      mmp: Optional[np.ndarray] = None):
        """(reference: src/LoopClosing.cc:403-583). S12 maps loop-KF
        camera coords into current-KF camera coords. mkp/mmp are the
        matched (current-KF keypoint, loop map point) pairs of
        ComputeSim3's widening (mvpCurrentMatchedPoints). Host numpy: 3x3
        composes in a Python loop."""
        from .local_mapping import LocalMapper

        m = self.map
        R12, t12, s12 = S12

        # corrected pose of the current KF: S_cw = S12 * S_loop_w
        R_lw, t_lw = m.kf_R[loop_kf], m.kf_t[loop_kf]
        R_cw_corr = np.asarray(R12) @ R_lw
        t_cw_corr = float(s12) * (np.asarray(R12) @ t_lw) + np.asarray(t12)
        s_cw_corr = float(s12)

        # pre-correction poses: essential-graph edges are measured with
        # the uncorrected odometry (reference NonCorrectedSim3,
        # src/LoopClosing.cc:445-470 + src/Optimizer.cc:849-947)
        R_pre = m.kf_R.copy()
        t_pre = m.kf_t.copy()

        # the current KF's neighbourhood gets Sim3-propagated corrections
        neighborhood = [kid] + m.covisible_keyframes(kid).tolist()
        R_cw_old, t_cw_old = m.kf_R[kid].copy(), m.kf_t[kid].copy()
        corrected: dict = {}
        for i in neighborhood:
            R_iw, t_iw = m.kf_R[i], m.kf_t[i]
            # S_ic = T_iw * T_wc_old; corrected S_iw = S_ic * S_cw_corr
            R_ic = R_iw @ R_cw_old.T
            t_ic = t_iw - R_ic @ t_cw_old
            corrected[int(i)] = ((R_ic @ R_cw_corr).astype(np.float32),
                                 (R_ic @ t_cw_corr + t_ic).astype(np.float32),
                                 float(s_cw_corr))

        # re-map the neighbourhood's points: X' = S_wi_new(S_iw_old(X))
        moved = np.zeros(m.M, dtype=bool)
        for i, (Rn, tn, sn) in corrected.items():
            obs = m.kf_obs[i]
            mids = np.unique(obs[obs >= 0])
            mids = mids[m.mp_exists[mids] & ~moved[mids]]
            if len(mids) == 0:
                continue
            Xc = m.mp_pos[mids] @ m.kf_R[i].T + m.kf_t[i]
            Xw = (1.0 / max(sn, 1e-12)) * ((Xc - tn) @ Rn)
            m.mp_pos[mids] = Xw.astype(np.float32)
            m.mark_points_dirty(mids)
            moved[mids] = True

        # write corrected SE3 poses (t/s recovery, reference :497-504)
        for i, (Rn, tn, sn) in corrected.items():
            m.set_kf_pose(i, Rn, tn / sn)

        fuser = LocalMapper(self.cfg, m, device=self.device)

        # direct fusion of the Sim3-matched pairs: the loop point replaces
        # the current KF's binding (reference: src/LoopClosing.cc:516-533,
        # pCurMP->Replace(pLoopMP)); all merges apply in one table pass
        if mkp is not None and len(mkp) > 0:
            merges = []
            binds = []
            for k, lp in zip(mkp, mmp):
                k, lp = int(k), int(lp)
                if not m.mp_exists[lp]:
                    continue
                bound = int(m.kf_obs[kid, k])
                if bound == lp:
                    continue
                if bound >= 0 and m.mp_exists[bound]:
                    merges.append((bound, lp))
                else:
                    binds.append((k, lp))
            if merges:
                m.replace_points_bulk(merges)
            for k, lp in binds:
                if m.mp_exists[lp] and not (m.kf_obs[kid] == lp).any():
                    m.kf_obs[kid, k] = lp
            m._refresh_obs_row(kid)

        # fuse loop points into the corrected neighbourhood (SearchAndFuse,
        # reference: src/LoopClosing.cc:585-611)
        with profiling.stage("loop_closing/fuse"):
            if loop_points is None:
                loop_points = self._loop_neighborhood_points(loop_kf)
            if len(loop_points) > 0:
                loop_points = loop_points[m.mp_exists[loop_points]]
                fuser.fuse_into_many(list(corrected), loop_points)
            for i in corrected:
                m.update_connections(int(i))
            m.update_connections(loop_kf)
        self.map.loop_edges.append((kid, loop_kf))

        with profiling.stage("loop_closing/essential"):
            self._optimize_essential_graph(kid, loop_kf, corrected,
                                           R_pre, t_pre)
        if self.run_global_ba_flag:
            if self.background_gba is not None:
                with profiling.stage("loop_closing/gba_launch"):
                    if self.background_gba.running():
                        self.background_gba.abort()
                        self.background_gba.wait(timeout=5.0)
                    # 60 iterations: the reference's 20 g2o iterations
                    # under-converged here (JAX package, r5 diagnostics)
                    self.background_gba.launch(iters=60)
            else:
                with profiling.stage("loop_closing/gba"):
                    self._global_bundle_adjustment(kid)
        m.version += 1

    # ------------------------------------------------------------------

    def _optimize_essential_graph(self, kid: int, loop_kf: int, corrected,
                                  R_pre=None, t_pre=None):
        """(reference: src/Optimizer.cc:781-1044). Edges: spanning tree +
        covisibility >= 100 + loop edges; loop KF held fixed.
        Spanning-tree/covisibility edges are measured with the
        pre-correction poses, loop edges with the corrected ones, so the
        optimizer spreads the loop discrepancy around the cycle."""
        m = self.map
        lcfg = self.cfg.loop_closing
        kfs = m.keyframe_ids()
        if R_pre is None:
            R_pre, t_pre = m.kf_R, m.kf_t

        edges = []
        meas = []

        def rel_se3(i, j, Rsrc, tsrc):
            """S_ji = T_jw * T_wi as a Sim3 with s=1."""
            Rji = Rsrc[j] @ Rsrc[i].T
            return Rji, tsrc[j] - Rji @ tsrc[i]

        seen = set()
        for i in kfs:
            i = int(i)
            p = int(m.parent[i])
            if p >= 0 and m.kf_exists[p]:
                edges.append((i, p))
                meas.append(rel_se3(i, p, R_pre, t_pre))
                seen.add((min(i, p), max(i, p)))
        for (a, b) in m.loop_edges:
            if m.kf_exists[a] and m.kf_exists[b] and \
                    (min(a, b), max(a, b)) not in seen:
                edges.append((a, b))
                # loop constraint: measured with the CORRECTED poses
                meas.append(rel_se3(a, b, m.kf_R, m.kf_t))
                seen.add((min(a, b), max(a, b)))
        strong = np.argwhere(m.covis >= lcfg.essential_graph_min_weight)
        for a, b in strong:
            a, b = int(a), int(b)
            if a < b and m.kf_exists[a] and m.kf_exists[b] \
                    and (a, b) not in seen:
                edges.append((a, b))
                meas.append(rel_se3(a, b, R_pre, t_pre))
                seen.add((a, b))
        if not edges:
            return

        # compact to the live keyframes, at their exact count
        slot_of = np.full(m.K, -1, dtype=np.int64)
        slot_of[kfs] = np.arange(len(kfs))
        V = len(kfs)
        ij = slot_of[np.asarray(edges)]
        Rm = np.stack([r for r, _ in meas]).astype(np.float32)
        tm = np.stack([t for _, t in meas]).astype(np.float32)
        fixed = np.zeros(V, bool)
        fixed[slot_of[loop_kf]] = True
        E = len(edges)
        with profiling.stage("loop_closing/essential_solve"):
            res = pose_graph.optimize_pose_graph(
                (self._dev(m.kf_R[kfs]), self._dev(m.kf_t[kfs]),
                 self._dev(np.ones(V))),
                self._dev(ij, torch.int64),
                (self._dev(Rm), self._dev(tm), self._dev(np.ones(E))),
                self._dev(np.ones(E, bool), torch.bool),
                self._dev(np.ones(V, bool), torch.bool),
                self._dev(fixed, torch.bool), fix_scale=self.fix_scale,
                iters=20)
            R_new = res.R.cpu().numpy()
            t_new = res.t.cpu().numpy()
            s_new = res.s.cpu().numpy()

        # snapshot old poses for the landmark correction
        R_old = m.kf_R.copy()
        t_old = m.kf_t.copy()
        for c, k in enumerate(kfs):
            m.set_kf_pose(int(k), R_new[c], t_new[c] / max(s_new[c], 1e-9))

        # landmark correction through each point's reference KF (:963-1010)
        mids = m.point_ids()
        ref = m.mp_first_kf[mids]
        ok = (ref >= 0) & m.kf_exists[np.clip(ref, 0, None)]
        mids, ref = mids[ok], ref[ok]
        Xc = np.einsum("pij,pj->pi", R_old[ref], m.mp_pos[mids]) + t_old[ref]
        Rwc = np.swapaxes(m.kf_R[ref], 1, 2)
        m.mp_pos[mids] = np.einsum("pij,pj->pi", Rwc, Xc - m.kf_t[ref])
        m.mark_points_dirty(mids)

    # ------------------------------------------------------------------

    def _global_bundle_adjustment(self, kid: int):
        """Synchronous global BA (reference: src/LoopClosing.cc:643-744
        RunGlobalBundleAdjustment); the background variant is
        enable_background_gba."""
        run_global_ba(self.cfg, self.map, fixed_kf=self.map.kf_origin,
                      iters=20, device=self.device)
