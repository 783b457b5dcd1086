"""Local mapping: keyframe processing, point culling, triangulation,
fusion, local BA, keyframe culling.

Port of orb_slam2_map_tpu/slam/local_mapping.py, replacing the
reference's LocalMapping thread (reference: src/LocalMapping.cc). The
thread + 3 ms-poll queue becomes a host-orchestrated stage invoked per
keyframe (or a worker thread fed by a queue, SLAMSystem(async_mapping=
True)); the numeric core (epipolar triangulation matching, fusion
matching, local BA) runs as tensor programs on the mapper's device, with
one upload before and one download after each of them. The host
bookkeeping is the JAX package's, line for line.

After each keyframe the mapper hands it to the loop closer
(`loop_closer.process_keyframe`, inline), and loop closing's
SearchAndFuse comes back through `fuse_into_many`. The
hand-off through `loop_queue` to a loop-closing thread of the async
pipeline comes with the dense slice (ROADMAP.md); until then
`loop_queue` stays None.
"""

from __future__ import annotations

import contextlib
import sys
from typing import List

import numpy as np
import torch

from ..config import SystemConfig
from ..optim import local_ba
from ..utils import profiling
from ..utils.device import default_device, host_tensor
from . import mapping_kernels
from .mapstore import MapStore

# fixed capacities of the local-BA problem
BA_MAX_FREE = 16
BA_MAX_FIXED = 16
BA_MAX_POINTS = 4096


def fetch(tensors) -> tuple:
    """One host copy of each tensor of a tuple (numpy)."""
    return tuple(t.cpu().numpy() for t in tensors)


class LocalMapper:
    def __init__(self, cfg: SystemConfig, map_store: MapStore,
                 loop_closer=None, device=None):
        self.cfg = cfg
        self.map = map_store
        self.device = default_device(device)
        self.loop_closer = loop_closer
        self.recent_points: List[np.ndarray] = []  # queues for culling
        self.recent_kf: List[int] = []
        self.enabled = True
        # keyframe hand-off to a loop-closing thread (a queue.Queue): the
        # async pipeline's loop thread comes with the dense slice
        # (ROADMAP.md); None until then
        self.loop_queue = None
        # set by the async pipeline: local BA runs on its continuous
        # thread instead of inside process_keyframe
        self.external_ba = False
        # host-map lock (a context manager) held around map reads and
        # writes, never across a device round trip; a no-op until the
        # async pipeline shares the map between threads
        self.lock = contextlib.nullcontext()

    # ------------------------------------------------------------------

    def _dev(self, a, dtype=torch.float32):
        return host_tensor(a, self.device, dtype)

    # ------------------------------------------------------------------

    def process_keyframe(self, kid: int, effort: str = "full"):
        """Per-keyframe pipeline (reference: src/LocalMapping.cc:47-112
        Run): bookkeeping -> point culling -> triangulate new points ->
        fuse duplicates -> local BA -> keyframe culling.

        `effort` sheds work under the async pipeline's keyframe backlog
        (the reference's InterruptBA analogue, src/LocalMapping.cc:118):
        "full" runs everything, "medium" skips local BA and keyframe
        culling, "light" also skips triangulation and fusion, so that
        keyframe creation never waits on refinement. With external_ba
        the local BA runs on the pipeline's continuous-BA thread. Then
        the keyframe goes to the loop closer, if there is one."""
        if not self.enabled:
            return
        with profiling.stage("local_mapping"):
            with self.lock:
                self._process_new_keyframe(kid)
                self._cull_map_points(kid)
                n_kfs = self.map.n_keyframes()
            if effort != "light" and n_kfs > 1:
                with profiling.stage("local_mapping/triangulate"):
                    self._create_new_map_points(kid)
                with profiling.stage("local_mapping/fuse"):
                    self._fuse_neighbors(kid)
            if not self.external_ba and effort == "full" and n_kfs > 2:
                with profiling.stage("local_mapping/local_ba"):
                    self._local_bundle_adjustment(kid)
            if effort == "full":
                with self.lock:
                    self._cull_keyframes(kid)
        if self.loop_queue is not None:
            # a loop-closing thread of its own (reference:
            # src/LoopClosing.cc:58-102)
            self.loop_queue.put(kid)
        elif self.loop_closer is not None:
            with profiling.stage("loop_closing"):
                self.loop_closer.process_keyframe(kid)

    # ------------------------------------------------------------------

    def _process_new_keyframe(self, kid: int):
        """(reference: src/LocalMapping.cc:128-168): refresh point
        normals/descriptors and track recently added points."""
        obs = self.map.kf_obs[kid]
        mids = np.unique(obs[obs >= 0])
        sf = np.asarray(self.cfg.orb.scale_factors, dtype=np.float32)
        with profiling.stage("local_mapping/point_stats"):
            self.map.update_point_stats(mids, sf)
        new_mask = self.map.mp_first_kf[mids] == kid
        self.recent_points.append(mids[new_mask])
        self.recent_kf.append(kid)

    def _cull_map_points(self, kid: int):
        """(reference: src/LocalMapping.cc:170-205): drop points with
        found/visible < 0.25 or too few observations within 2 KFs of
        creation."""
        lcfg = self.cfg.local_mapping
        keep_queues = []
        to_erase = []
        for created_kf, mids in zip(self.recent_kf, self.recent_points):
            mids = mids[self.map.mp_exists[mids]]
            age = kid - created_kf  # keyframes since creation (id distance)
            ratio = (self.map.mp_found[mids] /
                     np.maximum(self.map.mp_visible[mids], 1))
            bad = ratio < lcfg.culling_found_ratio
            if age >= 2:
                # weighted obs count (stereo counts 2): reference gate is
                # Observations() <= 3 (src/LocalMapping.cc:186)
                bad |= self.map.mp_obs_count[mids] <= lcfg.culling_min_obs
            to_erase.append(mids[bad])
            if age <= 2:
                keep_queues.append((created_kf, mids[~bad]))
        if to_erase:
            self.map.erase_points_bulk(np.concatenate(to_erase))
        self.recent_kf = [k for k, _ in keep_queues]
        self.recent_points = [m for _, m in keep_queues]

    # ------------------------------------------------------------------

    def _create_new_map_points(self, kid: int):
        """Two-view triangulation with covisible neighbours (reference:
        src/LocalMapping.cc:207-452): per neighbour, epipolar-gated
        descriptor matching of unmatched keypoints (SearchForTriangulation,
        src/ORBmatcher.cc:657-823) -> batched DLT -> acceptance gates."""
        lcfg = self.cfg.local_mapping
        cam = self.cfg.camera
        m = self.map
        with self.lock:
            neighbors = m.covisible_keyframes(
                kid, top_n=lcfg.triangulation_neighbors_stereo)
            if len(neighbors) == 0:
                return
            R1 = m.kf_R[kid].copy()
            t1 = m.kf_t[kid].copy()
            c1 = -R1.T @ t1
            free1 = (m.kf_obs[kid] < 0) & m.kf_kp_valid[kid]

            nbs = []
            for nb in neighbors:
                c2 = -m.kf_R[nb].T @ m.kf_t[nb]
                if np.linalg.norm(c2 - c1) < cam.baseline:  # ref :252-261
                    continue
                if ((m.kf_obs[nb] < 0) & m.kf_kp_valid[nb]).sum() > 0:
                    nbs.append(int(nb))
            if free1.sum() == 0 or len(nbs) == 0:
                m.update_connections(kid)
                return
            nb_arr = np.asarray(nbs)
            free2s = (m.kf_obs[nb_arr] < 0) & m.kf_kp_valid[nb_arr]

            with profiling.stage("local_mapping/tri_dispatch"):
                b = torch.bool
                res = mapping_kernels.triangulate_pairs_batch(
                    self.cfg, self._dev(R1), self._dev(t1),
                    self._dev(m.kf_xy[kid]), self._dev(m.kf_level[kid],
                                                       torch.int32),
                    self._dev(m.kf_desc[kid]), self._dev(free1, b),
                    self._dev(m.kf_ur[kid]),
                    self._dev(m.kf_R[nb_arr]), self._dev(m.kf_t[nb_arr]),
                    self._dev(m.kf_xy[nb_arr]),
                    self._dev(m.kf_level[nb_arr], torch.int32),
                    self._dev(m.kf_desc[nb_arr]), self._dev(free2s, b),
                    self._dev(m.kf_ur[nb_arr]))
        with profiling.stage("local_mapping/tri_fetch"):
            ok_b, col_b, X_b = fetch((res.ok, res.kp2_idx, res.X))

        with self.lock:
            new_all = []
            for j, nb in enumerate(nbs):
                # drop keypoints consumed by earlier pairs or bound since
                ok = ok_b[j] & free1 & (m.kf_obs[kid] < 0)
                rows = np.nonzero(ok)[0]
                if len(rows) == 0:
                    continue
                cols = col_b[j][rows]
                mids = m.alloc_points(len(rows))
                m.mp_pos[mids] = X_b[j][rows]
                m.mp_desc[mids] = m.kf_desc[kid][rows]
                m.mp_level[mids] = m.kf_level[kid][rows]
                m.mp_first_kf[mids] = kid
                m.set_observations_bulk(kid, rows, mids)
                m.set_observations_bulk(nb, cols, mids)
                free1[rows] = False
                new_all.append(mids)
            if new_all:
                mids = np.concatenate(new_all)
                with profiling.stage("local_mapping/tri_stats"):
                    m.update_point_stats(
                        mids, np.asarray(self.cfg.orb.scale_factors,
                                         np.float32))
                if len(self.recent_points):
                    self.recent_points[-1] = np.concatenate(
                        [self.recent_points[-1], mids])
            m.update_connections(kid)

    # ------------------------------------------------------------------

    FUSE_TARGET_CAP = 24  # forward-fuse targets per keyframe

    def _fuse_neighbors(self, kid: int):
        """Two-way duplicate fusion with 1st+2nd ring neighbours
        (reference: src/LocalMapping.cc:454-534 SearchInNeighbors +
        src/ORBmatcher.cc:825-975 Fuse): project this KF's points into
        each neighbour, and the neighbours' points into this KF; merge
        matches that hit a keypoint bound to another point (keep the
        more-observed one)."""
        m = self.map
        with self.lock:
            first_ring = m.covisible_keyframes(kid, top_n=10)
            targets = list(first_ring)
            seen = set(targets) | {kid}
            for k in first_ring:
                for nb in m.covisible_keyframes(k, top_n=5):
                    if int(nb) not in seen:
                        targets.append(int(nb))
                        seen.add(int(nb))
            obs_self = m.kf_obs[kid]
            own = np.unique(obs_self[obs_self >= 0])
            own = own[m.mp_exists[own]]
            if len(own) == 0:
                return
            nb_points = [m.kf_obs[nb][m.kf_obs[nb] >= 0] for nb in targets]
            cand = np.unique(np.concatenate(nb_points)) if nb_points else \
                np.asarray([], dtype=np.int64)
            cand = cand[m.mp_exists[cand]]
            targets = [int(t) for t in targets[:self.FUSE_TARGET_CAP]]
            fwd = self._fuse_dispatch(targets, own) if targets else None
            rev = self._fuse_dispatch([kid], cand) if len(cand) else None
        pulls = []
        for d in (fwd, rev):
            if d is not None:
                pulls.extend([d.ok, d.kp_idx])
        with profiling.stage("local_mapping/fuse_fetch"):
            host = fetch(pulls)   # no map lock during the round trip
        with self.lock:
            batches = []
            if fwd is not None:
                keep_b, kp_b = host[0], host[1]
                for j, nb in enumerate(targets):
                    rows = np.nonzero(keep_b[j])[0]
                    batches.append((nb, own, rows, kp_b[j][rows]))
            if rev is not None:
                ok_np, kp_np = host[-2][0], host[-1][0]
                rows = np.nonzero(ok_np)[0]
                batches.append((kid, cand, rows, kp_np[rows]))
            with profiling.stage("local_mapping/apply_fuse"):
                self.apply_fuse_round(batches)
            # descriptors/normals + covisibility changed
            with profiling.stage("local_mapping/fuse_stats"):
                m.update_point_stats(
                    own, np.asarray(self.cfg.orb.scale_factors, np.float32))
            m.update_connections(kid)

    def fuse_into_many(self, targets, mids: np.ndarray):
        """Fuse points `mids` into many keyframes: one launch per target,
        one download, one bookkeeping round (loop closing's SearchAndFuse
        over the corrected neighbourhood, reference
        src/LoopClosing.cc:585-611)."""
        targets = [int(t) for t in targets]
        if len(targets) == 0 or len(mids) == 0:
            return
        res = self._fuse_dispatch(targets, mids)
        ok_b, kp_b = fetch((res.ok, res.kp_idx))
        batches = []
        for j, nb in enumerate(targets):
            rows = np.nonzero(ok_b[j])[0]
            batches.append((nb, mids, rows, kp_b[j][rows]))
        with profiling.stage("local_mapping/apply_fuse"):
            self.apply_fuse_round(batches)

    def _fuse_dispatch(self, targets: List[int], mids: np.ndarray
                       ) -> mapping_kernels.FuseMatchResult:
        """Launch the projection of points `mids` into every keyframe of
        `targets` (reference Fuse, src/ORBmatcher.cc:825-975); results
        carry a [T] leading axis, downloaded by the caller."""
        m = self.map
        t_arr = np.asarray(targets)
        return mapping_kernels.fuse_match_batch(
            self.cfg, self._dev(m.kf_R[t_arr]), self._dev(m.kf_t[t_arr]),
            self._dev(m.mp_pos[mids]), self._dev(m.mp_desc[mids]),
            self._dev(m.mp_min_dist[mids]), self._dev(m.mp_max_dist[mids]),
            torch.ones(len(mids), dtype=torch.bool, device=self.device),
            self._dev(m.kf_xy[t_arr]),
            self._dev(m.kf_level[t_arr], torch.int32),
            self._dev(m.kf_kp_valid[t_arr], torch.bool),
            self._dev(m.kf_desc[t_arr]))

    def apply_fuse_round(self, batches):
        """Bind/merge a whole round of accepted fuse matches (reference
        Fuse bookkeeping, src/ORBmatcher.cc:825-975 + MapPoint::Replace,
        src/MapPoint.cc:177-215). `batches` is a list of
        (kid, mids, rows, kp) acceptance sets. Decisions run as host-dict
        ops per match; the merges apply in one pass over the observation
        table (MapStore.replace_points_bulk)."""
        m = self.map
        merges = []                     # (drop, keep) pairs
        binds = []                      # (kid, kp, mid)
        repl: dict = {}                 # local view of this round's merges

        def resolve(x: int) -> int:
            while x in repl:
                x = repl[x]
            return x

        bound_sets: dict = {}
        overlay: dict = {}              # (kid, kp) -> mid bound this round
        cnt: dict = {}                  # merged-obs-count overlay
        for kid, mids, rows, kp in batches:
            if len(rows) == 0:
                continue
            kid = int(kid)
            if kid not in bound_sets:
                row = m.kf_obs[kid]
                bound_sets[kid] = set(row[row >= 0].tolist())
            for r, k in zip(rows, kp):
                mid = resolve(int(mids[r]))
                if not m.mp_exists[mid]:
                    continue            # merged away earlier this round
                cur = overlay.get((kid, int(k)))
                if cur is None:
                    b = int(m.kf_obs[kid, k])
                    cur = resolve(b) if b >= 0 else -1
                    if cur >= 0 and not m.mp_exists[cur]:
                        cur = -1
                else:
                    cur = resolve(cur)
                if cur == mid:
                    continue
                if cur >= 0:
                    # merge: keep the more-observed point (live view:
                    # earlier merges this round add their observations)
                    c_cur = cnt.get(cur, None)
                    if c_cur is None:
                        c_cur = int(m.mp_obs_count[cur])
                    c_mid = cnt.get(mid, None)
                    if c_mid is None:
                        c_mid = int(m.mp_obs_count[mid])
                    if c_cur >= c_mid:
                        keep, drop = cur, mid
                    else:
                        keep, drop = mid, cur
                    cnt[keep] = c_cur + c_mid
                    cnt[drop] = 0
                    repl[drop] = keep
                    merges.append((drop, keep))
                else:
                    if mid in bound_sets[kid]:
                        continue        # KF already observes this point
                    binds.append((kid, int(k), mid))
                    overlay[(kid, int(k))] = mid
                    bound_sets[kid].add(mid)

        if merges:
            m.replace_points_bulk(merges)
        touched = set()
        for kid, k, mid in binds:
            mid = resolve(mid)
            if not m.mp_exists[mid]:
                continue
            if mid != int(m.kf_obs[kid, k]) \
                    and (m.kf_obs[kid] == mid).any():
                continue                # survivor landed here via a merge
            m.kf_obs[kid, k] = mid
            touched.add(kid)
        if touched:
            m.refresh_obs_rows(np.fromiter(touched, np.int64, len(touched)))

    # ------------------------------------------------------------------

    def _local_bundle_adjustment(self, kid: int, discard_if=None):
        """Assemble the dense padded BA problem, solve it on the device
        (reference: src/Optimizer.cc:453-778) and write back.
        `discard_if`, when given, is asked right before the write-back: a
        map transform (loop correction) that landed while this solve ran
        makes its poses stale, and the result is dropped."""
        mstore = self.map
        with self.lock:
            built = self._build_ba_inputs(kid)
        if built is None:
            return
        free_ids, fix_ids, mids, prob_np = built
        prob = local_ba.BAProblem(*(
            self._dev(a, torch.bool if a.dtype == bool else torch.float32)
            for a in prob_np))                   # one upload per array
        res = local_ba.local_ba(self.cfg.camera, prob)
        with profiling.stage("local_mapping/ba_fetch"):
            R_f, t_f, X_f, inl_f = fetch(
                (res.R_free, res.t_free, res.X, res.inlier_free))

        if discard_if is not None and discard_if():
            return
        with self.lock:
            # write back poses + points; rotations re-projected to SO(3)
            # (repeated f32 LM retractions drift R R^T off identity)
            K = len(free_ids)
            P = len(mids)
            # guard: a solve that went degenerate must never teleport
            # the map
            pose_ok = (np.isfinite(t_f[:K]).all(axis=1)
                       & (np.linalg.norm(
                           t_f[:K] - mstore.kf_t[free_ids], axis=1) < 2.0))
            pt_ok = (np.isfinite(X_f[:P]).all(axis=1)
                     & (np.linalg.norm(
                         X_f[:P] - mstore.mp_pos[mids], axis=1) < 5.0))
            if not pose_ok.all() or not pt_ok.all():
                print(f"[local_ba] write-back guard: rejected "
                      f"{int((~pose_ok).sum())} poses / "
                      f"{int((~pt_ok).sum())} points (divergent solve)",
                      file=sys.stderr)
            wids = free_ids[pose_ok]
            U, _, Vt = np.linalg.svd(R_f[:K][pose_ok])
            mstore.kf_R[wids] = (U @ Vt).astype(np.float32)
            mstore.kf_t[wids] = t_f[:K][pose_ok]
            alive = mstore.mp_exists[mids] & pt_ok
            mstore.mp_pos[mids[alive]] = X_f[:P][alive]
            mstore.mark_points_dirty(mids[alive])

            # remove outlier observations (reference: :714-748)
            bad = prob_np.mask_free[:P, :K] & ~inl_f[:P, :K]
            for j, k in enumerate(free_ids):
                rows = np.nonzero(bad[:, j])[0]
                if len(rows) == 0:
                    continue
                sel = np.isin(mstore.kf_obs[k], mids[rows])
                mstore.kf_obs[k][sel] = -1
                mstore._refresh_obs_row(k)
            self.map.version += 1

    def _build_ba_inputs(self, kid: int):
        mstore = self.map
        neighbors = mstore.covisible_keyframes(kid)
        free_ids = np.concatenate([[kid], neighbors])[:BA_MAX_FREE]
        # never move the map origin (reference fixes KF id 0, :500)
        free_ids = free_ids[free_ids != mstore.kf_origin]
        if len(free_ids) == 0:
            return
        # points seen by the free KFs
        inc = mstore.observed_mask(free_ids) & mstore.mp_exists
        mids = np.nonzero(inc)[0]
        if len(mids) == 0:
            return
        if len(mids) > BA_MAX_POINTS:
            order = np.argsort(-mstore.mp_obs_count[mids], kind="stable")
            mids = np.sort(mids[order[:BA_MAX_POINTS]])
        # fixed KFs: other observers of those points (+ origin if observer)
        observers = (mstore.shared_counts(mids) > 0) & mstore.kf_exists
        observers[free_ids] = False
        fix_ids = np.nonzero(observers)[0]
        if len(fix_ids) > BA_MAX_FIXED:
            # keep the most strongly covisible fixed observers
            w = mstore.covis[fix_ids][:, free_ids].sum(axis=1)
            fix_ids = fix_ids[np.argsort(-w, kind="stable")[:BA_MAX_FIXED]]
        return free_ids, fix_ids, mids, self._build_problem(free_ids,
                                                            fix_ids, mids)

    def _build_problem(self, free_ids, fix_ids, mids) -> local_ba.BAProblem:
        """Gather the dense [P, K] observation grids (numpy) from the map."""
        mstore = self.map
        P, K, F = BA_MAX_POINTS, BA_MAX_FREE, BA_MAX_FIXED
        n_free, n_pts = len(free_ids), len(mids)

        inv_sigma2 = 1.0 / np.asarray(self.cfg.orb.level_sigma2,
                                      dtype=np.float32)
        # mp id -> row index (shared by both grids)
        row_of = np.full(mstore.M, -1, dtype=np.int64)
        row_of[mids] = np.arange(n_pts)

        def grids(ids, C):
            """One vectorized scatter over all (KF, keypoint) pairs."""
            uv = np.zeros((P, C, 2), dtype=np.float32)
            ur = np.full((P, C), -1.0, dtype=np.float32)
            iv = np.ones((P, C), dtype=np.float32)
            mask = np.zeros((P, C), dtype=bool)
            if len(ids) == 0:
                return uv, ur, iv, mask
            obs = mstore.kf_obs[ids]                       # [C', N]
            rows = row_of[np.clip(obs, 0, None)]
            sel = (obs >= 0) & (rows >= 0)
            jj = np.broadcast_to(np.arange(len(ids))[:, None],
                                 obs.shape)[sel]
            rr = rows[sel]
            uv[rr, jj] = mstore.kf_xy[ids][sel]
            ur[rr, jj] = mstore.kf_ur[ids][sel]
            iv[rr, jj] = inv_sigma2[mstore.kf_level[ids][sel]]
            mask[rr, jj] = True
            return uv, ur, iv, mask

        uv_f, ur_f, iv_f, m_f = grids(free_ids, K)
        uv_x, ur_x, iv_x, m_x = grids(fix_ids, F)

        def pad_poses(ids, C):
            R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
            t = np.zeros((C, 3), dtype=np.float32)
            R[:len(ids)] = mstore.kf_R[ids]
            t[:len(ids)] = mstore.kf_t[ids]
            return R, t

        R_free, t_free = pad_poses(free_ids, K)
        R_fix, t_fix = pad_poses(fix_ids, F)
        X = np.zeros((P, 3), dtype=np.float32)
        X[:n_pts] = mstore.mp_pos[mids]
        cam_valid = np.zeros(K, dtype=bool)
        cam_valid[:n_free] = True
        point_valid = np.zeros(P, dtype=bool)
        point_valid[:n_pts] = True

        return local_ba.BAProblem(
            R_free=R_free, t_free=t_free, R_fix=R_fix, t_fix=t_fix,
            X=X, cam_valid=cam_valid, point_valid=point_valid,
            uv_free=uv_f, ur_free=ur_f, inv_sigma2_free=iv_f, mask_free=m_f,
            uv_fix=uv_x, ur_fix=ur_x, inv_sigma2_fix=iv_x, mask_fix=m_x,
        )

    # ------------------------------------------------------------------

    def _cull_keyframes(self, kid: int):
        """Redundant-KF culling (reference: src/LocalMapping.cc:632-698):
        a local KF whose map points are >= 90% seen by >= 3 other KFs at
        the same or finer scale is removed."""
        lcfg = self.cfg.local_mapping
        targets = [int(k) for k in self.map.covisible_keyframes(kid)
                   if int(k) != self.map.kf_origin and int(k) != kid]
        if not targets:
            return
        # level-of-point lookup per existing KF: lvl[j, mid] = pyramid
        # level at which KF j observes mid (127 = not observed)
        kfs_alive = self.map.keyframe_ids()
        lvl = np.full((len(kfs_alive), self.map.M), 127, dtype=np.int8)
        obs_all = self.map.kf_obs[kfs_alive]                  # [Ka, N]
        sel = obs_all >= 0
        rows = np.broadcast_to(np.arange(len(kfs_alive))[:, None],
                               obs_all.shape)[sel]
        lvl[rows, obs_all[sel]] = np.minimum(
            self.map.kf_level[kfs_alive][sel], 126).astype(np.int8)
        row_of = np.full(self.map.K, -1)
        row_of[kfs_alive] = np.arange(len(kfs_alive))

        for k in targets:
            obs = self.map.kf_obs[k]
            kp = np.nonzero(obs >= 0)[0]
            mids = obs[kp]
            alive = self.map.mp_exists[mids]
            kp, mids = kp[alive], mids[alive]
            if len(mids) == 0:
                continue
            levels = self.map.kf_level[k][kp]                 # [P]
            cand = self.map.mp_obs_count[mids] >= lcfg.kf_culling_min_obs + 1
            # observers at same-or-finer scale (level <= level_k + 1)
            lv = lvl[:, mids].astype(np.int32)                # [Ka, P]
            finer = (lv <= levels[None, :] + 1)
            finer[row_of[k]] = False                          # exclude self
            redundant = int((cand
                             & (finer.sum(axis=0)
                                >= lcfg.kf_culling_min_obs)).sum())
            if redundant > lcfg.kf_culling_redundancy * len(mids):
                self.map.erase_keyframe(k)
                lvl[row_of[k]] = 127
