"""Background global bundle adjustment with staged write-back.

Port of orb_slam2_map_tpu/parallel/background.py, replacing the
reference's transient GBA thread + mTcwGBA/mPosGBA staging (reference:
src/LoopClosing.cc:571-575 launch, :643-744 RunGlobalBundleAdjustment,
:412-421 mbStopGBA abort; src/Optimizer.cc:121-135 staged read-back):

  * The optimizer runs on a SNAPSHOT of the map (keyframe poses, point
    positions, observation lists copied at launch), in iteration chunks
    on a worker thread, so tracking and local mapping never stall.
  * An abort flag is checked between chunks.
  * On completion the results are STAGED; the map owner calls poll() to
    merge them: keyframes that existed at launch get their optimized
    poses, keyframes added during the run are corrected through the
    spanning tree (reference :673-696), and map points added during the
    run move with their reference keyframe (:698-733).

The worker runs on one device (the JAX package's multi-device branch,
parallel/dist_ba.py, is a later slice). A worker exception is recorded in
`errors` and re-raised by `wait`, never swallowed.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import List, Optional

import numpy as np
import torch

from ..optim import global_ba as gba
from ..utils.device import default_device


def _se3_mat(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _se3_inv(T: np.ndarray) -> np.ndarray:
    Ti = np.eye(4, dtype=np.float32)
    Ti[:3, :3] = T[:3, :3].T
    Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return Ti


class BackgroundGBA:
    """One in-flight global BA at a time (matching the reference, which
    aborts a running GBA before starting the next)."""

    CHUNK = 5   # LM iterations per abort check; the damping is carried
                # across chunks (global_ba_chunk)

    def __init__(self, cfg, map_store, device=None):
        self.cfg = cfg
        self.map = map_store
        self.device = default_device(device)
        self._thread: Optional[threading.Thread] = None
        self._abort = threading.Event()
        self._staged = None           # (kfs, R, t, mids, X, snap)
        self._lock = threading.Lock()
        self.errors: List[str] = []   # worker tracebacks
        # LM iterations of the last finished run
        self.last_iters = 0
        # called with the 4x4 world transform of the latest keyframe's
        # neighborhood after a merge (see LoopCloser.transform_listeners)
        self.on_transform = None

    # ------------------------------------------------------------------

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def launch(self, iters: int = 20) -> bool:
        """Snapshot the map and start the worker. The caller must own the
        map (the reference launches from CorrectLoop, which holds the map
        lock, src/LoopClosing.cc:575)."""
        if self.running():
            return False
        built = gba.build_gba_problem(self.cfg, self.map,
                                      fixed_kf=self.map.kf_origin,
                                      device=self.device)
        if built is None:
            return False
        prob, kfs, mids = built
        snap = {
            "kf_set": set(int(k) for k in kfs),
            "mid_set": set(int(m) for m in mids),
        }
        self._abort.clear()
        self._staged = None
        self._thread = threading.Thread(
            target=self._run, args=(prob, kfs, mids, snap, iters),
            name="background_gba", daemon=True)
        self._thread.start()
        return True

    def abort(self):
        """(reference: mbStopGBA, src/LoopClosing.cc:412-421)."""
        self._abort.set()

    def discard_staged(self):
        """Drop a completed-but-unmerged result. Called (under the map
        lock) by a loop correction: a result computed on pre-correction
        poses merging after the correction would undo it."""
        with self._lock:
            self._staged = None

    def _run(self, prob, kfs, mids, snap, iters):
        try:
            self._solve(prob, kfs, mids, snap, iters)
        except Exception:
            self.errors.append(traceback.format_exc())
            print(f"[background_gba] worker failed:\n{self.errors[-1]}",
                  file=sys.stderr)

    def _solve(self, prob, kfs, mids, snap, iters):
        done = ran = 0
        lam = torch.tensor(1e-5, dtype=torch.float32, device=self.device)
        while done < iters:
            n = min(self.CHUNK, iters - done)
            res, lam, n_ran = gba.global_ba_chunk(
                self.cfg.camera, prob, n, 24, True, lam)
            prob = prob._replace(R=res.R, t=res.t, X=res.X)
            done += n
            ran += n_ran
            if self._abort.is_set():
                return
            if n_ran < n:   # chi2 plateaued inside the chunk
                break
        self.last_iters = ran
        R, t, X = prob.R.cpu().numpy(), prob.t.cpu().numpy(), \
            prob.X.cpu().numpy()
        # re-orthonormalize: tens of LM retractions drift R R^T off I in
        # f32, which the SE3 composes of the staged spanning-tree
        # correction would amplify (they assume R^-1 = R^T)
        U, _, Vt = np.linalg.svd(R)
        R = np.ascontiguousarray((U @ Vt).astype(np.float32))
        with self._lock:
            # an abort requested at any point drops the result (the
            # reference re-checks mbStopGBA before write-back,
            # src/LoopClosing.cc:660)
            if not self._abort.is_set():
                self._staged = (kfs, R, t, mids, X, snap)

    # ------------------------------------------------------------------

    def poll(self) -> bool:
        """Merge staged results into the map if ready. Must be called by
        the map owner. Returns True if a merge happened."""
        with self._lock:
            staged = self._staged
            self._staged = None
        if staged is None:
            return False
        kfs, R, t, mids, X, snap = staged
        m = self.map
        if not self._staged_improves(kfs, R, t, mids, X):
            return False
        # anchor for the tracker-consistency transform: the newest live
        # keyframe (the tracker's reference neighborhood)
        live = m.keyframe_ids()
        anchor = int(live[np.argmax(m.kf_frame_id[live])]) if len(live) \
            else -1
        anchor_Tcw_old = m.kf_Tcw(anchor) if anchor >= 0 else None

        # pre-merge poses (the reference's mTcwBefGBA,
        # src/LoopClosing.cc:689-695): children and points created during
        # the run are positioned relative to these
        corr_Twc = {}
        old_Tcw = {}
        for i, k in enumerate(kfs):
            corr_Twc[int(k)] = _se3_inv(_se3_mat(R[i], t[i]))
            old_Tcw[int(k)] = _se3_mat(m.kf_R[k], m.kf_t[k])

        # 1) keyframes that existed at launch: staged poses (guarded: a
        # degenerate solve must never teleport the map)
        alive = m.kf_exists[kfs] & np.isfinite(t).all(axis=1) \
            & (np.linalg.norm(t - m.kf_t[kfs], axis=1) < 3.0)
        m.kf_R[kfs[alive]] = R[alive]
        m.kf_t[kfs[alive]] = t[alive]

        # 2) keyframes added during the run: spanning-tree correction
        #    T_child^corr = (T_child * T_parent^-1) * T_parent^corr
        #    (reference: src/LoopClosing.cc:673-696), in id order so that
        #    corrected parents chain forward
        new_kfs = [int(k) for k in m.keyframe_ids()
                   if int(k) not in snap["kf_set"]]
        for k in sorted(new_kfs):
            parent = int(m.parent[k])
            while parent >= 0 and parent not in old_Tcw and \
                    parent not in corr_Twc:
                parent = int(m.parent[parent])
            if parent < 0 or parent not in corr_Twc:
                continue
            T_child = _se3_mat(m.kf_R[k], m.kf_t[k])
            if parent in old_Tcw:
                T_cp = T_child @ _se3_inv(old_Tcw[parent])
            else:
                T_cp = T_child  # parent itself new; already corrected
            T_new = T_cp @ _se3_inv(corr_Twc[parent])
            m.kf_R[k] = T_new[:3, :3]
            m.kf_t[k] = T_new[:3, 3]
            corr_Twc[int(k)] = _se3_inv(T_new)
            old_Tcw[int(k)] = T_child

        # 3) points: snapshot points take optimized positions; points
        #    added during the run move with their reference keyframe
        #    (reference: src/LoopClosing.cc:698-733)
        mids = np.asarray(mids)
        palive = m.mp_exists[mids] & np.isfinite(X).all(axis=1) \
            & (np.linalg.norm(X - m.mp_pos[mids], axis=1) < 10.0)
        m.mp_pos[mids[palive]] = X[palive]
        new_mids = [mm for mm in np.nonzero(m.mp_exists)[0]
                    if int(mm) not in snap["mid_set"]]
        for mm in new_mids:
            ref = int(m.mp_first_kf[mm])
            if ref < 0 or ref not in old_Tcw:
                continue
            Xh = np.append(m.mp_pos[mm], 1.0).astype(np.float32)
            m.mp_pos[mm] = (corr_Twc[ref] @ (old_Tcw[ref] @ Xh))[:3]
        m.mark_all_points_dirty()   # bulk move: re-upload device columns
        m.version += 1
        if anchor >= 0 and m.kf_exists[anchor] and \
                self.on_transform is not None:
            A = m.kf_Twc(anchor) @ anchor_Tcw_old
            if float(np.abs(A - np.eye(4)).max()) > 1e-9:
                self.on_transform(A)
        return True

    def _staged_improves(self, kfs, R, t, mids, X) -> bool:
        """Merge-quality gate: a staged result that reprojects worse than
        the live map on a sample of observations has diverged or gone
        stale. Ported as the JAX package has it: the live side reads the
        current map, the staged side mixes staged poses and points with
        live points added since launch (ADVICE r5, ROADMAP.md §3)."""
        m = self.map
        cam = self.cfg.camera
        alive_k = [i for i, k in enumerate(kfs) if m.kf_exists[k]]
        if not alive_k:
            return False
        rng = np.random.default_rng(0)
        sample = rng.choice(alive_k, min(16, len(alive_k)), replace=False)
        pos_idx = np.full(m.M, -1, dtype=np.int64)
        pos_idx[mids] = np.arange(len(mids))

        def med_err(use_staged: bool) -> float:
            errs = []
            for i in sample:
                k = int(kfs[i])
                obs = m.kf_obs[k]
                rows = np.nonzero((obs >= 0)
                                  & m.mp_exists[np.clip(obs, 0, None)])[0]
                if len(rows) == 0:
                    continue
                pm = obs[rows]
                if use_staged:
                    si = pos_idx[pm]
                    Xw = np.where((si >= 0)[:, None], X[np.clip(si, 0, None)],
                                  m.mp_pos[pm])
                    Rk, tk = R[i], t[i]
                else:
                    Xw = m.mp_pos[pm]
                    Rk, tk = m.kf_R[k], m.kf_t[k]
                Xc = Xw @ Rk.T + tk
                z = np.maximum(Xc[:, 2], 1e-6)
                u = cam.fx * Xc[:, 0] / z + cam.cx
                v = cam.fy * Xc[:, 1] / z + cam.cy
                errs.append(np.hypot(u - m.kf_xy[k][rows, 0],
                                     v - m.kf_xy[k][rows, 1]))
            if not errs:
                return float("inf")
            return float(np.median(np.concatenate(errs)))

        live, staged = med_err(False), med_err(True)
        if staged > live * 1.15 + 0.1:
            print(f"[background_gba] staged result rejected: sample "
                  f"median reprojection {staged:.2f} px vs live "
                  f"{live:.2f} px", file=sys.stderr)
            return False
        return True

    def wait(self, timeout: Optional[float] = None):
        """Join the worker; raises RuntimeError if it failed."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self.errors:
            raise RuntimeError(f"background GBA worker failed:\n"
                               f"{self.errors[-1]}")
