"""Tracking: the per-frame state machine.

Port of orb_slam2_map_tpu/slam/tracking.py, replacing the reference's
Tracking thread (reference: src/Tracking.cc): state machine
{NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST}, RGB-D initialization,
motion-model tracking, reference-keyframe fallback, local-map tracking,
keyframe decision, and the per-frame relative-pose log used for
trajectory recovery.

Host/device split: ORB extraction, projection matching and pose
optimization run as tensor programs on the tracker's device; the state
machine, keyframe policy and map bookkeeping stay on the host in numpy.
In the steady state a frame makes exactly one blocking device->host
copy (`_track_chain`).

Relocalization (LOST state) matches the frame against candidate
keyframes, solves EPnP-RANSAC (optim/epnp.py) on the matches and
refines with pose-only LM. Without a place database (`relocalizer`
None) every keyframe is a candidate, at most 8 per frame.
"""

from __future__ import annotations

import enum
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..optim import epnp, pose_opt
from ..utils import profiling
from ..utils.device import default_device
from . import frame as frame_mod
from . import pipeline_step
from . import search
from .frame import Frame
from .mapstore import MapStore, host

LOCAL_POINT_CAP = 4096  # fixed device capacity for local-map points


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclass
class FrameLog:
    """Per-frame trajectory log entry (reference: include/Tracking.h:
    111-116 mlRelativeFramePoses etc.). `obs` retains the frame's
    map-point bindings (mids, uv, ur, inv_sigma2) for the final
    trajectory refinement (Tracker.trajectory(refine=True))."""

    timestamp: float
    ref_kf: int
    Tcr: np.ndarray      # frame pose relative to its reference KF
    lost: bool
    obs: Optional[tuple] = None   # (mids i32[K], uv f32[K,2],
                                  #  ur f32[K], inv_sigma2 f32[K])


def obs_snapshot(obs: np.ndarray, xy, ur, inv_sigma2):
    """Compact per-frame binding snapshot for trajectory refinement."""
    rows = np.nonzero(obs >= 0)[0]
    if len(rows) == 0:
        return None
    return (np.asarray(obs)[rows].astype(np.int32),
            host(xy)[rows].astype(np.float32),
            host(ur)[rows].astype(np.float32),
            host(inv_sigma2)[rows].astype(np.float32))


def _se3_interp(Ta: np.ndarray, Tb: np.ndarray, w: float) -> np.ndarray:
    """Geodesic SE3 interpolation (rotation slerp via axis-angle +
    linear translation) between two Twc poses."""
    Ra, Rb = Ta[:3, :3], Tb[:3, :3]
    dR = Rb @ Ra.T
    cos_a = np.clip(0.5 * (np.trace(dR) - 1.0), -1.0, 1.0)
    ang = np.arccos(cos_a)
    if ang < 1e-8:
        Rw = Ra
    else:
        axis = np.asarray([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                           dR[1, 0] - dR[0, 1]]) / (2.0 * np.sin(ang))
        a = w * ang
        K = np.asarray([[0, -axis[2], axis[1]],
                        [axis[2], 0, -axis[0]],
                        [-axis[1], axis[0], 0]])
        Rw = (np.eye(3) + np.sin(a) * K
              + (1 - np.cos(a)) * (K @ K)) @ Ra
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rw.astype(np.float32)
    T[:3, 3] = ((1 - w) * Ta[:3, 3] + w * Tb[:3, 3]).astype(np.float32)
    return T


class Tracker:
    def __init__(self, cfg: SystemConfig, map_store: MapStore,
                 local_mapper=None, dense_mapper=None, relocalizer=None,
                 device=None):
        self.cfg = cfg
        self.map = map_store
        self.device = default_device(device)
        self.local_mapper = local_mapper
        self.dense_mapper = dense_mapper
        self.relocalizer = relocalizer  # place-recognition hook: None
                                        # until the place database is ported
        self.state = TrackingState.NO_IMAGES_YET
        self.only_tracking = False      # localization mode (no mapping)
        self.vo_only = False            # mbVO: tracking on temporal VO
                                        # points only (ref Tracking.h:101)
        self._n_map_inliers = 0
        self._n_vo_candidates = 0

        self.frame_id = -1
        self.async_pose = None   # latest supervised pose (async pipeline)
        self.last_frame: Optional[Frame] = None
        self.last_obs: Optional[np.ndarray] = None   # [N] mp id per kp
        self.last_kf_id = -1
        self.last_frame_id_of_kf = -1
        self.last_reloc_frame_id = -1000000
        self.ref_kf = -1
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.logs: List[FrameLog] = []
        self.matches_inliers = 0
        # timestamps at which tracking failure was declared (async
        # pipeline); frames around them are refinement-suspect
        self.failure_ts: List[float] = []
        # host copies of the current frame's (xy, ur, inv_sigma2), when
        # they arrived with the frame's packed download
        self._host_kp = None

        cam = cfg.camera
        self.max_frames_between_kf = int(cam.fps)
        self.th_depth_m = cam.bf / cam.fx * cam.th_depth  # meters

    def _dev(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def track_rgbd(self, timestamp: float, gray, depth, rgb=None
                   ) -> Optional[np.ndarray]:
        """Process one RGB-D frame ([H, W] gray and depth in metres, numpy
        or tensors); returns Tcw [4,4] or None if lost (reference:
        src/Tracking.cc:300-338 GrabImageRGBD + :449-765 Track)."""
        self.frame_id += 1
        # in the steady OK state the frame is built inside the chain
        return self._track(timestamp, None, rgb=rgb, depth_img=depth,
                           gray=gray)

    def track_frame(self, timestamp: float, f: Frame,
                    rgb=None, depth_img=None) -> Optional[np.ndarray]:
        """Track a pre-built frame (the stereo path builds its frames in
        ops/stereo.py): the motion-model, reference-keyframe and local-map
        stages run one by one instead of as the RGB-D launch chain."""
        self.frame_id += 1
        return self._track(timestamp, f, rgb=rgb, depth_img=depth_img)

    # ------------------------------------------------------------------
    # main state machine
    # ------------------------------------------------------------------

    def _track(self, ts: float, f: Optional[Frame], rgb=None,
               depth_img=None, gray=None):
        self._cur_ts = ts

        def build():
            return frame_mod.build_rgbd_frame(self.cfg, gray, depth_img,
                                              device=self.device)

        # The sync path does not follow fuse merges of last-frame
        # bindings: it rebuilds bindings from the local map every frame.

        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED):
            self.state = TrackingState.NOT_INITIALIZED
            if f is None:
                f = build()
            ok = self._stereo_initialization(ts, f, rgb, depth_img)
            if ok:
                self.state = TrackingState.OK
                self._log_frame(ts, self.last_frame, lost=False)
                return self._pose_of(self.last_frame)
            return None

        ok = False
        done_local = False
        close_counts = None
        if (self.state == TrackingState.OK and self.only_tracking
                and self.vo_only):
            # localization-mode VO (reference mbVO, src/Tracking.cc:521-574)
            if f is None:
                f = build()
            ok_mm, f_mm, obs_mm = (
                self._track_with_motion_model(f)
                if self.velocity is not None
                else (False, f, np.full(f.capacity, -1, dtype=np.int64)))
            ok_rel, f_rel, obs_rel = self._relocalize(f)
            if ok_rel:
                ok, f, cur_obs = True, f_rel, obs_rel
                self.vo_only = False
                self.last_reloc_frame_id = self.frame_id
            elif ok_mm:
                ok, f, cur_obs = True, f_mm, obs_mm
            done_local = self.vo_only  # no local map while VO-only
        elif self.state == TrackingState.OK:
            if self.velocity is not None:
                if f is None and gray is not None:
                    status, f, cur_obs, close_counts = self._track_chain(
                        gray, depth_img)
                    if status == "ok":
                        ok, done_local = True, True
                    elif status == "lm_fail":
                        ok, done_local = False, True
                    # "mm_fail" falls through to the reference-KF path
                else:
                    if f is None:
                        f = build()
                    ok, f, cur_obs = self._track_with_motion_model(f)
            if not ok and not done_local:
                if f is None:
                    f = build()
                cur_obs = np.full(f.capacity, -1, dtype=np.int64)
                ok, f, cur_obs = self._track_reference_keyframe(f)
        else:  # LOST
            if f is None:
                f = build()
            cur_obs = np.full(f.capacity, -1, dtype=np.int64)
            ok, f, cur_obs = self._relocalize(f)
            if ok:
                self.last_reloc_frame_id = self.frame_id

        if not done_local:
            if ok and not self.only_tracking:
                ok, f, cur_obs = self._track_local_map(f, cur_obs)
            elif ok:
                ok2, f2, cur_obs2 = self._track_local_map(f, cur_obs)
                if ok2:
                    f, cur_obs = f2, cur_obs2

        if ok:
            self.state = TrackingState.OK
            # update motion model: velocity = Tcw_cur * Twc_last
            if self.last_frame is not None:
                Rl, tl = self.last_frame.R, self.last_frame.t
                Rv = f.R @ Rl.T
                tv = f.t - Rv @ tl
                self.velocity = (Rv, tv)
            mids = cur_obs[cur_obs >= 0]
            self.map.mp_found[mids] += 1

            if not self.only_tracking and self._need_new_keyframe(
                    f, cur_obs, close_counts):
                f = self._create_new_keyframe(ts, f, cur_obs, rgb,
                                              depth_img)
        else:
            self.state = TrackingState.LOST
            self.velocity = None
            # auto-reset if lost early (reference: src/Tracking.cc:729-737)
            if self.map.n_keyframes() <= self.cfg.tracking.lost_reset_max_kfs:
                self.reset()
                return None

        self.last_frame = f
        self.last_obs = cur_obs
        self._log_frame(ts, f, lost=not ok)
        return self._pose_of(f) if ok else None

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _stereo_initialization(self, ts, f: Frame, rgb, depth_img) -> bool:
        """(reference: src/Tracking.cc:786-838): needs > 500 depth points;
        pose = identity; every depth keypoint becomes a map point."""
        n_depth = int(((f.depth > 0) & f.valid).sum())
        if n_depth < self.cfg.tracking.min_init_stereo_points:
            return False
        f = frame_mod.set_pose(f, np.eye(3, dtype=np.float32),
                               np.zeros(3, dtype=np.float32))
        obs = self._create_points_from_depth(
            f, np.full(f.capacity, -1, dtype=np.int64), max_new=f.capacity)
        kid = self.map.add_keyframe(f, ts, self.frame_id, obs)
        self.map.parent[kid] = -1
        self._finish_new_points(kid, obs)
        self.ref_kf = kid
        self.last_kf_id = kid
        self.last_frame_id_of_kf = self.frame_id
        self.last_frame = f
        self.last_obs = obs
        if self.local_mapper is not None:
            self.local_mapper.process_keyframe(kid)
        if self.dense_mapper is not None and rgb is not None:
            self.dense_mapper.insert_keyframe(kid, rgb, depth_img)
        return True

    # ------------------------------------------------------------------
    # tracking stages
    # ------------------------------------------------------------------

    def _motion_prediction(self):
        Rv, tv = self.velocity
        Rl, tl = self.last_frame.R, self.last_frame.t
        R_pred = (Rv @ Rl).astype(np.float32)
        t_pred = (Rv @ tl + tv).astype(np.float32)
        return R_pred, t_pred, Rl, tl

    def _track_with_motion_model(self, f: Frame):
        """(reference: src/Tracking.cc:1151-1212, with the temporal "VO"
        depth points of UpdateLastFrame :1085-1149 injected into the
        candidate set: unbound close-depth keypoints of the last frame
        constrain the pose but carry no map binding)."""
        tcfg = self.cfg.tracking
        R_pred, t_pred, Rl, tl = self._motion_prediction()

        last_obs = self.last_obs.copy()
        alive = (last_obs >= 0) & self.map.mp_exists[np.clip(last_obs, 0, None)]
        last_obs[~alive] = -1
        last_xw = self.map.mp_pos[np.clip(last_obs, 0, None)]

        # temporal VO points from the last frame's depth
        lf = self.last_frame
        lf_depth = host(lf.depth)
        lf_valid = host(lf.valid)
        has_d = (lf_depth > 0) & lf_valid & ~alive
        if has_d.any():
            close = lf_depth < self.th_depth_m
            order = np.argsort(np.where(has_d, lf_depth, np.inf))
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            vo = has_d & (close | (rank < tcfg.vo_depth_points))
            cam = self.cfg.camera
            xy = host(lf.xy)
            z = np.maximum(lf_depth, 1e-6)
            Xc = np.stack([(xy[:, 0] - cam.cx) / cam.fx * z,
                           (xy[:, 1] - cam.cy) / cam.fy * z, z], axis=1)
            Xw_vo = (Xc - tl[None, :]) @ Rl
            last_xw = np.where(vo[:, None], Xw_vo, last_xw)
            self._n_vo_candidates = int(vo.sum())
        else:
            vo = np.zeros_like(alive)
        last_valid = alive | vo

        th = tcfg.search_window_mono  # RGB-D/mono window (stereo: 7)
        last_xw_d = self._dev(last_xw)
        matches = None
        for radius in (th, 2 * th):
            m = search.search_by_projection_last_frame(
                self.cfg, self._dev(R_pred), self._dev(t_pred),
                last_xw_d, self._dev(last_valid, torch.bool), float(radius),
                lf.level, lf.ur, lf.desc, f, lf.angle)
            if int(m.ok.sum()) >= tcfg.motion_model_min_matches:
                matches = m
                break
        if matches is None:
            return False, f, np.full(f.capacity, -1, dtype=np.int64)

        kp_of = matches.kp_idx
        # multi-start: motion-model prediction + last optimized pose
        res = pose_opt.pose_optimize_multi(
            self.cfg.camera, self._dev(np.stack([R_pred, Rl])),
            self._dev(np.stack([t_pred, tl])), last_xw_d,
            f.xy[kp_of], f.ur[kp_of], f.inv_sigma2[kp_of], matches.ok)
        inl = host(res.inliers)
        n_inl = int(inl.sum())
        if n_inl < 10:
            return False, f, np.full(f.capacity, -1, dtype=np.int64)
        # map-bound inliers drive the localization-mode VO flag
        # (reference mbVO: nmatchesMap < 10, src/Tracking.cc:599-619)
        self._n_map_inliers = int((inl & alive).sum())
        if self.only_tracking:
            self.vo_only = self._n_map_inliers < 10
        f = frame_mod.set_pose(f, host(res.R), host(res.t))
        cur_obs = np.full(f.capacity, -1, dtype=np.int64)
        cur_obs[host(kp_of)[inl]] = last_obs[inl]
        return True, f, cur_obs

    def _track_chain(self, gray, depth_img):
        """Steady-state frame as an asynchronous launch chain with ONE
        blocking download: build frame -> motion-model match+opt ->
        local-map match+opt -> packed result (slam/pipeline_step.py).
        Every host->device upload happens before the first launch.
        Returns (status, frame, cur_obs, close_counts) with status in
        {"ok", "mm_fail", "lm_fail"}; on "mm_fail" the caller runs the
        reference-keyframe fallback (src/Tracking.cc:449-765)."""
        tcfg = self.cfg.tracking
        R_pred, t_pred, Rl, tl = self._motion_prediction()

        last_obs = self.last_obs.copy()
        alive = (last_obs >= 0) & self.map.mp_exists[np.clip(last_obs, 0, None)]
        last_obs[~alive] = -1
        last_xw = self.map.mp_pos[np.clip(last_obs, 0, None)]

        # local candidate set from the previous frame's bindings (1-frame
        # lag; the local map evolves far slower than frame rate)
        cand = self._local_candidates(last_obs)
        if cand is None:
            return "mm_fail", None, None, None
        mids, mids_p, mp_valid = cand
        th = 3.0
        if self.frame_id - self.last_reloc_frame_id < int(self.cfg.camera.fps):
            th = 5.0

        lf = self.last_frame
        # --- uploads ---
        dev = self.map.device_point_arrays(self.device)
        gray_d = self._dev(gray)
        depth_d = self._dev(depth_img)
        R0s = self._dev(np.stack([R_pred, Rl]))
        t0s = self._dev(np.stack([t_pred, tl]))
        last_xw_d = self._dev(last_xw)
        alive_d = self._dev(alive, torch.bool)
        last_obs_d = self._dev(last_obs, torch.int32)
        mids_d = self._dev(mids_p, torch.int64)
        mp_valid_d = self._dev(mp_valid, torch.bool)

        # --- asynchronous launch chain (no host sync until the pack) ---
        f = frame_mod._build_rgbd(self.cfg, gray_d, depth_d)
        mm = pipeline_step.motion_match_step(
            self.cfg, f, last_xw_d, alive_d, lf.level, lf.ur, lf.desc,
            lf.angle, last_obs_d, int(tcfg.motion_model_min_matches),
            (R0s, t0s))
        R0s2 = torch.stack([mm.R, R0s[1]])
        t0s2 = torch.stack([mm.t, t0s[1]])
        lm = pipeline_step.local_map_step(
            self.cfg, f, dev["mp_pos"], dev["mp_desc"], dev["mp_normal"],
            dev["mp_min_dist"], dev["mp_max_dist"], mids_d, mp_valid_d,
            mm.cur_obs, (R0s2, t0s2), float(th))
        packed = torch.cat([pipeline_step.pack_frame_result(mm, lm),
                            f.xy.reshape(-1), f.ur, f.inv_sigma2])
        out = packed.cpu().numpy()              # the ONE blocking download

        # --- unpack + decide ---
        # layout: [5 scalars][R 9][t 3][cur_obs N][visible C]
        #         [xy 2N][ur N][inv_sigma2 N]
        n_mm, n_inl_mm, n_inl_final = out[0], out[1], out[2]
        close_counts = (int(out[3]), int(out[4]))
        N = f.capacity
        C = LOCAL_POINT_CAP
        R = out[5:14].reshape(3, 3).astype(np.float32)
        t = out[14:17].astype(np.float32)
        cur_obs = out[17:17 + N].astype(np.int64)
        visible = out[17 + N:17 + N + C].astype(bool)
        o = 17 + N + C
        self._host_kp = (f.xy, out[o:o + 2 * N].reshape(N, 2),
                         out[o + 2 * N:o + 3 * N], out[o + 3 * N:o + 4 * N])

        if (n_mm < tcfg.motion_model_min_matches) or (n_inl_mm < 10):
            return "mm_fail", f, None, None

        self.map.mp_visible[mids[visible[:len(mids)]]] += 1
        f = frame_mod.set_pose(f, R, t)
        self.matches_inliers = int(n_inl_final)

        min_inl = tcfg.local_map_min_inliers
        if self.frame_id - self.last_reloc_frame_id < int(self.cfg.camera.fps):
            min_inl = tcfg.local_map_min_inliers_after_reloc
        if self.matches_inliers < min_inl:
            return "lm_fail", f, cur_obs, close_counts
        return "ok", f, cur_obs, close_counts

    def _track_reference_keyframe(self, f: Frame):
        """(reference: src/Tracking.cc:1041-1083)."""
        tcfg = self.cfg.tracking
        kid = self.ref_kf
        if kid < 0 or not self.map.kf_exists[kid]:
            return False, f, np.full(f.capacity, -1, dtype=np.int64)
        kf_obs = self.map.kf_obs[kid]
        kf_has_mp = (kf_obs >= 0) & self.map.mp_exists[np.clip(kf_obs, 0, None)]
        idx, keep = search.match_frame_to_kf(
            self.cfg, self._dev(self.map.kf_desc[kid].view(np.int32),
                                torch.int32),
            self._dev(self.map.kf_kp_valid[kid], torch.bool),
            self._dev(kf_has_mp, torch.bool), f)
        keep_np = host(keep)
        if int(keep_np.sum()) < tcfg.ref_kf_min_matches:
            return False, f, np.full(f.capacity, -1, dtype=np.int64)
        mids = np.clip(kf_obs, 0, None)
        # init from last frame pose
        res = pose_opt.pose_optimize(
            self.cfg.camera, self._dev(self.last_frame.R),
            self._dev(self.last_frame.t), self._dev(self.map.mp_pos[mids]),
            f.xy[idx], f.ur[idx], f.inv_sigma2[idx], keep)
        inl = host(res.inliers)
        if int(inl.sum()) < tcfg.ref_kf_min_inliers:
            return False, f, np.full(f.capacity, -1, dtype=np.int64)
        f = frame_mod.set_pose(f, host(res.R), host(res.t))
        cur_obs = np.full(f.capacity, -1, dtype=np.int64)
        cur_obs[host(idx)[inl]] = kf_obs[inl]
        return True, f, cur_obs

    def _local_candidates(self, bindings: np.ndarray):
        """Local-map candidate set from covisibility voting over the
        given keypoint->point bindings (reference: src/Tracking.cc:
        1509-1643 UpdateLocalKeyFrames/Points). Returns (mids, mids
        padded to LOCAL_POINT_CAP, valid mask) or None."""
        local_kfs = self._update_local_keyframes(bindings)
        if len(local_kfs) == 0:
            return None
        self.ref_kf = int(local_kfs[0])

        # local points = union of observations of local KFs
        inc = self.map.observed_mask(local_kfs)
        inc &= self.map.mp_exists
        mids = np.nonzero(inc)[0]
        # exclude points already bound (they stay matched)
        already = set(bindings[bindings >= 0].tolist())
        if len(mids) > LOCAL_POINT_CAP:
            # truncation policy: frustum first, observation count second
            # (ranking purely by count evicts the fresh points of new
            # keyframes; the reference frustum-filters per frame,
            # Tracking.cc:1447-1505)
            pose = self.async_pose
            if pose is None and self.last_frame is not None:
                pose = (self.last_frame.R, self.last_frame.t)
            if pose is not None:
                R, t = pose
                cam = self.cfg.camera
                Xc = self.map.mp_pos[mids] @ R.T + t
                z = np.maximum(Xc[:, 2], 1e-6)
                u = cam.fx * Xc[:, 0] / z + cam.cx
                v = cam.fy * Xc[:, 1] / z + cam.cy
                infront = ((Xc[:, 2] > 0.05)
                           & (u > -64) & (u < cam.width + 64)
                           & (v > -64) & (v < cam.height + 64))
                m_in, m_out = mids[infront], mids[~infront]
                if len(m_in) > LOCAL_POINT_CAP:
                    order = np.argsort(-self.map.mp_obs_count[m_in],
                                       kind="stable")
                    mids = m_in[order[:LOCAL_POINT_CAP]]
                else:
                    order = np.argsort(-self.map.mp_obs_count[m_out],
                                       kind="stable")
                    mids = np.concatenate(
                        [m_in, m_out[order[:LOCAL_POINT_CAP - len(m_in)]]])
            else:
                order = np.argsort(-self.map.mp_obs_count[mids],
                                   kind="stable")
                mids = mids[order[:LOCAL_POINT_CAP]]

        pad = LOCAL_POINT_CAP - len(mids)
        mids_p = np.concatenate([mids, np.zeros(pad, dtype=mids.dtype)])
        mp_valid = np.concatenate([
            ~np.isin(mids, list(already)) if already else np.ones(len(mids), bool),
            np.zeros(pad, dtype=bool)])
        return mids, mids_p, mp_valid

    def _track_local_map(self, f: Frame, cur_obs: np.ndarray):
        """(reference: src/Tracking.cc:1214-1258 + 1447-1643). Fallback
        path; the steady state runs inside _track_chain."""
        tcfg = self.cfg.tracking
        cand = self._local_candidates(cur_obs)
        if cand is None:
            return False, f, cur_obs
        mids, mids_p, mp_valid = cand

        th = 3.0  # RGB-D th=3 (reference: src/Tracking.cc:1496)
        if self.frame_id - self.last_reloc_frame_id < int(self.cfg.camera.fps):
            th = 5.0

        # multi-start inits: current estimate + last frame's optimized pose
        lf = self.last_frame if self.last_frame is not None else f
        dev = self.map.device_point_arrays(self.device)
        res = pipeline_step.local_map_step(
            self.cfg, f, dev["mp_pos"], dev["mp_desc"], dev["mp_normal"],
            dev["mp_min_dist"], dev["mp_max_dist"],
            self._dev(mids_p, torch.int64), self._dev(mp_valid, torch.bool),
            self._dev(cur_obs, torch.int32),
            (self._dev(np.stack([f.R, lf.R])), self._dev(np.stack([f.t, lf.t]))),
            float(th))

        # visible counter: only frustum-passing points (reference
        # increments mnVisible inside isInFrustum, src/Tracking.cc:1486-1490)
        vis = host(res.visible)[: len(mids)]
        self.map.mp_visible[mids[vis]] += 1
        cur_obs2 = host(res.cur_obs).astype(np.int64)
        f = frame_mod.set_pose(f, host(res.R), host(res.t))
        self.matches_inliers = int(res.n_inliers)

        min_inl = tcfg.local_map_min_inliers
        if self.frame_id - self.last_reloc_frame_id < int(self.cfg.camera.fps):
            min_inl = tcfg.local_map_min_inliers_after_reloc
        if self.matches_inliers < min_inl:
            return False, f, cur_obs2
        return True, f, cur_obs2

    def _update_local_keyframes(self, cur_obs) -> np.ndarray:
        """Covisibility voting (reference: src/Tracking.cc:1535-1643):
        K1 = KFs observing current points (vote-sorted), K2 = their best
        covisible neighbors, capped at 80."""
        mids = cur_obs[cur_obs >= 0]
        if len(mids) == 0:
            return np.asarray([], dtype=np.int64)
        votes = self.map.shared_counts(mids)
        k1 = np.nonzero(votes > 0)[0]
        order = np.argsort(-votes[k1], kind="stable")
        k1 = k1[order]
        local = list(k1[: self.cfg.tracking.max_local_keyframes])
        seen = set(local)
        for k in list(local):
            for nb in self.map.covisible_keyframes(k, top_n=10):
                if nb not in seen:
                    local.append(int(nb))
                    seen.add(int(nb))
                    break  # reference adds one best new neighbor per KF
            if len(local) >= self.cfg.tracking.max_local_keyframes:
                break
        return np.asarray(local, dtype=np.int64)

    # ------------------------------------------------------------------
    # relocalization
    # ------------------------------------------------------------------

    def _relocalize(self, f: Frame):
        """(reference: src/Tracking.cc:1645-1806). Candidate KFs come from
        the place-recognition hook when there is one, else every KF.
        Per candidate: descriptor match -> batched EPnP-RANSAC -> pose opt
        -> accept at >= reloc_min_inliers."""
        empty = np.full(f.capacity, -1, dtype=np.int64)
        if self.relocalizer is not None:
            candidates = self.relocalizer.reloc_candidates(f)
        else:
            candidates = self.map.keyframe_ids()
        if len(candidates) == 0:
            return False, f, empty

        for kid in candidates[:8]:
            kf_obs = self.map.kf_obs[kid]
            has_mp = (kf_obs >= 0) & self.map.mp_exists[np.clip(kf_obs, 0, None)]
            idx, keep = search.match_frame_to_kf(
                self.cfg, self._dev(self.map.kf_desc[kid].view(np.int32),
                                    torch.int32),
                self._dev(self.map.kf_kp_valid[kid], torch.bool),
                self._dev(has_mp, torch.bool), f,
                nn_ratio=0.75)
            if int(keep.sum()) < 15:
                continue
            mids = np.clip(kf_obs, 0, None)
            X = self._dev(self.map.mp_pos[mids])
            uv, inv_s2 = f.xy[idx], f.inv_sigma2[idx]
            # the same draws for every candidate of this frame, as the
            # JAX package keys them with PRNGKey(frame_id)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.frame_id)
            pr = epnp.pnp_ransac(self.cfg.camera, X, uv, inv_s2, keep,
                                 generator=gen)
            if not bool(pr.ok):
                continue
            res = pose_opt.pose_optimize(self.cfg.camera, pr.R, pr.t, X, uv,
                                         f.ur[idx], inv_s2, keep)
            inl = host(res.inliers)
            n_good = int(inl.sum())
            min_inl = self.cfg.tracking.reloc_min_inliers
            cur_obs = empty.copy()
            cur_obs[host(idx)[inl]] = mids[inl]
            R_cur, t_cur = host(res.R), host(res.t)

            # projection rescue: widen the search around the optimized
            # pose and re-optimize (reference: src/Tracking.cc:1745-1797,
            # th=10 then th=3)
            if 10 <= n_good < min_inl:
                for th in (10.0, 3.0):
                    n_good, R_cur, t_cur, cur_obs = self._reloc_rescue(
                        f, int(kid), R_cur, t_cur, cur_obs, th)
                    if n_good >= min_inl:
                        break
                    if n_good < 30:  # second pass needs 30..50 (ref :1774)
                        break
            if n_good >= min_inl:
                if self._reloc_aliased(R_cur, t_cur):
                    continue
                f = frame_mod.set_pose(f, R_cur, t_cur)
                self.ref_kf = int(kid)
                return True, f, cur_obs
        return False, f, empty

    def _reloc_aliased(self, R_cur, t_cur) -> bool:
        """Motion-prior gate against an aliased relocalization: within 3 s
        of a failure declared by the async pipeline, the camera is within
        (speed x time lost) of its last supervised pose, so a candidate
        pose far from the constant-velocity prediction is one lattice
        period off on repetitive texture, not a kidnap. The reference
        accepts any >= 50-inlier relocalization (src/Tracking.cc:1800);
        after the window, kidnaps relocalize as there."""
        if not self.failure_ts:
            return False
        prior = self.async_pose
        if prior is None:
            return False
        ts_now = getattr(self, "_cur_ts", None)
        if ts_now is None:
            return False
        lost_dur = ts_now - self.failure_ts[-1]
        if not (0.0 <= lost_dur <= 3.0):
            return False
        Rp, tp = prior
        c_pred = -Rp.T @ tp
        # constant-velocity extrapolation from the recent trajectory log
        recent = [(lg.timestamp, lg.ref_kf, lg.Tcr)
                  for lg in self.logs[-8:] if not lg.lost
                  and lg.ref_kf >= 0 and self.map.kf_exists[lg.ref_kf]]
        if len(recent) >= 2:
            (ta, ra, Ta), (tb, rb, Tb) = recent[0], recent[-1]
            if tb - ta > 1e-3:
                Twa = np.linalg.inv(Ta @ self.map.kf_Tcw(ra))
                Twb = np.linalg.inv(Tb @ self.map.kf_Tcw(rb))
                v = (Twb[:3, 3] - Twa[:3, 3]) / (tb - ta)
                c_pred = Twb[:3, 3] + v * max(ts_now - tb, 0.0)
        jump = float(np.linalg.norm(-R_cur.T @ t_cur - c_pred))
        # uncertainty growth (0.5 m/s unmodelled velocity error) plus a
        # quadratic curvature term (turning at ~3 m/s^2)
        limit = 0.25 + 0.5 * lost_dur + 1.5 * lost_dur * lost_dur
        if jump > limit:
            print(f"[tracking] reloc rejected by motion gate: "
                  f"{jump*100:.0f} cm jump after {lost_dur:.2f}s lost "
                  f"(limit {limit*100:.0f} cm)", file=sys.stderr)
            profiling.PROFILER.add_sample("tracking/reloc_alias_rejected",
                                          jump * 1000.0)
            return True
        return False

    def _reloc_rescue(self, f: Frame, kid: int, R, t, cur_obs, th):
        """One projection-rescue round: match the candidate KF's map
        points into the frame by projection at the current pose estimate
        and re-run pose optimization over the merged bindings."""
        kf_obs = self.map.kf_obs[kid]
        mids = np.unique(kf_obs[kf_obs >= 0])
        mids = mids[self.map.mp_exists[mids]]
        pad = max(256, 1 << int(np.ceil(np.log2(max(len(mids), 1)))))
        mids_p = np.zeros(pad, dtype=np.int64)
        mids_p[:len(mids)] = mids
        mp_valid = np.zeros(pad, dtype=bool)
        mp_valid[:len(mids)] = True
        dev = self.map.device_point_arrays(self.device)
        res = pipeline_step.local_map_step(
            self.cfg, f, dev["mp_pos"], dev["mp_desc"], dev["mp_normal"],
            dev["mp_min_dist"], dev["mp_max_dist"],
            self._dev(mids_p, torch.int64), self._dev(mp_valid, torch.bool),
            self._dev(cur_obs, torch.int32),
            (self._dev(np.stack([R, R])), self._dev(np.stack([t, t]))),
            float(th))
        return (int(res.n_inliers), host(res.R), host(res.t),
                host(res.cur_obs).astype(np.int64))

    # ------------------------------------------------------------------
    # keyframe policy
    # ------------------------------------------------------------------

    def _need_new_keyframe(self, f: Frame, cur_obs,
                           close_counts=None, fid=None) -> bool:
        """(reference: src/Tracking.cc:1261-1358)."""
        if fid is None:
            fid = self.frame_id
        if fid - self.last_reloc_frame_id < self.max_frames_between_kf \
                and self.map.n_keyframes() > self.max_frames_between_kf:
            return False
        n_kfs = self.map.n_keyframes()
        min_obs = 3 if n_kfs > 2 else 2
        # reference-KF tracked points with >= min_obs observations
        ref_obs = self.map.kf_obs[self.ref_kf]
        ref_mids = ref_obs[ref_obs >= 0]
        ref_matches = int((self.map.mp_obs_count[ref_mids] >= min_obs).sum())

        # close-point bookkeeping (RGB-D: c1c / bNeedToInsertClose);
        # the chain delivers the counts in the packed download
        if close_counts is not None:
            tracked_close, untracked_close = close_counts
        else:
            depth = host(f.depth)
            valid = host(f.valid)
            close = (depth > 0) & (depth < self.th_depth_m) & valid
            tracked = cur_obs >= 0
            tracked_close = int((close & tracked).sum())
            untracked_close = int((close & ~tracked).sum())
        need_close = tracked_close < 100 and untracked_close > 70

        # reference: thRefRatio = 0.75, 0.4 only while the map has a single
        # KF (src/Tracking.cc:1317-1324)
        th_ref_ratio = 0.4 if n_kfs < 2 else 0.75
        frames_since_kf = fid - self.last_frame_id_of_kf
        c1a = frames_since_kf >= self.max_frames_between_kf
        c1b = frames_since_kf >= self.cfg.tracking.min_frames_between_kf
        c1c = (self.matches_inliers < ref_matches * 0.25) or need_close
        c2 = ((self.matches_inliers < ref_matches * th_ref_ratio or need_close)
              and self.matches_inliers > 15)
        # view-change trigger (config.kf_rotation_deg/_translation_m)
        c_view = False
        tcfg = self.cfg.tracking
        if (tcfg.kf_rotation_deg > 0 and self.ref_kf >= 0
                and self.map.kf_exists[self.ref_kf]
                and self.matches_inliers > 15):
            pose = self.async_pose
            if pose is None and self.last_frame is not None:
                pose = (self.last_frame.R, self.last_frame.t)
            if pose is not None:
                R, t = pose
                Rr, tr = self.map.kf_R[self.ref_kf], self.map.kf_t[self.ref_kf]
                cos_a = 0.5 * (np.trace(R @ Rr.T) - 1.0)
                ang = np.degrees(np.arccos(np.clip(cos_a, -1.0, 1.0)))
                dist = np.linalg.norm(-R.T @ t - (-Rr.T @ tr))
                c_view = bool(ang >= tcfg.kf_rotation_deg
                              or dist >= tcfg.kf_translation_m)
        return bool(((c1a or c1b or c1c) and c2) or c_view)

    def _create_new_keyframe(self, ts, f: Frame, cur_obs, rgb, depth_img):
        """(reference: src/Tracking.cc:1360-1445)."""
        obs = self._create_points_from_depth(
            f, cur_obs, max_new=self.cfg.tracking.vo_depth_points)
        kid = self.map.add_keyframe(f, ts, self.frame_id, obs)
        self._finish_new_points(kid, obs)
        self.ref_kf = kid
        self.last_kf_id = kid
        self.last_frame_id_of_kf = self.frame_id
        if self.local_mapper is not None:
            self.local_mapper.process_keyframe(kid)
        if self.dense_mapper is not None and rgb is not None:
            self.dense_mapper.insert_keyframe(kid, rgb, depth_img)
        # cur_obs may have been updated with the depth-created points
        np.copyto(cur_obs, obs)
        # a correction during process_keyframe may have moved this KF:
        # return its pose so the caller's frame stays consistent
        return frame_mod.set_pose(f, self.map.kf_R[kid], self.map.kf_t[kid])

    def _create_points_from_depth(self, f: Frame, cur_obs, max_new: int
                                  ) -> np.ndarray:
        """Create map points from RGB-D depth for unmatched keypoints:
        all closer than ThDepth, else the `max_new` closest
        (reference: src/Tracking.cc:1382-1434)."""
        obs = cur_obs.copy()
        depth = host(f.depth)
        valid = host(f.valid)
        cand = (depth > 0) & valid & (obs < 0)
        idxs = np.nonzero(cand)[0]
        if len(idxs) == 0:
            return obs
        order = np.argsort(depth[idxs], kind="stable")
        idxs = idxs[order]
        close = depth[idxs] < self.th_depth_m
        n_take = max(int(close.sum()), min(max_new, len(idxs)))
        take = idxs[:n_take]

        # host-side unprojection (reference: src/Frame.cc:664-678)
        cam = self.cfg.camera
        xy = host(f.xy)
        z = np.maximum(depth, 1e-6)
        Xc = np.stack([(xy[:, 0] - cam.cx) / cam.fx * z,
                       (xy[:, 1] - cam.cy) / cam.fy * z, z], axis=1)
        Xw = (Xc - f.t[None, :]) @ f.R  # R^T (Xc - t), row-vector form
        mids = self.map.alloc_points(len(take))
        self.map.mp_pos[mids] = Xw[take]
        self.map.mp_desc[mids] = host(f.desc).view(np.uint32)[take]
        self.map.mp_level[mids] = host(f.level)[take]
        obs[take] = mids
        return obs

    def _finish_new_points(self, kid: int, obs: np.ndarray):
        """Set normals/depth bands for the points created with this KF."""
        sf = np.asarray(self.cfg.orb.scale_factors, dtype=np.float32)
        mids = obs[obs >= 0]
        new = mids[self.map.mp_first_kf[mids] < 0]
        if len(new) == 0:
            return
        self.map.mp_first_kf[new] = kid
        Twc = self.map.kf_Twc(kid)
        rays = self.map.mp_pos[new] - Twc[:3, 3]
        d = np.linalg.norm(rays, axis=1) + 1e-12
        self.map.mp_normal[new] = rays / d[:, None]
        levels = self.map.mp_level[new]
        self.map.mp_max_dist[new] = d * sf[levels]
        self.map.mp_min_dist[new] = self.map.mp_max_dist[new] / sf[-1]

    # ------------------------------------------------------------------
    # utilities
    # ------------------------------------------------------------------

    def _pose_of(self, f: Frame) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = f.R
        T[:3, 3] = f.t
        return T

    def _kp_host(self, f: Frame):
        """(xy, ur, inv_sigma2) of the frame on the host: the copies that
        came with the frame's packed download, else a download."""
        if self._host_kp is not None and self._host_kp[0] is f.xy:
            return self._host_kp[1:]
        return host(f.xy), host(f.ur), host(f.inv_sigma2)

    def _log_frame(self, ts, f: Frame, lost: bool):
        if self.ref_kf < 0:
            return
        Tcw = self._pose_of(f)
        Trw = self.map.kf_Tcw(self.ref_kf)
        Tcr = Tcw @ np.linalg.inv(Trw)
        obs = None
        if not lost and self.last_obs is not None:
            obs = obs_snapshot(self.last_obs, *self._kp_host(f))
        self.logs.append(FrameLog(timestamp=ts, ref_kf=self.ref_kf,
                                  Tcr=Tcr, lost=lost, obs=obs))

    def reset(self):
        """(reference: src/Tracking.cc:1808-1850)."""
        self.map.__init__(self.map.K, self.map.M, self.map.N)
        self.state = TrackingState.NO_IMAGES_YET
        self.last_frame = None
        self.last_obs = None
        self.velocity = None
        self.async_pose = None
        self.ref_kf = -1
        self.logs.clear()

    def trajectory(self, refine: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Recover the full camera trajectory Twc per frame through the
        (possibly culled) reference keyframes (reference: src/System.cc:
        349-402 SaveTrajectoryTUM). refine=True additionally
        re-localizes every logged frame against the final map in one
        batched pose optimization (see FrameLog.obs)."""
        ts, mats, obs_list, suspect = [], [], [], []
        # suspect window around each declared tracking failure: frames
        # shortly before it carry the degradation that caused it, frames
        # shortly after come from the relocalization replay; both
        # interpolate from anchored neighbors instead
        pre_w = 20.0 / max(self.cfg.camera.fps, 1.0)
        post_w = 45.0 / max(self.cfg.camera.fps, 1.0)
        for log in self.logs:
            if log.lost:
                continue
            ref = log.ref_kf
            Trw = np.eye(4, dtype=np.float32)
            # walk the spanning tree through culled KFs (mTcp chain,
            # Trw = Trw * mTcp as in src/System.cc:349-402; culled
            # keyframes keep their parent, see MapStore.erase_keyframe)
            while ref >= 0 and not self.map.kf_exists[ref]:
                Trw = Trw @ self.map.kf_Tcp[ref]
                ref = self.map.parent[ref]
            if ref < 0:
                continue
            Trw = Trw @ self.map.kf_Tcw(ref)
            Tcw = log.Tcr @ Trw
            ts.append(log.timestamp)
            mats.append(np.linalg.inv(Tcw))
            obs_list.append(log.obs)
            suspect.append(any(-post_w <= ft - log.timestamp <= pre_w
                               for ft in self.failure_ts))
        mats = np.asarray(mats)
        if refine and len(mats) and any(o is not None for o in obs_list):
            mats = self._refine_trajectory(mats, obs_list,
                                           np.asarray(suspect, bool))
        return np.asarray(ts), mats

    REFINE_OBS_CAP = 512   # per-frame observation pad for the batch

    def _refine_trajectory(self, Twc: np.ndarray, obs_list,
                           suspect=None) -> np.ndarray:
        """Batched pose-only re-localization of logged frames against
        the final map (one batched 4x10 LM). Frames whose refined solve
        keeps too few inliers keep or interpolate their composed pose."""
        m = self.map
        F = len(Twc)
        P = self.REFINE_OBS_CAP
        X = np.zeros((F, P, 3), np.float32)
        uv = np.zeros((F, P, 2), np.float32)
        ur = np.full((F, P), -1.0, np.float32)
        is2 = np.ones((F, P), np.float32)
        valid = np.zeros((F, P), bool)
        R0 = np.zeros((F, 3, 3), np.float32)
        t0 = np.zeros((F, 3), np.float32)
        for i, (T, o) in enumerate(zip(Twc, obs_list)):
            R0[i] = T[:3, :3].T
            t0[i] = -T[:3, :3].T @ T[:3, 3]
            if o is None:
                continue
            mids, uv_i, ur_i, is2_i = o
            mids = m.mp_redirect[np.clip(mids, 0, m.M - 1)]
            alive = m.mp_exists[mids]
            k = min(int(alive.sum()), P)
            sel = np.nonzero(alive)[0][:k]
            X[i, :k] = m.mp_pos[mids[sel]]
            uv[i, :k] = uv_i[sel]
            ur[i, :k] = ur_i[sel]
            is2[i, :k] = is2_i[sel]
            valid[i, :k] = True
        res = pose_opt.pose_optimize_batch(
            self.cfg.camera, self._dev(R0), self._dev(t0), self._dev(X),
            self._dev(uv), self._dev(ur), self._dev(is2),
            self._dev(valid, torch.bool))
        R_new = host(res.R)
        t_new = host(res.t)
        n_inl = host(res.n_inliers)
        # anchoring gate, relative to the run's norm: weakly-anchored
        # frames interpolate between solid neighbors instead
        med = float(np.median(n_inl[n_inl > 0])) if (n_inl > 0).any() \
            else 0.0
        ok = n_inl >= max(15.0, 0.25 * med)
        if suspect is not None:
            ok &= ~suspect
        out = Twc.copy()
        Rn = np.swapaxes(R_new[ok], 1, 2)
        out[ok, :3, :3] = Rn
        out[ok, :3, 3] = -np.einsum("fij,fj->fi", Rn, t_new[ok])
        good = ok.copy()
        # kinematic outlier pass: frames deviating from their neighbors'
        # midpoint by more than kin_th are association failures, not
        # motion; iterate to peel multi-frame clusters, replacing them
        # by interpolation between anchored neighbors. The threshold
        # adapts to the sampling rate.
        p0 = out[:, :3, 3]
        med_step = (float(np.median(np.linalg.norm(np.diff(p0, axis=0),
                                                   axis=1)))
                    if F >= 2 else 0.0)
        kin_th = max(0.03, 0.6 * med_step)
        for _pass in range(5):
            if F >= 3:
                p = out[:, :3, 3]
                mid = 0.5 * (p[:-2] + p[2:])
                dev = np.linalg.norm(p[1:-1] - mid, axis=1)
                kin_bad = np.zeros(F, bool)
                kin_bad[1:-1] = dev > kin_th
                good &= ~kin_bad
            good_idx = np.nonzero(good)[0]
            if not (2 <= len(good_idx) < F):
                break
            changed = False
            for i in np.nonzero(~good)[0]:
                p_ = good_idx[good_idx < i]
                n_ = good_idx[good_idx > i]
                if len(p_) == 0 or len(n_) == 0:
                    continue
                a, b = int(p_[-1]), int(n_[0])
                if b - a > 45:    # gap too long to trust interpolation
                    continue
                w = (i - a) / (b - a)
                out[i] = _se3_interp(out[a], out[b], w)
                changed = True
            if not changed:
                break
        return out
