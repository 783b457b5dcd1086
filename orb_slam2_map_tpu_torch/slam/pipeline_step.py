"""Per-frame tracking steps: the device hot path.

Port of orb_slam2_map_tpu/slam/pipeline_step.py. The reference's
per-frame hot path (ORB extraction -> projection matching -> pose
optimization -> local-map matching -> pose optimization) runs as a chain
of asynchronous launches with ONE blocking device->host copy per frame:

    _build_rgbd (frame.py)  ->  motion_match_step  ->  local_map_step
                                                    ->  pack_frame_result
                                                    ->  one .cpu()

`fused_frame_step` is the same work as one step over a device-resident
carry (the async pipeline's program). JAX's out-of-range-dropping
scatters become writes into an N+1 buffer whose last slot is cut off.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SystemConfig
from ..geom import camera as cam_mod
from ..geom import se3
from ..optim import pose_opt
from . import frame as frame_mod
from . import search


class TrackStepResult(NamedTuple):
    R: torch.Tensor           # [3,3] optimized Tcw
    t: torch.Tensor           # [3]
    n_matches: torch.Tensor   # int32
    n_inliers: torch.Tensor   # int32
    kp_xy: torch.Tensor       # [N,2] extracted keypoints (for downstream)
    kp_desc: torch.Tensor     # [N,8]
    kp_valid: torch.Tensor    # [N]


class MotionMatchResult(NamedTuple):
    n_matches: torch.Tensor   # int32 (selected window)
    R: torch.Tensor           # [3,3] optimized pose
    t: torch.Tensor           # [3]
    n_inliers: torch.Tensor   # int32
    cur_obs: torch.Tensor     # [N] int32 map-point id per keypoint (-1)


def _set_drop(base: torch.Tensor, idx: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """int32 copy of `base` [n] with values[i] written at idx[i]; rows
    with idx == n are dropped (JAX's .at[].set(mode="drop"))."""
    n = base.shape[0]
    out = torch.cat([base.to(torch.int32),
                     base.new_full((1,), -1, dtype=torch.int32)])
    return out.scatter(0, idx.long(), values.to(torch.int32))[:n]


def _unbound(n: int, device) -> torch.Tensor:
    return torch.full((n,), -1, dtype=torch.int32, device=device)


def motion_match_step(cfg: SystemConfig, f: frame_mod.Frame,
                      last_xw, last_valid, last_level, last_ur,
                      last_desc, last_angle, last_obs_ids,
                      min_matches: int,
                      R_t_inits=None) -> MotionMatchResult:
    """Motion-model phase on a built frame: projection matching at the
    narrow window with an on-device 2x-window retry (reference:
    src/Tracking.cc:1151-1212 reruns a second pass) + multi-start 4x10 LM
    pose optimization. Emits per-keypoint map-point bindings (cur_obs)."""
    R0s, t0s = R_t_inits
    R_pred, t_pred = R0s[0], t0s[0]
    th = float(cfg.tracking.search_window_mono)

    m_narrow = search.search_by_projection_last_frame(
        cfg, R_pred, t_pred, last_xw, last_valid, th,
        last_level, last_ur, last_desc, f, last_angle)
    m_wide = search.search_by_projection_last_frame(
        cfg, R_pred, t_pred, last_xw, last_valid, 2.0 * th,
        last_level, last_ur, last_desc, f, last_angle)
    use_wide = m_narrow.ok.sum() < min_matches
    kp_idx = torch.where(use_wide, m_wide.kp_idx, m_narrow.kp_idx)
    ok = torch.where(use_wide, m_wide.ok, m_narrow.ok)

    res = pose_opt.pose_optimize_multi(cfg.camera, R0s, t0s, last_xw,
                                       f.xy[kp_idx], f.ur[kp_idx],
                                       f.inv_sigma2[kp_idx], ok)
    inl = res.inliers & ok

    # per-keypoint binding: surviving last-frame point ids onto their
    # matched keypoints (failed rows go to the dropped slot N)
    N = f.capacity
    cur_obs = _set_drop(_unbound(N, kp_idx.device),
                        torch.where(inl, kp_idx, N), last_obs_ids)
    return MotionMatchResult(n_matches=ok.sum().to(torch.int32),
                             R=res.R, t=res.t,
                             n_inliers=inl.sum().to(torch.int32),
                             cur_obs=cur_obs)


class LocalMapStepResult(NamedTuple):
    R: torch.Tensor                  # [3,3] final pose
    t: torch.Tensor                  # [3]
    cur_obs: torch.Tensor            # [N] int32 merged + inlier-filtered bindings
    visible: torch.Tensor            # [C] frustum-passing local points
    n_inliers: torch.Tensor          # int32
    n_close_tracked: torch.Tensor    # int32 (keyframe policy, c1c)
    n_close_untracked: torch.Tensor  # int32


def local_map_step(cfg: SystemConfig, f: frame_mod.Frame,
                   mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist,
                   mids, mp_valid, cur_obs_in, R_t_inits,
                   th) -> LocalMapStepResult:
    """Track-local-map phase (reference: src/Tracking.cc:1214-1258):
    gather the local points from the device-resident map columns,
    projection-match them into the frame's unbound keypoints, and run
    the final multi-start pose optimization over every binding.

    mids [C] indexes the full map columns; cur_obs_in [N] carries the
    motion-model bindings (map-point id per keypoint, -1 = free)."""
    kp_taken = cur_obs_in >= 0
    mids = mids.long()
    R0s, t0s = R_t_inits
    m = search.search_by_projection_local(
        cfg, R0s[0], t0s[0], mp_pos[mids], mp_desc[mids], mp_normal[mids],
        mp_min_dist[mids], mp_max_dist[mids], th, mp_valid, f, kp_taken)

    # merge: rows without a match go to the dropped slot N so they can't
    # race an accepted write at the same keypoint
    N = f.capacity
    cur_obs = _set_drop(cur_obs_in, torch.where(m.ok, m.kp_idx, N), mids)
    X_kp = mp_pos[torch.clamp(cur_obs, min=0).long()]
    valid_kp = cur_obs >= 0

    res = pose_opt.pose_optimize_multi(cfg.camera, R0s, t0s, X_kp,
                                       f.xy, f.ur, f.inv_sigma2, valid_kp)
    inl = res.inliers & valid_kp
    cur_out = torch.where(inl, cur_obs, -1)

    # close-point counts for the keyframe policy (reference
    # bNeedToInsertClose, src/Tracking.cc:1296-1306) — computed here so
    # the host never downloads the depth map
    cam = cfg.camera
    th_depth_m = cam.bf / cam.fx * cam.th_depth
    close = (f.depth > 0) & (f.depth < th_depth_m) & f.valid
    tracked = cur_out >= 0
    return LocalMapStepResult(
        R=res.R, t=res.t, cur_obs=cur_out, visible=m.visible,
        n_inliers=inl.sum().to(torch.int32),
        n_close_tracked=(close & tracked).sum().to(torch.int32),
        n_close_untracked=(close & ~tracked).sum().to(torch.int32))


def pack_frame_result(mm: MotionMatchResult, lm: LocalMapStepResult):
    """Everything the host needs from one tracked frame in a single f32
    vector. Layout: [n_matches_mm, n_inl_mm, n_inl_final,
    n_close_tracked, n_close_untracked, R(9 row-major), t(3), cur_obs(N),
    visible(C)]"""
    head = torch.cat([
        torch.stack([mm.n_matches.float(), mm.n_inliers.float(),
                     lm.n_inliers.float(), lm.n_close_tracked.float(),
                     lm.n_close_untracked.float()]),
        lm.R.reshape(-1), lm.t,
    ])
    return torch.cat([head, lm.cur_obs.float(), lm.visible.float()])


class TrackCarry(NamedTuple):
    """Device-resident tracking recurrence: in steady state nothing here
    is downloaded between frames."""

    R: torch.Tensor           # [3,3] last frame's optimized Tcw
    t: torch.Tensor           # [3]
    Rv: torch.Tensor          # [3,3] velocity: Tcw_cur * Twc_last
    tv: torch.Tensor          # [3]
    cur_obs: torch.Tensor     # [N] int32 map-point id per last-frame kp
    last_xy: torch.Tensor     # [N,2] last frame keypoints (undistorted)
    last_ur: torch.Tensor     # [N]
    last_depth: torch.Tensor  # [N]
    last_desc: torch.Tensor   # [N,8] int32 bit-view
    last_level: torch.Tensor  # [N] int32
    last_angle: torch.Tensor  # [N]
    last_valid: torch.Tensor  # [N] bool
    ok: torch.Tensor          # [] bool — last frame tracked successfully

    @classmethod
    def from_numpy(cls, device=None, **arrays) -> "TrackCarry":
        """Carry from numpy arrays (descriptors as uint32 or int32)."""
        def conv(name, a):
            a = np.asarray(a)
            if name == "last_desc" and a.dtype == np.uint32:
                a = a.view(np.int32)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            return torch.as_tensor(a, device=device)

        return cls(**{k: conv(k, arrays[k]) for k in cls._fields})


# packed layout offsets (host side unpacks with these)
PACK_SCALARS = 8  # [n_mm, n_inl_mm, n_inl_final, n_close_tr, n_close_untr,
                  #  ok, n_mm_map, n_vo]


def fused_frame_step(cfg: SystemConfig, carry: TrackCarry,
                     gray_u8, depth_f32, ctrl,
                     mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist,
                     mp_alive, mids, mp_valid, mp_redirect=None):
    """One steady-state frame over the device carry: build frame ->
    motion model (with temporal VO depth points, reference
    src/Tracking.cc:1085-1149 UpdateLastFrame) -> pose opt -> local-map
    match -> final pose opt -> velocity update.

    ctrl: f32[4] = [th_local, min_inliers, use_motion(0/1), depth_scale];
    depth_m = depth * ctrl[3]. mids [C] indexes the published map
    columns; mp_alive masks points culled since the column upload."""
    cam = cfg.camera
    tcfg = cfg.tracking
    dev = carry.R.device
    f = frame_mod._build_rgbd(cfg, gray_u8.to(torch.float32),
                              depth_f32.to(torch.float32) * ctrl[3])
    N = f.capacity

    # ---- motion-model candidate set: bound map points + temporal VO ----
    # follow fuse merges first (the reference's CheckReplacedInLastFrame,
    # src/Tracking.cc:465 + MapPoint::GetReplaced)
    mp_ids = torch.clamp(carry.cur_obs, min=0).long()
    if mp_redirect is not None:
        mp_ids = mp_redirect[mp_ids].long()
    alive = (carry.cur_obs >= 0) & mp_alive[mp_ids]
    pos_bound = mp_pos[mp_ids]

    # temporal VO points from last frame's depth (the ~100 closest depth
    # points constrain the pose but carry no map binding)
    Rwc, twc = se3.inverse(carry.R, carry.t)
    Xc = cam_mod.unproject(cam, carry.last_xy,
                           torch.clamp(carry.last_depth, min=1e-6))
    Xw_vo = se3.act(Rwc, twc, Xc)
    has_d = (carry.last_depth > 0) & carry.last_valid & ~alive
    th_depth_m = cam.bf / cam.fx * cam.th_depth
    close = carry.last_depth < th_depth_m
    depth_key = torch.where(has_d, carry.last_depth, torch.inf)
    rank = torch.argsort(torch.argsort(depth_key, stable=True), stable=True)
    vo_valid = has_d & (close | (rank < tcfg.vo_depth_points))

    last_xw = torch.where(alive[:, None], pos_bound, Xw_vo)
    last_src = alive | vo_valid

    use_motion = ctrl[2] > 0.5
    R_pred = torch.where(use_motion, carry.Rv @ carry.R, carry.R)
    t_pred = torch.where(use_motion, carry.Rv @ carry.t + carry.tv, carry.t)

    th = float(tcfg.search_window_mono)
    m_narrow = search.search_by_projection_last_frame(
        cfg, R_pred, t_pred, last_xw, last_src, th,
        carry.last_level, carry.last_ur, carry.last_desc, f, carry.last_angle)
    m_wide = search.search_by_projection_last_frame(
        cfg, R_pred, t_pred, last_xw, last_src, 2.0 * th,
        carry.last_level, carry.last_ur, carry.last_desc, f, carry.last_angle)
    use_wide = m_narrow.ok.sum() < tcfg.motion_model_min_matches
    kp_idx = torch.where(use_wide, m_wide.kp_idx, m_narrow.kp_idx)
    mok = torch.where(use_wide, m_wide.ok, m_narrow.ok)

    R0s = torch.stack([R_pred, carry.R])
    t0s = torch.stack([t_pred, carry.t])
    res_mm = pose_opt.pose_optimize_multi(
        cam, R0s, t0s, last_xw, f.xy[kp_idx], f.ur[kp_idx],
        f.inv_sigma2[kp_idx], mok)
    inl_mm = res_mm.inliers & mok
    # bindings for map-backed rows only (VO rows stay -1); propagate the
    # REDIRECTED ids so merges stick
    bound_ids = torch.where(carry.cur_obs >= 0, mp_ids, -1)
    cur_obs_mm = _set_drop(_unbound(N, dev),
                           torch.where(inl_mm & alive, kp_idx, N), bound_ids)
    n_mm_map = (inl_mm & alive).sum()
    n_vo = (inl_mm & vo_valid).sum()

    # ---- local-map phase ----
    R0s2 = torch.stack([res_mm.R, carry.R])
    t0s2 = torch.stack([res_mm.t, carry.t])
    lm = local_map_step(cfg, f, mp_pos, mp_desc, mp_normal, mp_min_dist,
                        mp_max_dist, mids, mp_valid & mp_alive[mids.long()],
                        cur_obs_mm, (R0s2, t0s2), ctrl[0])

    ok = ((mok.sum() >= tcfg.motion_model_min_matches)
          & (inl_mm.sum() >= 10)
          & (lm.n_inliers >= ctrl[1].to(torch.int32)))

    # velocity update; freeze pose (zero velocity) on failure so the
    # supervisor can intervene from a sane state
    R_new = torch.where(ok, lm.R, carry.R)
    t_new = torch.where(ok, lm.t, carry.t)
    Rv = torch.where(ok, R_new @ carry.R.T,
                     torch.eye(3, dtype=torch.float32, device=dev))
    tv = torch.where(ok, t_new - (R_new @ carry.R.T) @ carry.t,
                     torch.zeros(3, dtype=torch.float32, device=dev))

    new_carry = TrackCarry(
        R=R_new, t=t_new, Rv=Rv, tv=tv,
        cur_obs=torch.where(ok, lm.cur_obs, -1),
        last_xy=f.xy, last_ur=f.ur, last_depth=f.depth, last_desc=f.desc,
        last_level=f.level, last_angle=f.angle, last_valid=f.valid,
        ok=ok)

    head = torch.cat([
        torch.stack([mok.sum().float(), inl_mm.sum().float(),
                     lm.n_inliers.float(), lm.n_close_tracked.float(),
                     lm.n_close_untracked.float(), ok.float(),
                     n_mm_map.float(), n_vo.float()]),
        lm.R.reshape(-1), lm.t,
    ])
    # the per-frame refinement log (xy/ur/inv_sigma2 of every keypoint)
    # rides in the same packed array: one array, one copy
    packed = torch.cat([head, lm.cur_obs.float(), lm.visible.float(),
                        f.xy.reshape(-1), f.ur, f.inv_sigma2])
    return new_carry, packed, f


def tracking_step(cfg: SystemConfig, gray, depth,
                  last_xw, last_valid, last_level, last_ur, last_desc,
                  R_pred, t_pred) -> TrackStepResult:
    """Single-step motion-model tracking (extraction + match + pose opt)."""
    f = frame_mod._build_rgbd(cfg, gray, depth)
    m = search.search_by_projection_last_frame(
        cfg, R_pred, t_pred, last_xw, last_valid,
        float(cfg.tracking.search_window_mono),
        last_level, last_ur, last_desc, f)
    res = pose_opt.pose_optimize(cfg.camera, R_pred, t_pred, last_xw,
                                 f.xy[m.kp_idx], f.ur[m.kp_idx],
                                 f.inv_sigma2[m.kp_idx], m.ok)
    return TrackStepResult(R=res.R, t=res.t,
                           n_matches=m.ok.sum().to(torch.int32),
                           n_inliers=res.n_inliers,
                           kp_xy=f.xy, kp_desc=f.desc, kp_valid=f.valid)
