"""Projection-guided map-point -> frame matching.

Port of orb_slam2_map_tpu/slam/search.py: local-map points into the
current frame (reference: src/ORBmatcher.cc:45-129 + the frustum check
src/Frame.cc:269-325), last-frame points into the current frame
(:1328-1470), keyframe points into a frame (:159-288) and windowed
frame-to-frame matching for monocular initialization (:405-520). Each is
batched frustum/projection -> gates -> gated NN (the hand kernel on
CUDA) -> duplicate resolution. Nothing here reads a value back to the
host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import torch

from ..config import SystemConfig
from ..geom import camera as cam_mod
from ..geom import se3
from ..ops import matching
from .frame import Frame


class ProjMatches(NamedTuple):
    """Per-map-point match into the frame's keypoint array."""

    kp_idx: torch.Tensor   # [M] int64 matched keypoint (undefined if !ok)
    dist: torch.Tensor     # [M] float32 Hamming distance
    ok: torch.Tensor       # [M] bool
    visible: torch.Tensor  # [M] bool — passed the frustum test (for
                           # mp_visible counters, ref src/Tracking.cc:1470)


@functools.lru_cache(maxsize=None)
def _scale_factors(cfg: SystemConfig, device: torch.device) -> torch.Tensor:
    """Per-level scale factors on a device, cached: a host->device copy
    in the middle of a frame would wait for every queued launch."""
    return torch.tensor([cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)],
                        dtype=torch.float32, device=device)


def search_by_projection_local(cfg: SystemConfig, R, t,
                               mp_pos, mp_desc, mp_normal,
                               mp_min_dist, mp_max_dist, th,
                               mp_valid, f: Frame,
                               kp_taken) -> ProjMatches:
    """Local-map points -> current frame (reference: src/Tracking.cc:
    1447-1507 SearchLocalPoints + src/ORBmatcher.cc:45-129).

    Gates: frustum (z>0, in-image margin, distance band, viewing angle
    cos > 0.5), predicted-scale window radius, level band [pred-1, pred],
    descriptor <= TH_HIGH with NN ratio 0.8. kp_taken masks keypoints the
    frame already matched (motion-model matches are kept).
    """
    cam = cfg.camera
    dev = mp_pos.device
    n_levels = cfg.orb.n_levels
    log_sf = float(np.log(np.float32(cfg.orb.scale_factor)))
    scale_factors = _scale_factors(cfg, dev)

    Xc = se3.act(R, t, mp_pos)
    z = Xc[..., 2]
    uv = cam_mod.project(cam, Xc)
    _, twc = se3.inverse(R, t)
    rays = mp_pos - twc[None, :]
    dist = torch.sqrt(torch.sum(rays * rays, dim=-1))
    view_cos = torch.sum(rays * mp_normal, dim=-1) / torch.clamp(dist, min=1e-9)

    visible = (
        mp_valid
        & (z > 0.05)
        & cam_mod.in_image(cam, uv, margin=1.0)
        & (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
        & (view_cos > 0.5)
    )

    # predicted level (reference: src/MapPoint.cc:385-394 PredictScale)
    ratio = torch.clamp(mp_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred_level = torch.clamp(
        torch.ceil(torch.log(ratio) / log_sf).to(torch.int64),
        0, n_levels - 1)
    # radius: 2.5 if viewCos < 0.998 else 4.0, scaled by level
    # (reference: src/ORBmatcher.cc:131-137 RadiusByViewingCos)
    base_r = torch.where(view_cos > 0.998, 2.5, 4.0) * th
    radius = base_r * scale_factors[pred_level]

    gate = (
        matching.window_gate(uv, f.xy, radius)
        & matching.level_gate(pred_level, f.level, min_delta=-1, max_delta=0)
        & visible[:, None]
        & f.valid[None, :]
        & ~kp_taken[None, :]
    )
    res = matching.gated_nn(mp_desc, f.desc, gate, max_dist=100.0, ratio=0.8)
    ok = res.ok & visible
    keep = matching.resolve_duplicates(res.idx, res.dist, ok, f.capacity)
    return ProjMatches(kp_idx=res.idx, dist=res.dist, ok=keep, visible=visible)


def search_by_projection_last_frame(cfg: SystemConfig, R, t,
                                    last_xw, last_valid, th: float,
                                    last_level, last_ur, last_desc,
                                    f: Frame,
                                    last_angle=None) -> ProjMatches:
    """Last-frame tracked points -> current frame for the motion model
    (reference: src/ORBmatcher.cc:1328-1470 SearchByProjection(F, LastF)),
    with the symmetric level band [l-1, l+1] around the last observation
    and the stereo right-coordinate gate for RGB-D points."""
    cam = cfg.camera
    scale_factors = _scale_factors(cfg, last_xw.device)
    Xc = se3.act(R, t, last_xw)
    z = Xc[..., 2]
    uv = cam_mod.project(cam, Xc)
    visible = last_valid & (z > 0.05) & cam_mod.in_image(cam, uv, margin=1.0)

    radius = th * scale_factors[last_level]
    ur_pred = uv[:, 0] - cam.bf / torch.clamp(z, min=1e-6)
    gate = (
        matching.window_gate(uv, f.xy, radius)
        & matching.level_gate(last_level, f.level, min_delta=-1, max_delta=1)
        & visible[:, None]
        & f.valid[None, :]
    )
    has_stereo = last_ur >= 0
    gate &= (~has_stereo[:, None]) | matching.stereo_gate(ur_pred, f.ur, radius)
    res = matching.gated_nn(last_desc, f.desc, gate, max_dist=100.0)
    ok = res.ok & visible
    if last_angle is not None:
        # rotation-histogram consistency, as the reference's motion-model
        # matcher applies (src/ORBmatcher.cc:1435-1464, check_orientation)
        ok = matching.rotation_consistency(last_angle, f.angle, res.idx, ok)
    keep = matching.resolve_duplicates(res.idx, res.dist, ok, f.capacity)
    return ProjMatches(kp_idx=res.idx, dist=res.dist, ok=keep, visible=visible)


def match_frame_to_kf(cfg: SystemConfig, kf_desc, kf_valid, kf_has_mp,
                      f: Frame, nn_ratio: float = 0.7):
    """Reference-keyframe tracking match (reference: src/ORBmatcher.cc:
    159-288 SearchByBoW(KF, F)) over the full [N, N] gated distance.
    Returns per-KF-keypoint match into frame: (kp_idx [N], ok [N])."""
    gate = (kf_valid & kf_has_mp)[:, None] & f.valid[None, :]
    res = matching.gated_nn(kf_desc, f.desc, gate, max_dist=50.0,
                            ratio=nn_ratio)
    keep = matching.resolve_duplicates(res.idx, res.dist, res.ok, f.capacity)
    return res.idx, keep


def match_descriptors_windowed(cfg: SystemConfig, desc_a, xy_a, valid_a,
                               desc_b, xy_b, valid_b, radius,
                               angle_a=None, angle_b=None):
    """Windowed descriptor match used by monocular initialization
    (reference: src/ORBmatcher.cc:405-520 SearchForInitialization)."""
    gate = (matching.window_gate(xy_a, xy_b, radius)
            & valid_a[:, None] & valid_b[None, :])
    res = matching.gated_nn(desc_a, desc_b, gate, max_dist=50.0, ratio=0.9)
    ok = res.ok
    if angle_a is not None:
        ok = matching.rotation_consistency(angle_a, angle_b, res.idx, ok)
    keep = matching.resolve_duplicates(res.idx, res.dist, ok, xy_b.shape[0])
    return res.idx, keep

