"""Frame: per-image fixed-capacity feature container.

Port of orb_slam2_map_tpu/slam/frame.py (reference: src/Frame.cc): ORB
extraction, keypoint undistortion (:404-434) and RGB-D pseudo-stereo
mvuRight = u - bf/d (:641-662).

The feature columns are tensors on the frame's device. The pose (R, t)
is host state — numpy float32 — because the tracker decides on it every
frame, and device programs take poses as explicit arguments; keeping it
on the host spares a device round trip per read.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import SystemConfig
from ..geom import camera as cam_mod
from ..geom import se3
from ..ops import orb


class Frame(NamedTuple):
    xy: torch.Tensor          # [N, 2] undistorted pixel coords
    response: torch.Tensor    # [N]
    angle: torch.Tensor       # [N]
    level: torch.Tensor       # [N] int32
    desc: torch.Tensor        # [N, 8] int32 bit-view of packed uint32
    valid: torch.Tensor       # [N] bool
    ur: torch.Tensor          # [N] right-image u; -1 if unavailable
    depth: torch.Tensor       # [N] depth (m); -1 if unavailable
    inv_sigma2: torch.Tensor  # [N] 1 / (scale_sigma2 at kp level)
    # pose Tcw (world -> camera), host numpy; identity until tracked
    R: np.ndarray             # [3, 3]
    t: np.ndarray             # [3]

    @property
    def capacity(self):
        return self.xy.shape[0]


def _inv_sigma2_table(cfg: SystemConfig) -> np.ndarray:
    return np.asarray([1.0 / s for s in cfg.orb.level_sigma2], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _inv_sigma2_on(cfg: SystemConfig, device: torch.device) -> torch.Tensor:
    """The table on a device, cached: a host->device copy in the middle
    of a frame would wait for every queued launch."""
    return torch.as_tensor(_inv_sigma2_table(cfg), device=device)


def _identity_pose():
    return np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32)


def _undistorted(cfg: SystemConfig, kp: orb.Keypoints):
    cam = cfg.camera
    return cam_mod.undistort_points(cam, kp.xy) if cam.has_distortion else kp.xy


def _build_rgbd(cfg: SystemConfig, gray: torch.Tensor,
                depth_img: torch.Tensor) -> Frame:
    """RGB-D frame from [H, W] float32 gray and depth (m) tensors."""
    kp = orb.extract(gray, cfg.orb)
    cam = cfg.camera
    xy_und = _undistorted(cfg, kp)

    # depth lookup at raw (distorted) keypoint coords, as the reference
    # samples mImDepth at the original keypoint (src/Frame.cc:649)
    xi = torch.clamp(kp.xy[:, 0].to(torch.int64), 0, cam.width - 1)
    yi = torch.clamp(kp.xy[:, 1].to(torch.int64), 0, cam.height - 1)
    d = depth_img[yi, xi]
    has_depth = (d > 0.0) & kp.valid
    ur = torch.where(has_depth, xy_und[:, 0] - cam.bf / torch.clamp(d, min=1e-6),
                     -1.0)
    depth = torch.where(has_depth, d, -1.0)

    inv_s2 = _inv_sigma2_on(cfg, gray.device)[kp.level]
    R, t = _identity_pose()
    return Frame(xy=xy_und, response=kp.response, angle=kp.angle,
                 level=kp.level, desc=kp.desc, valid=kp.valid,
                 ur=ur, depth=depth, inv_sigma2=inv_s2, R=R, t=t)


def build_rgbd_frame(cfg: SystemConfig, gray, depth_img, device=None) -> Frame:
    """RGB-D frame (reference: src/Frame.cc:119-170 ctor). gray/depth are
    numpy arrays or tensors; device defaults to the tensors' device, or
    the CPU for numpy input."""
    gray = torch.as_tensor(gray, dtype=torch.float32, device=device)
    depth_img = torch.as_tensor(depth_img, dtype=torch.float32,
                                device=gray.device)
    return _build_rgbd(cfg, gray, depth_img)


def _build_mono(cfg: SystemConfig, gray: torch.Tensor) -> Frame:
    kp = orb.extract(gray, cfg.orb)
    n = kp.xy.shape[0]
    inv_s2 = _inv_sigma2_on(cfg, gray.device)[kp.level]
    R, t = _identity_pose()
    return Frame(xy=_undistorted(cfg, kp), response=kp.response,
                 angle=kp.angle, level=kp.level, desc=kp.desc, valid=kp.valid,
                 ur=torch.full((n,), -1.0, device=gray.device),
                 depth=torch.full((n,), -1.0, device=gray.device),
                 inv_sigma2=inv_s2, R=R, t=t)


def build_mono_frame(cfg: SystemConfig, gray, device=None) -> Frame:
    """Monocular frame (reference: src/Frame.cc:172-227 ctor)."""
    return _build_mono(cfg, torch.as_tensor(gray, dtype=torch.float32,
                                            device=device))


def set_pose(f: Frame, R, t) -> Frame:
    return f._replace(R=np.asarray(R, dtype=np.float32),
                      t=np.asarray(t, dtype=np.float32))


def unproject_valid(cfg: SystemConfig, f: Frame):
    """World positions of keypoints with depth: [N, 3] + mask
    (reference: src/Frame.cc:664-678 UnprojectStereo)."""
    dev = f.xy.device
    Xc = cam_mod.unproject(cfg.camera, f.xy, torch.clamp(f.depth, min=1e-6))
    Rwc, twc = se3.inverse(torch.as_tensor(f.R, device=dev),
                           torch.as_tensor(f.t, device=dev))
    Xw = se3.act(Rwc, twc, Xc)
    return Xw, (f.depth > 0) & f.valid
