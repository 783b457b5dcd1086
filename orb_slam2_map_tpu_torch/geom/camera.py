"""Pinhole camera model with radial-tangential distortion.

Port of orb_slam2_map_tpu/geom/camera.py (reference: src/Frame.cc:404-434
undistortion, src/Frame.cc:269-325 frustum check). All ops are batched
tensor functions over point arrays; intrinsics are Python floats.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Static camera intrinsics. Fields mirror the reference YAML keys
    (Examples/RGB-D/TUM1.yaml:8-35)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    bf: float = 40.0        # stereo baseline * fx
    fps: float = 30.0
    th_depth: float = 50.0  # close/far point threshold, in baselines

    @property
    def K(self):
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def has_distortion(self):
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def distort(cam: PinholeCamera, xn):
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: PinholeCamera, uv, iters: int = 8):
    """Iteratively invert distortion for pixel coords [..., 2].

    Matches cv::undistortPoints' fixed-point iteration used by the
    reference's Frame::UndistortKeyPoints (src/Frame.cc:404-434).
    """
    # intrinsics as Python scalars: no host->device copy mid-frame
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    x = xd
    for _ in range(iters):
        x_, y_ = x[..., 0], x[..., 1]
        r2 = x_ * x_ + y_ * y_
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = torch.stack(
            [
                2 * cam.p1 * x_ * y_ + cam.p2 * (r2 + 2 * x_ * x_),
                cam.p1 * (r2 + 2 * y_ * y_) + 2 * cam.p2 * x_ * y_,
            ],
            dim=-1,
        )
        x = (xd - dx) / radial[..., None]
    return torch.stack([x[..., 0] * cam.fx + cam.cx,
                        x[..., 1] * cam.fy + cam.cy], dim=-1)


def project(cam: PinholeCamera, Xc):
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (no
    distortion: the pipeline works on undistorted keypoints)."""
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def unproject(cam: PinholeCamera, uv, depth):
    """Pixel coords [..., 2] + depth [...] -> camera-frame points [..., 3]
    (reference: src/Frame.cc:664-678 UnprojectStereo)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def in_image(cam: PinholeCamera, uv, margin: float = 0.0):
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )
