"""Reprojection residuals + analytic Jacobians shared by the optimizers.

Port of orb_slam2_map_tpu/optim/residuals.py (the g2o edge types
EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ and their *OnlyPose
variants). Pose is Tcw = (R, t); left-multiplicative update
exp(xi) * Tcw with xi = (rho, phi); residual e = observation -
projection (g2o sign convention). R and t broadcast against the
observation dimension, so one call serves a batch of poses.
"""

from __future__ import annotations

import torch

from ..geom import se3
from ..geom.camera import PinholeCamera

CHI2_MONO = 5.991    # 2-DoF 95% gate (reference: src/Optimizer.cc:145)
CHI2_STEREO = 7.815  # 3-DoF 95% gate (reference: src/Optimizer.cc:183)


def project_residual(cam: PinholeCamera, R, t, X, uv, ur):
    """Residual [..., N, 3] = (du, dv, dur) and camera-frame points.
    R [..., 1, 3, 3] / t [..., 1, 3] broadcast against X [..., N, 3].
    Monocular observations (ur < 0) get a zero third component."""
    Xc = se3.act(R, t, X)
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    u_r = u - cam.bf * inv_z
    is_stereo = ur >= 0
    e = torch.stack(
        [uv[..., 0] - u, uv[..., 1] - v,
         torch.where(is_stereo, ur - u_r, 0.0)],
        dim=-1,
    )
    return e, Xc


def proj_jacobian_point(cam: PinholeCamera, Xc, is_stereo):
    """d(residual)/d(Xc): [..., 3, 3], with the g2o minus sign."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    row_r = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2],
                        dim=-1)
    row_r = torch.where(is_stereo[..., None], row_r, 0.0)
    return -torch.stack([row_u, row_v, row_r], dim=-2)


def pose_jacobian_from_point_jac(Jpt, Xc):
    """Chain rule to the left-perturbation pose tangent:
    J_pose [..., 3, 6] = Jpt @ [I | -hat(Xc)]."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    dX = torch.cat([eye, -se3.hat(Xc)], dim=-1)
    return Jpt @ dX


def huber_weight(chi2, delta2):
    """Robust reweighting for the Huber kernel at squared threshold
    delta2: 1 inside, delta/r outside (IRLS form of g2o's
    RobustKernelHuber)."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-12))
    delta = torch.sqrt(torch.as_tensor(delta2))
    return torch.where(chi2 <= delta2, 1.0, delta / r)
