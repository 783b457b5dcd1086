"""SE(3) / SO(3) Lie-group operations on batched tensors.

Port of orb_slam2_map_tpu/geom/se3.py. Poses are (R, t) pairs —
R: [..., 3, 3], t: [..., 3]; tangent vectors are [..., 6] = (rho, phi)
with translation first (g2o se3quat order, reference src/Optimizer.cc).
Leading dimensions broadcast, which replaces the JAX package's vmap.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi):
    """Rodrigues formula, safe at phi ~ 0. [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    K2 = K @ K
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    return _eye_like(K) + a * K + b * K2


def so3_log(R):
    """SO(3) log map: [..., 3, 3] -> [..., 3]. Safe near identity and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    # near 0: w * (1 + theta^2/6) with 2(1-cos) as the smooth theta^2
    theta2_smooth = 2.0 * (1.0 - cos_theta)
    scale = torch.where(
        small,
        1.0 + theta2_smooth / 6.0,
        theta / torch.where(small, torch.ones_like(sin_theta), sin_theta + _EPS),
    )
    w_generic = w * scale[..., None]
    # near pi the vee form degenerates; recover the axis from the diagonal
    near_pi = theta > 3.0
    B = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos_theta[..., None])
                        / (1.0 - cos_theta[..., None] + _EPS), min=0.0)
    axis = torch.sqrt(axis2)
    sign = torch.where(w >= 0, 1.0, -1.0)
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(phi):
    """Left Jacobian of SO(3): J = I + b K + c K^2 (used by se3 exp V)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    K2 = K @ K
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    c = torch.where(theta2 > _EPS, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye_like(K) + b * K + c * K2


def _mv(A, x):
    """Batched matrix-vector product [..., 3, 3] x [..., 3] -> [..., 3]."""
    return (A @ x[..., None])[..., 0]


def se3_exp(xi):
    """se(3) exp: [..., 6] (rho, phi) -> (R [..., 3, 3], t [..., 3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    return R, _mv(V, rho)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def act(R, t, X):
    """Apply pose to points X [..., 3] (R, t broadcast against X)."""
    return _mv(R, X) + t


def identity(batch=(), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch) + (3, 3))
    t = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
    return R, t
