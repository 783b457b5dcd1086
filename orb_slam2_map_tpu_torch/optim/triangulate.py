"""Batched two-view triangulation + acceptance gating.

Port of orb_slam2_map_tpu/optim/triangulate.py, replacing the DLT-SVD
triangulation inside LocalMapping::CreateNewMapPoints (reference:
src/LocalMapping.cc:322-331), batched over all candidate matches at once.
"""

from __future__ import annotations

import torch

from ..geom import se3
from ..geom.camera import PinholeCamera


def triangulate_dlt(P1, P2, x1, x2):
    """Linear DLT triangulation, batched. P1, P2: [3, 4] projection
    matrices; x1, x2: [N, 2] pixel coords consistent with them. Returns
    [N, 3] points.

    Inhomogeneous solve A[:, :3] X = -A[:, 3] through the 3x3 normal
    equations and the closed-form adjugate (the JAX package's choice: the
    reference's homogeneous 4x4 SVD agrees to first order for finite
    points)."""
    A = torch.stack([
        x1[:, 0:1] * P1[2] - P1[0],
        x1[:, 1:2] * P1[2] - P1[1],
        x2[:, 0:1] * P2[2] - P2[0],
        x2[:, 1:2] * P2[2] - P2[1],
    ], dim=1)                                             # [N, 4, 4]
    M = A[..., :3]
    b = -A[..., 3]
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    AtA = M.transpose(-1, -2) @ M + 1e-9 * eye
    Atb = (M.transpose(-1, -2) @ b[..., None])[..., 0]
    return _solve3x3(AtA, Atb)


def _solve3x3(S, b):
    """Closed-form symmetric 3x3 solve via the adjugate, batched over the
    leading dimension."""
    c00 = S[:, 1, 1] * S[:, 2, 2] - S[:, 1, 2] * S[:, 2, 1]
    c01 = S[:, 0, 2] * S[:, 2, 1] - S[:, 0, 1] * S[:, 2, 2]
    c02 = S[:, 0, 1] * S[:, 1, 2] - S[:, 0, 2] * S[:, 1, 1]
    c10 = S[:, 1, 2] * S[:, 2, 0] - S[:, 1, 0] * S[:, 2, 2]
    c11 = S[:, 0, 0] * S[:, 2, 2] - S[:, 0, 2] * S[:, 2, 0]
    c12 = S[:, 0, 2] * S[:, 1, 0] - S[:, 0, 0] * S[:, 1, 2]
    c20 = S[:, 1, 0] * S[:, 2, 1] - S[:, 1, 1] * S[:, 2, 0]
    c21 = S[:, 0, 1] * S[:, 2, 0] - S[:, 0, 0] * S[:, 2, 1]
    c22 = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
    det = S[:, 0, 0] * c00 + S[:, 0, 1] * c10 + S[:, 0, 2] * c20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return (adj @ b[..., None])[..., 0] * inv_det[:, None]


def projection_matrix(cam: PinholeCamera, R, t):
    """K [R | t] as a [3, 4] matrix."""
    return cam.K.to(R.device) @ torch.cat([R, t[:, None]], dim=1)


def acceptance_gates(cam: PinholeCamera, R1, t1, R2, t2, X, uv1, uv2,
                     ur1, ur2, sigma2_1, sigma2_2,
                     chi2_mono: float = 5.991, chi2_stereo: float = 7.8):
    """Depth/reprojection/scale gates for new map points (reference:
    src/LocalMapping.cc:349-431). Returns bool [N]."""
    Xc1 = se3.act(R1, t1, X)
    Xc2 = se3.act(R2, t2, X)
    ok = (Xc1[..., 2] > 0) & (Xc2[..., 2] > 0)

    def reproj_ok(Xc, uv, ur, sigma2):
        z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
        u = cam.fx * Xc[..., 0] / z + cam.cx
        v = cam.fy * Xc[..., 1] / z + cam.cy
        e2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
        is_stereo = ur >= 0
        u_r = u - cam.bf / z
        e2s = e2 + torch.where(is_stereo, (u_r - ur) ** 2, 0.0)
        th = torch.where(is_stereo, chi2_stereo, chi2_mono)
        return torch.where(is_stereo, e2s, e2) <= th * sigma2

    ok &= reproj_ok(Xc1, uv1, ur1, sigma2_1)
    ok &= reproj_ok(Xc2, uv2, ur2, sigma2_2)

    # scale consistency: distance ratio against the level-sigma ratio
    c1 = se3.inverse(R1, t1)[1]
    c2 = se3.inverse(R2, t2)[1]
    d1 = torch.linalg.norm(X - c1, dim=-1)
    d2 = torch.linalg.norm(X - c2, dim=-1)
    ok &= (d1 > 1e-6) & (d2 > 1e-6)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_octave = torch.sqrt(sigma2_1 / torch.clamp(sigma2_2, min=1e-12))
    ratio_factor = 1.5 * 1.2  # 1.5 * scaleFactor (reference: :242)
    ok &= (ratio_dist * ratio_factor > ratio_octave) & (
        ratio_dist < ratio_octave * ratio_factor)
    return ok
