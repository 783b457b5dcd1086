"""Sim(3) operations for loop closing and essential-graph optimization.

Port of orb_slam2_map_tpu/geom/sim3.py, replacing g2o::Sim3 /
VertexSim3Expmap (+ the `_fix_scale` stereo/RGB-D mode) used by the
reference's loop closer (reference: src/Optimizer.cc:781-1241,
src/Sim3Solver.cc). A Sim3 element is carried as (R [...,3,3], t [...,3],
s [...]) acting as X -> s * R @ X + t. Tangent is [..., 7] = (rho, phi,
sigma) with sigma = log s. Every function is written with torch.where
branches (no Python control flow on values), so torch.func.jacfwd and
vmap go through it (optim/pose_graph.py).
"""

from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def identity(batch=(), dtype=torch.float32, device=None):
    R, t = se3.identity(batch, dtype, device)
    return R, t, torch.ones(tuple(batch), dtype=dtype, device=device)


def act(R, t, s, X):
    return s[..., None] * _mv(R, X) + t


def compose(Ra, ta, sa, Rb, tb, sb):
    """(a) * (b): X -> sa Ra (sb Rb X + tb) + ta."""
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def exp(xi):
    """sim(3) exp: [..., 7] (rho, phi, sigma) -> (R, t, s), with the
    closed-form W matrix (Strasdat's thesis) and its small-angle /
    small-scale limits. The scalar coefficients keep a trailing axis of
    1, so that one tangent is never a 0-dim tensor (under torch.func
    transforms its arithmetic with Python floats promotes to float64)."""
    rho, phi, sig = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    es = torch.exp(sig)
    R = se3.so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = se3.hat(phi)
    K2 = K @ K

    small_sig = torch.abs(sig) < 1e-5
    small_theta = theta < 1e-5
    one = torch.ones_like(sig)
    C = torch.where(small_sig, 1.0 + sig / 2.0,
                    (es - 1.0) / torch.where(small_sig, one, sig))

    sig2 = sig * sig
    t2s2 = theta2 + sig2

    def _safe(x, d):
        return x / torch.where(torch.abs(d) < _EPS, torch.ones_like(d), d)

    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)

    a_gen = _safe(es * sin_t * sig + (1.0 - es * cos_t) * theta,
                  theta * t2s2)
    b_gen = _safe(C - _safe((es * cos_t - 1.0) * sig + es * sin_t * theta,
                            t2s2), theta2)
    # sigma ~ 0 limits
    a_sig0 = _safe(1.0 - cos_t, theta2)
    b_sig0 = _safe(theta - sin_t, theta2 * theta)
    # theta ~ 0 limits
    a_th0 = torch.where(small_sig, 0.5 + sig / 6.0,
                        _safe(es * (sig - 1.0) + 1.0, sig2))
    b_th0 = torch.where(small_sig, 1.0 / 6.0 + sig / 24.0,
                        _safe(es * (0.5 * sig2 - sig + 1.0) - 1.0,
                              sig2 * sig))

    A = torch.where(small_theta, a_th0, torch.where(small_sig, a_sig0, a_gen))
    B = torch.where(small_theta, b_th0, torch.where(small_sig, b_sig0, b_gen))

    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    W = C[..., None] * eye + A[..., None] * K + B[..., None] * K2
    return R, _mv(W, rho), es[..., 0]


def _solve3(W, b):
    """W^-1 b for [..., 3, 3] W by the adjugate (Cramer's rule): plain
    elementwise ops, so no solver call and no host synchronisation on a
    card (the JAX package uses jnp.linalg.solve; W here is well
    conditioned: I-like, scaled by (e^sigma - 1) / sigma)."""
    c0, c1, c2 = W[..., :, 0], W[..., :, 1], W[..., :, 2]
    x12, x20, x01 = (torch.cross(c1, c2, dim=-1), torch.cross(c2, c0, dim=-1),
                     torch.cross(c0, c1, dim=-1))
    det = torch.sum(c0 * x12, dim=-1, keepdim=True)
    return torch.stack([torch.sum(x12 * b, -1), torch.sum(x20 * b, -1),
                        torch.sum(x01 * b, -1)], dim=-1) / det


def log(R, t, s):
    """sim(3) log: -> [..., 7]. Inverse of exp: solves W rho = t, with W
    probed column by column through exp (t = W rho)."""
    phi = se3.so3_log(R)
    sigma = torch.log(s)[..., None]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    cols = []
    for i in range(3):
        rho_i = eye[i].expand(phi.shape)
        _, t_i, _ = exp(torch.cat([rho_i, phi, sigma], dim=-1))
        cols.append(t_i)
    rho = _solve3(torch.stack(cols, dim=-1), t)
    return torch.cat([rho, phi, sigma], dim=-1)


def from_se3(R, t):
    return R, t, torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)


def to_se3(R, t, s):
    """Project Sim3 to SE3 the way the reference recovers poses after
    essential-graph optimization: R unchanged, t /= s
    (reference: src/Optimizer.cc:1017-1021)."""
    return R, t / s[..., None]
