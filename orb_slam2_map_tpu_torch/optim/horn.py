"""Closed-form absolute orientation (Horn) with optional scale, batched.

Port of orb_slam2_map_tpu/optim/horn.py, replacing Sim3Solver::
ComputeSim3's Horn-1987 quaternion method (reference: src/Sim3Solver.cc:
226-337) and the ICP pose step inside EPnP (reference: src/PnPsolver.cc:
569-627), in the Umeyama SVD form (the same optimum).

The SVD's singular vectors are unique only up to sign (and, for repeated
singular values, up to a rotation), so LAPACK, cuSOLVER and XLA may
return different U, Vh; R = U S Vh is the same for every choice whenever
the covariance has rank >= 2, because S carries the sign of
det(U) det(Vh).
"""

from __future__ import annotations

import torch


def absolute_orientation(A, B, weights=None, with_scale: bool = False):
    """Find (R, t, s) minimizing sum w_i || B_i - (s R A_i + t) ||^2.

    A, B: [..., N, 3] paired point sets (batched over leading dims).
    Returns R [..., 3, 3], t [..., 3], s [...].
    """
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    wsum = weights.sum(dim=-1, keepdim=True)
    w = weights / torch.clamp(wsum, min=1e-12)
    mu_a = torch.einsum("...n,...ni->...i", w, A)
    mu_b = torch.einsum("...n,...ni->...i", w, B)
    Ac = A - mu_a[..., None, :]
    Bc = B - mu_b[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, Bc, Ac)  # B A^T
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.ones(cov.shape[:-2] + (3,), dtype=A.dtype, device=A.device)
    S[..., 2] = torch.sign(det) + (det == 0).to(A.dtype)
    R = torch.einsum("...ik,...k,...kj->...ij", U, S, Vt)
    if with_scale:
        var_a = torch.einsum("...n,...ni,...ni->...", w, Ac, Ac)
        s = torch.einsum("...k,...k->...", D, S) / torch.clamp(var_a, min=1e-12)
    else:
        s = torch.ones(cov.shape[:-2], dtype=A.dtype, device=A.device)
    t = mu_b - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_a)
    return R, t, s
