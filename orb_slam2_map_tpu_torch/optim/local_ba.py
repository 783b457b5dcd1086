"""Local bundle adjustment with an explicit Schur complement.

Port of orb_slam2_map_tpu/optim/local_ba.py, replacing
Optimizer::LocalBundleAdjustment (reference: src/Optimizer.cc:453-778):
covisibility-1-ring keyframes free, boundary observers fixed, landmarks
marginalized (the g2o Schur trick), Huber kernels sqrt(5.991) /
sqrt(7.815), a 5-then-10-iteration schedule with outlier pruning in
between.

The local problem is dense and padded: <= K free cameras x P points, with
observations in a masked [P, K] grid (and [P, F] for the fixed cameras),
so every Jacobian product, the per-point 3x3 Hessians, the 6x6 camera
blocks and the reduction S = Hcc - W Hll^-1 W^T are einsums. The reduced
[6K, 6K] system (96 x 96 at K = 16) goes to torch.linalg.solve_ex, which
reports a singular system in its info output instead of synchronising
with the host to raise; a non-finite step is rejected by the LM test.
The LM accept/reject decisions stay on the device as masks, so a whole
local BA runs without a host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import se3
from ..geom.camera import PinholeCamera
from . import residuals as res


class BAProblem(NamedTuple):
    """Dense padded local-BA problem. P points, K free cams, F fixed cams."""

    R_free: torch.Tensor     # [K, 3, 3] Tcw rotations
    t_free: torch.Tensor     # [K, 3]
    R_fix: torch.Tensor      # [F, 3, 3]
    t_fix: torch.Tensor      # [F, 3]
    X: torch.Tensor          # [P, 3] world points
    cam_valid: torch.Tensor  # [K] bool
    point_valid: torch.Tensor  # [P] bool
    # dense observation grids; mask False where no observation
    uv_free: torch.Tensor    # [P, K, 2]
    ur_free: torch.Tensor    # [P, K] (-1 mono)
    inv_sigma2_free: torch.Tensor  # [P, K]
    mask_free: torch.Tensor  # [P, K] bool
    uv_fix: torch.Tensor     # [P, F, 2]
    ur_fix: torch.Tensor     # [P, F]
    inv_sigma2_fix: torch.Tensor   # [P, F]
    mask_fix: torch.Tensor   # [P, F] bool


class BAResult(NamedTuple):
    R_free: torch.Tensor
    t_free: torch.Tensor
    X: torch.Tensor
    inlier_free: torch.Tensor  # [P, K] bool (post-opt chi2 gate)
    inlier_fix: torch.Tensor   # [P, F] bool
    chi2_total: torch.Tensor   # scalar


def _residuals_grid(cam, R, t, X, uv, ur):
    """Residuals over a dense [P, C] grid: e [P, C, 3], Xc [P, C, 3]."""
    Xc = torch.einsum("cij,pj->pci", R, X) + t[None, :, :]
    z = Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] * iz + cam.cx
    v = cam.fy * Xc[..., 1] * iz + cam.cy
    u_r = u - cam.bf * iz
    is_stereo = ur >= 0
    e = torch.stack([uv[..., 0] - u, uv[..., 1] - v,
                     torch.where(is_stereo, ur - u_r, 0.0)], dim=-1)
    return e, Xc


def _jacobians_grid(cam, Xc, ur, R):
    """J_cam [P, C, 3, 6] and J_X [P, C, 3, 3]."""
    Jpt = res.proj_jacobian_point(cam, Xc, ur >= 0)        # [P, C, 3, 3]
    Jc = res.pose_jacobian_from_point_jac(Jpt, Xc)          # [P, C, 3, 6]
    JX = torch.einsum("pcab,cbj->pcaj", Jpt, R)             # dXc/dX = R
    return Jc, JX


def _chi2_grid(e, ur, inv_sigma2, mask):
    c = (e[..., 0] ** 2 + e[..., 1] ** 2
         + torch.where(ur >= 0, e[..., 2] ** 2, 0.0)) * inv_sigma2
    return torch.where(mask, c, 0.0)


def _inv3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _lm_step(cam, prob: BAProblem, use_huber: bool, lam):
    """One damped Schur-complement Gauss-Newton step: the proposal."""
    P, K = prob.mask_free.shape
    e_f, Xc_f = _residuals_grid(cam, prob.R_free, prob.t_free, prob.X,
                                prob.uv_free, prob.ur_free)
    e_x, Xc_x = _residuals_grid(cam, prob.R_fix, prob.t_fix, prob.X,
                                prob.uv_fix, prob.ur_fix)

    base_mask_f = (prob.mask_free & prob.point_valid[:, None]
                   & prob.cam_valid[None, :] & (Xc_f[..., 2] > 1e-6))
    base_mask_x = (prob.mask_fix & prob.point_valid[:, None]
                   & (Xc_x[..., 2] > 1e-6))

    w_f = torch.where(base_mask_f, prob.inv_sigma2_free, 0.0)
    w_x = torch.where(base_mask_x, prob.inv_sigma2_fix, 0.0)
    if use_huber:
        chi_f = _chi2_grid(e_f, prob.ur_free, prob.inv_sigma2_free,
                           base_mask_f)
        chi_x = _chi2_grid(e_x, prob.ur_fix, prob.inv_sigma2_fix, base_mask_x)
        d2_f = torch.where(prob.ur_free >= 0, res.CHI2_STEREO, res.CHI2_MONO)
        d2_x = torch.where(prob.ur_fix >= 0, res.CHI2_STEREO, res.CHI2_MONO)
        w_f = w_f * res.huber_weight(chi_f, d2_f)
        w_x = w_x * res.huber_weight(chi_x, d2_x)

    Jc, JXf = _jacobians_grid(cam, Xc_f, prob.ur_free, prob.R_free)
    _, JXx = _jacobians_grid(cam, Xc_x, prob.ur_fix, prob.R_fix)

    # normal-equation blocks
    Hcc = torch.einsum("pkai,pk,pkaj->kij", Jc, w_f, Jc)            # [K,6,6]
    g_c = -torch.einsum("pkai,pk,pka->ki", Jc, w_f, e_f)
    Hll = (torch.einsum("pkai,pk,pkaj->pij", JXf, w_f, JXf)
           + torch.einsum("pfai,pf,pfaj->pij", JXx, w_x, JXx))      # [P,3,3]
    g_l = (-torch.einsum("pkai,pk,pka->pi", JXf, w_f, e_f)
           - torch.einsum("pfai,pf,pfa->pi", JXx, w_x, e_x))
    Wc = torch.einsum("pkai,pk,pkaj->pkij", Jc, w_f, JXf)           # [P,K,6,3]

    # damping
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hcc_d = Hcc + lam * (torch.abs(Hcc) * eye6 + 1e-8 * eye6)
    Hll_d = Hll + lam * (torch.abs(Hll) * eye3 + 1e-8 * eye3)

    # points with no observations get identity (zero update)
    has_obs = (w_f.sum(dim=1) + w_x.sum(dim=1)) > 0
    Hll_d = torch.where(has_obs[:, None, None], Hll_d, eye3)
    Hll_inv = _inv3(Hll_d)

    # Schur reduction onto the cameras
    T = torch.einsum("pkab,pbc->pkac", Wc, Hll_inv)                 # [P,K,6,3]
    S = -torch.einsum("pkac,plbc->klab", T, Wc)                     # [K,K,6,6]
    idx = torch.arange(K, device=S.device)
    S[idx, idx] += Hcc_d
    rhs = g_c - torch.einsum("pkac,pc->ka", T, g_l)                 # [K,6]

    # invalid cameras become identity rows/cols
    cm = prob.cam_valid
    S = torch.where((cm[:, None] & cm[None, :])[:, :, None, None], S, 0.0)
    S_flat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    S_flat = S_flat + torch.diag(torch.repeat_interleave(~cm, 6)
                                 .to(S_flat.dtype))
    rhs_flat = torch.where(cm[:, None], rhs, 0.0).reshape(K * 6)

    dc = torch.linalg.solve_ex(S_flat, rhs_flat)[0].reshape(K, 6)
    # back-substitute the landmarks: dl = Hll^-1 (g_l - W^T dc)
    WTdc = torch.einsum("pkij,ki->pj", Wc, dc)
    dl = torch.einsum("pij,pj->pi", Hll_inv, g_l - WTdc)
    dl = torch.where((has_obs & prob.point_valid)[:, None], dl, 0.0)

    dR, dt = se3.se3_exp(dc)
    R_new, t_new = se3.compose(dR, dt, prob.R_free, prob.t_free)
    R_new = torch.where(cm[:, None, None], R_new, prob.R_free)
    t_new = torch.where(cm[:, None], t_new, prob.t_free)
    return R_new, t_new, prob.X + dl


def _total_chi2(cam, prob, R, t, X):
    e_f, Xc_f = _residuals_grid(cam, R, t, X, prob.uv_free, prob.ur_free)
    e_x, Xc_x = _residuals_grid(cam, prob.R_fix, prob.t_fix, X,
                                prob.uv_fix, prob.ur_fix)
    m_f = prob.mask_free & prob.point_valid[:, None] & prob.cam_valid[None, :]
    m_x = prob.mask_fix & prob.point_valid[:, None]
    chi_f = _chi2_grid(e_f, prob.ur_free, prob.inv_sigma2_free, m_f)
    chi_x = _chi2_grid(e_x, prob.ur_fix, prob.inv_sigma2_fix, m_x)
    # behind-camera observations are heavily penalized, not counted
    chi_f = torch.where(Xc_f[..., 2] > 1e-6, chi_f,
                        torch.where(m_f, 1e4, 0.0))
    chi_x = torch.where(Xc_x[..., 2] > 1e-6, chi_x,
                        torch.where(m_x, 1e4, 0.0))
    return chi_f, chi_x


def _lm_loop(cam, prob: BAProblem, n_iters: int, use_huber: bool):
    lam = torch.tensor(1e-4, dtype=torch.float32, device=prob.X.device)
    for _ in range(n_iters):
        R_new, t_new, X_new = _lm_step(cam, prob, use_huber, lam)
        chi_f_old, chi_x_old = _total_chi2(cam, prob, prob.R_free,
                                           prob.t_free, prob.X)
        chi_f_new, chi_x_new = _total_chi2(cam, prob, R_new, t_new, X_new)
        old = chi_f_old.sum() + chi_x_old.sum()
        new = chi_f_new.sum() + chi_x_new.sum()
        ok = (new < old) & torch.isfinite(new)
        prob = prob._replace(R_free=torch.where(ok, R_new, prob.R_free),
                             t_free=torch.where(ok, t_new, prob.t_free),
                             X=torch.where(ok, X_new, prob.X))
        lam = torch.clamp(torch.where(ok, lam * 0.4, lam * 5.0), 1e-8, 1e5)
    return prob


def local_ba(cam: PinholeCamera, prob: BAProblem,
             iters_first: int = 5, iters_second: int = 10) -> BAResult:
    """Full local-BA schedule (reference: src/Optimizer.cc:610-650):
    5 Huber iterations -> drop outlier observations -> 10 more iterations
    -> final outlier classification for map cleanup."""
    prob = _lm_loop(cam, prob, iters_first, use_huber=True)

    chi_f, chi_x = _total_chi2(cam, prob, prob.R_free, prob.t_free, prob.X)
    th_f = torch.where(prob.ur_free >= 0, res.CHI2_STEREO, res.CHI2_MONO)
    th_x = torch.where(prob.ur_fix >= 0, res.CHI2_STEREO, res.CHI2_MONO)
    prob = prob._replace(mask_free=prob.mask_free & (chi_f <= th_f),
                         mask_fix=prob.mask_fix & (chi_x <= th_x))

    prob = _lm_loop(cam, prob, iters_second, use_huber=False)

    chi_f, chi_x = _total_chi2(cam, prob, prob.R_free, prob.t_free, prob.X)
    return BAResult(R_free=prob.R_free, t_free=prob.t_free, X=prob.X,
                    inlier_free=prob.mask_free & (chi_f <= th_f),
                    inlier_fix=prob.mask_fix & (chi_x <= th_x),
                    chi2_total=chi_f.sum() + chi_x.sum())
