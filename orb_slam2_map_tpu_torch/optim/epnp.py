"""EPnP (Lepetit et al.) + batched RANSAC.

Port of orb_slam2_map_tpu/optim/epnp.py, replacing PnPsolver (reference:
src/PnPsolver.cc): EPnP control points via PCA (:375-409), barycentric
coordinates (:411-434), the 12x12 M^T M eigen-system (:436-451), the
N=1 and N=2 beta cases with Gauss-Newton refinement (:667-858), and the
pose recovery by absolute orientation (:569-627).

Instead of the reference's sequential `iterate(5)` RANSAC, all
hypotheses are solved at once: [H, 4] minimal sets, EPnP batched over
the hypothesis axis (every solve a tensor op over H), every hypothesis
scored against every correspondence as one [H, N] reprojection-error
matrix, then one EPnP refit on the best hypothesis' inliers (the
reference's `Refine`, :260-306).

Eigenvector signs differ between LAPACK, cuSOLVER and XLA; the pose is
invariant to them through the positive-depth sign rule and the
sign(b01) rule of the N=2 case. The [6, 3] beta system is solved in
the minimum-norm SVD form with JAX's rcond, so that a degenerate
minimal set (sampling is with replacement) gives the same finite answer
here as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geom.camera import PinholeCamera
from . import horn

_PAIRS_A = (0, 0, 0, 1, 1, 2)
_PAIRS_B = (1, 2, 3, 2, 3, 3)


def _control_points(Xw):
    """[B, n, 3] world points -> [B, 4, 3] control points (centroid + PCA
    axes scaled by the square roots of the eigenvalues) (reference:
    src/PnPsolver.cc:375-409)."""
    c0 = Xw.mean(dim=-2)
    Xc = Xw - c0[..., None, :]
    cov = Xc.transpose(-1, -2) @ Xc / Xw.shape[-2]
    eigval, eigvec = torch.linalg.eigh(cov)          # ascending
    axes = eigvec.transpose(-1, -2) * torch.sqrt(
        torch.clamp(eigval, min=1e-10))[..., None]
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes], dim=-2)


def _barycentric(Xw, C):
    """alphas [B, n, 4] with X = sum_j alpha_j C_j, sum alpha = 1
    (reference: src/PnPsolver.cc:411-434)."""
    Bm = (C[..., 1:, :] - C[..., :1, :]).transpose(-1, -2)   # [B, 3, 3]
    eye = torch.eye(3, dtype=Xw.dtype, device=Xw.device)
    Binv = torch.linalg.inv_ex(Bm + 1e-12 * eye)[0]
    a123 = (Xw - C[..., :1, :]) @ Binv.transpose(-1, -2)
    a0 = 1.0 - a123.sum(dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _build_MtM(cam: PinholeCamera, alphas, uv):
    """M^T M [B, 12, 12], accumulated without materializing M [2n, 12]."""
    u, v = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(u)
    ru = torch.stack([torch.full_like(u, cam.fx), zeros, cam.cx - u], dim=-1)
    rv = torch.stack([zeros, torch.full_like(v, cam.fy), cam.cy - v], dim=-1)
    shape = alphas.shape[:-1] + (12,)
    Mu = (alphas[..., :, None] * ru[..., None, :]).reshape(shape)
    Mv = (alphas[..., :, None] * rv[..., None, :]).reshape(shape)
    return Mu.transpose(-1, -2) @ Mu + Mv.transpose(-1, -2) @ Mv


def _rho(C):
    """[B, 6] squared distances between control points."""
    return ((C[..., _PAIRS_A, :] - C[..., _PAIRS_B, :]) ** 2).sum(dim=-1)


def _vdiffs(V):
    """V: [..., 4, 3] null vectors reshaped -> [..., 6, 3] pairwise diffs."""
    return V[..., _PAIRS_A, :] - V[..., _PAIRS_B, :]


def _lstsq_min_norm(A, b):
    """Minimum-norm least squares A [B, m, n] x = b [B, m] through the SVD,
    singular values below eps * max(m, n) * s_max dropped (JAX's
    jnp.linalg.lstsq with rcond=None); finite on rank-deficient A."""
    m, n = A.shape[-2:]
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(m, n)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    uTb = (U.transpose(-1, -2) @ b[..., None])[..., 0]
    return (Vh.transpose(-1, -2) @ (s_inv * uTb)[..., None])[..., 0]


def _solve_pose_from_betas(cam, alphas, Xw, uv, Vs, betas):
    """Camera-frame control points = sum_k beta_k V_k; the pose by
    absolute orientation world -> camera; returns (R, t, mean squared
    reprojection error)."""
    Cc = torch.einsum("bk,bkij->bij", betas, Vs)          # [B, 4, 3]
    Xc = alphas @ Cc                                      # [B, n, 3]
    # positive depth (sign ambiguity of eigenvectors)
    sign = torch.sign(Xc[..., 2].sum(dim=-1))
    sign = torch.where(sign == 0, 1.0, sign)
    Xc = Xc * sign[:, None, None]
    R, t, _ = horn.absolute_orientation(Xw, Xc, with_scale=False)
    proj = Xw @ R.transpose(-1, -2) + t[:, None, :]
    z = torch.where(torch.abs(proj[..., 2]) < 1e-9, 1e-9, proj[..., 2])
    pu = cam.fx * proj[..., 0] / z + cam.cx
    pv = cam.fy * proj[..., 1] / z + cam.cy
    err = ((pu - uv[..., 0]) ** 2 + (pv - uv[..., 1]) ** 2).mean(dim=-1)
    return R, t, err


def _gauss_newton_betas(Vs, rho, betas, iters: int = 5):
    """Refine betas [B, 4] so the control-point distances match rho
    (reference: src/PnPsolver.cc:741-806 gauss_newton)."""
    dv = _vdiffs(Vs)                                      # [B, 4, 6, 3]
    eye = torch.eye(4, dtype=Vs.dtype, device=Vs.device)
    for _ in range(iters):
        cur = torch.einsum("bk,bkij->bij", betas, dv)      # [B, 6, 3]
        f = (cur * cur).sum(dim=-1) - rho                  # [B, 6]
        J = 2.0 * torch.einsum("bij,bkij->bik", cur, dv)   # [B, 6, 4]
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye
        rhs = -(J.transpose(-1, -2) @ f[..., None])
        betas = betas + torch.linalg.solve_ex(JtJ, rhs)[0][..., 0]
    return betas


def epnp_solve(cam: PinholeCamera, Xw, uv):
    """Closed-form EPnP for correspondence sets Xw [B, n, 3], uv [B, n, 2]
    (n >= 4; or one set [n, 3], [n, 2]).

    Returns (R, t, reproj_mse) with the batch shape of the input. Tries
    the N=1 and N=2 beta initializations, each refined by Gauss-Newton,
    and keeps the one with the lower reprojection error."""
    if Xw.ndim == 2:
        R, t, err = epnp_solve(cam, Xw[None], uv[None])
        return R[0], t[0], err[0]
    C = _control_points(Xw)
    alphas = _barycentric(Xw, C)
    MtM = _build_MtM(cam, alphas, uv)
    _, eigvec = torch.linalg.eigh(MtM)                    # ascending
    # kernel vectors of the four smallest eigenvalues, each as [4, 3]
    Vs = eigvec[..., :4].transpose(-1, -2).reshape(Xw.shape[0], 4, 4, 3)
    rho = _rho(C)

    # case N=1: scale of v0
    dv0 = _vdiffs(Vs[:, 0])
    n0 = (dv0 * dv0).sum(dim=-1)                          # [B, 6]
    num = (torch.sqrt(n0) * torch.sqrt(rho)).sum(dim=-1)
    den = n0.sum(dim=-1)
    zero = torch.zeros_like(num)
    b1 = torch.stack([num / torch.clamp(den, min=1e-12), zero, zero, zero], -1)

    # case N=2: [b00, b01, b11] from the 6x3 least squares
    dv1 = _vdiffs(Vs[:, 1])
    L = torch.stack([n0, 2.0 * (dv0 * dv1).sum(dim=-1),
                     (dv1 * dv1).sum(dim=-1)], dim=-1)    # [B, 6, 3]
    sol = _lstsq_min_norm(L, rho)
    b00, b01, b11 = sol[:, 0], sol[:, 1], sol[:, 2]
    beta0 = torch.sqrt(torch.clamp(b00, min=1e-12))
    beta1 = (torch.sqrt(torch.clamp(b11, min=1e-12)) * torch.sign(b01)
             * torch.sign(b00 + 1e-30))
    b2 = torch.stack([beta0, beta1, zero, zero], dim=-1)

    R1, t1, e1 = _solve_pose_from_betas(
        cam, alphas, Xw, uv, Vs, _gauss_newton_betas(Vs, rho, b1))
    R2, t2, e2 = _solve_pose_from_betas(
        cam, alphas, Xw, uv, Vs, _gauss_newton_betas(Vs, rho, b2))
    use = e2 < e1
    return (torch.where(use[:, None, None], R2, R1),
            torch.where(use[:, None], t2, t1), torch.minimum(e1, e2))


class PnPRansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # int32
    ok: torch.Tensor          # bool: enough inliers found


def sample_minimal_sets(valid, n_hypotheses: int,
                        generator: Optional[torch.Generator] = None):
    """[H, 4] indices drawn with replacement, uniformly over the valid
    rows (uniformly over all rows when none is valid), by inverting the
    CDF of the validity weights; no host synchronisation."""
    w = valid.to(torch.float32)
    w = torch.where(valid.any(), w, torch.ones_like(w))
    cdf = torch.cumsum(w, dim=0)
    u = torch.rand((n_hypotheses, 4), generator=generator,
                   device=valid.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=valid.shape[0] - 1)


def _reproj_err2(cam, R, t, Xw, uv):
    """Squared reprojection error and depth of Xw under poses R [..., 3, 3],
    t [..., 3] -> ([..., N], [..., N])."""
    Xc = torch.einsum("...ij,nj->...ni", R, Xw) + t[..., None, :]
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
    pu = cam.fx * Xc[..., 0] / z + cam.cx
    pv = cam.fy * Xc[..., 1] / z + cam.cy
    return (pu - uv[:, 0]) ** 2 + (pv - uv[:, 1]) ** 2, Xc[..., 2]


def pnp_ransac(cam: PinholeCamera, Xw, uv, inv_sigma2, valid,
               generator: Optional[torch.Generator] = None,
               n_hypotheses: int = 256, max_err2: float = 5.991,
               min_inliers: int = 10, idx=None) -> PnPRansacResult:
    """Batched-RANSAC EPnP over correspondences Xw [N, 3], uv [N, 2],
    inv_sigma2 [N], valid [N] (reference PnPsolver's RANSAC loop,
    src/PnPsolver.cc:165-258). The per-point inlier gate is max_err2 *
    sigma2(level), the reference's mvMaxError (:154-156).

    The minimal sets are drawn from `generator` (a torch.Generator on
    the inputs' device), or given as `idx` [H, 4]."""
    N = Xw.shape[0]
    if idx is None:
        idx = sample_minimal_sets(valid, n_hypotheses, generator)
    idx = idx.long()
    Rs, ts, _ = epnp_solve(cam, Xw[idx], uv[idx])         # [H,3,3], [H,3]

    # score all hypotheses on all points
    err2, z = _reproj_err2(cam, Rs, ts, Xw, uv)
    gate = max_err2 / torch.clamp(inv_sigma2, min=1e-9)   # sigma2 * th
    inl = (err2 <= gate[None, :]) & (z > 0) & valid[None, :]
    counts = inl.sum(dim=1)
    best_h = torch.argmax(counts)
    inliers = inl[best_h]
    n_inl = counts[best_h]

    # refit on the inliers: outlier rows are replaced by the first inlier
    # row so that they do not perturb the solve
    first = torch.argmax(inliers.to(torch.uint8))
    sel = torch.where(inliers, torch.arange(N, device=Xw.device), first)
    R_ref, t_ref, _ = epnp_solve(cam, Xw[sel], uv[sel])
    err2b, z2 = _reproj_err2(cam, R_ref, t_ref, Xw, uv)
    inliers2 = (err2b <= gate) & (z2 > 0) & valid
    better = inliers2.sum() >= n_inl
    R_out = torch.where(better, R_ref, Rs[best_h])
    t_out = torch.where(better, t_ref, ts[best_h])
    inl_out = torch.where(better, inliers2, inliers)
    n_out = inl_out.sum().to(torch.int32)
    return PnPRansacResult(R=R_out, t=t_out, inliers=inl_out,
                           n_inliers=n_out, ok=n_out >= min_inliers)
