"""Pose-only optimization (motion-only BA) — the per-frame hot path.

Port of orb_slam2_map_tpu/optim/pose_opt.py, replacing the reference's
Optimizer::PoseOptimization (src/Optimizer.cc:239-451): a single SE3
vertex, mono/stereo reprojection edges, 4 rounds x 10 LM iterations with
chi-squared inlier reclassification between rounds and the Huber kernel
dropped for the last two rounds.

The JAX package vmaps over starts and frames; here they are a leading
batch dimension B of the pose. Its fori_loop is a Python loop whose
accept/reject is `torch.where`, so no value is read back to the host
inside the 40 iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import se3
from ..geom.camera import PinholeCamera
from . import residuals as res


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # [..., 3, 3] optimized Tcw rotation
    t: torch.Tensor          # [..., 3]
    inliers: torch.Tensor    # [..., N] bool
    n_inliers: torch.Tensor  # [...] int32
    chi2: torch.Tensor       # [..., N] final per-obs chi2


def _chi2(cam, R, t, X, uv, ur, inv_sigma2):
    """Per-observation chi2 at pose R [B, 3, 3], t [B, 3] -> [B, N], and
    the positive-depth mask."""
    e, Xc = res.project_residual(cam, R[..., None, :, :], t[..., None, :],
                                 X, uv, ur)
    is_stereo = ur >= 0
    c = (e[..., 0] ** 2 + e[..., 1] ** 2
         + torch.where(is_stereo, e[..., 2] ** 2, 0.0)) * inv_sigma2
    return c, Xc[..., 2] > 0.0


def _lm_rounds(cam, R0, t0, X, uv, ur, inv_sigma2, active0,
               rounds, iters_per_round, use_huber_rounds):
    """The reference's round schedule for a batch of poses R0 [B, 3, 3],
    t0 [B, 3]; observations are [N, ...] (shared) or [B, N, ...]."""
    is_stereo = ur >= 0
    delta2 = torch.where(is_stereo, res.CHI2_STEREO, res.CHI2_MONO)

    def normal_eq(R, t, active, use_huber):
        """One projection + weighted normal equations at (R, t)."""
        e, Xc = res.project_residual(cam, R[..., None, :, :], t[..., None, :],
                                     X, uv, ur)
        ee = (e * e).sum(dim=-1)
        w = torch.where(active, inv_sigma2, 0.0)
        if use_huber:
            w = w * res.huber_weight(ee * inv_sigma2, delta2)
        w = torch.where(Xc[..., 2] > 1e-6, w, 0.0)          # [B, N]
        Jpt = res.proj_jacobian_point(cam, Xc, is_stereo)
        J = res.pose_jacobian_from_point_jac(Jpt, Xc)       # [B, N, 3, 6]
        H = torch.einsum("bnri,bn,bnrj->bij", J, w, J)
        b = -torch.einsum("bnri,bn,bnr->bi", J, w, e)
        return H, b, (ee * w).sum(dim=-1)

    def lm_iterations(R, t, active, use_huber, n_iters):
        """Classic LM with carried normal equations: one projection and
        Jacobian evaluation per iteration, accept on a decrease."""
        H, b, chi_best = normal_eq(R, t, active, use_huber)
        lam = torch.full(R.shape[:-2], 1e-3, dtype=R.dtype, device=R.device)
        for _ in range(n_iters):
            Haug = H + lam[..., None, None] * torch.diag_embed(
                torch.diagonal(H, dim1=-2, dim2=-1) + 1e-9)
            # solve_ex: no host round trip to check the factorization; a
            # singular system yields non-finite dx, rejected below
            dx = torch.linalg.solve_ex(Haug, b[..., None])[0][..., 0]
            dR, dt = se3.se3_exp(dx)
            R_try, t_try = se3.compose(dR, dt, R, t)
            H_try, b_try, chi_try = normal_eq(R_try, t_try, active, use_huber)
            ok = (chi_try < chi_best) & torch.isfinite(dx).all(dim=-1)
            R = torch.where(ok[..., None, None], R_try, R)
            t = torch.where(ok[..., None], t_try, t)
            chi_best = torch.where(ok, chi_try, chi_best)
            H = torch.where(ok[..., None, None], H_try, H)
            b = torch.where(ok[..., None], b_try, b)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        return R, t

    R, t, active = R0, t0, active0
    for rnd in range(rounds):
        R, t = lm_iterations(R, t, active, rnd in use_huber_rounds,
                             iters_per_round)
        chi2, pos_depth = _chi2(cam, R, t, X, uv, ur, inv_sigma2)
        active = active0 & (chi2 <= delta2) & pos_depth
    chi2, pos_depth = _chi2(cam, R, t, X, uv, ur, inv_sigma2)
    inliers = active0 & (chi2 <= delta2) & pos_depth
    return R, t, inliers, chi2


def pose_optimize_batch(cam: PinholeCamera, R0, t0, X, uv, ur, inv_sigma2,
                        valid) -> PoseOptResult:
    """Optimize a batch of independent poses R0 [B, 3, 3], t0 [B, 3],
    each against its own correspondences X [B, N, 3], uv [B, N, 2],
    ur/inv_sigma2/valid [B, N] (or shared [N, ...] ones).
    Schedule: 4 rounds x 10 iters, Huber on rounds 0-1, off 2-3
    (reference: src/Optimizer.cc:369-442)."""
    R, t, inliers, chi2 = _lm_rounds(
        cam, R0, t0, X, uv, ur, inv_sigma2, valid,
        rounds=4, iters_per_round=10, use_huber_rounds=(0, 1))
    return PoseOptResult(R=R, t=t, inliers=inliers,
                         n_inliers=inliers.sum(dim=-1).to(torch.int32),
                         chi2=chi2)


def pose_optimize(cam: PinholeCamera, R0, t0, X, uv, ur, inv_sigma2,
                  valid) -> PoseOptResult:
    """Optimize Tcw (R0 [3, 3], t0 [3]) given 3D-2D correspondences of
    fixed capacity N masked by `valid`: X [N,3] world points; uv [N,2]
    observed (undistorted) pixels; ur [N] right-image u (-1 for mono);
    inv_sigma2 [N] per-level information."""
    r = pose_optimize_batch(cam, R0[None], t0[None], X, uv, ur, inv_sigma2,
                            valid)
    return PoseOptResult(*(v[0] for v in r))


def pose_optimize_multi(cam: PinholeCamera, R0s, t0s, X, uv, ur,
                        inv_sigma2, valid) -> PoseOptResult:
    """Multi-start pose optimization: the full LM schedule from each of
    the S initializations [S, 3, 3] / [S, 3] at once, keeping the basin
    with the most inliers (ties: lowest inlier chi2). Robust reweighting
    makes the cost surface init-dependent; running every start is the
    batched-hardware answer."""
    r = pose_optimize_batch(cam, R0s, t0s, X, uv, ur, inv_sigma2, valid)
    chi_inl = torch.where(r.inliers, r.chi2, 0.0).sum(dim=1)
    score = r.n_inliers.to(torch.float32) - 1e-4 * chi_inl
    best = torch.argmax(score).reshape(1)
    return PoseOptResult(*(v.index_select(0, best)[0] for v in r))
