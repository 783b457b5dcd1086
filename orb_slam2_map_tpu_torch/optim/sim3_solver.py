"""Sim3 RANSAC solver + Sim3 optimization for loop closing.

Port of orb_slam2_map_tpu/optim/sim3_solver.py, replacing Sim3Solver
(reference: src/Sim3Solver.cc — Horn closed form over 3-point RANSAC
samples with both-direction reprojection checks) and
Optimizer::OptimizeSim3 (reference: src/Optimizer.cc:1046-1241 — one Sim3
vertex, forward/backward projection edges, inlier pruning).

All RANSAC hypotheses are solved at once (batched Horn) and scored
jointly. The minimal sets are drawn by inverse CDF from a torch.Generator
(the JAX package draws jax.random.categorical from PRNGKey(kid)), or
given as `idx`. The refinement is a small LM on the 7-dim tangent with
exact Jacobians in closed form (the JAX package takes them with
jax.jacfwd); its fixed iteration counts and tensor-valued accept/reject
make no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geom import se3, sim3
from ..geom.camera import PinholeCamera
from . import horn
from .epnp import sample_minimal_sets


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _proj(cam: PinholeCamera, X):
    z = torch.where(torch.abs(X[..., 2]) < 1e-9, 1e-9, X[..., 2])
    return torch.stack([cam.fx * X[..., 0] / z + cam.cx,
                        cam.fy * X[..., 1] / z + cam.cy], dim=-1)


def _proj_jacobian(cam: PinholeCamera, X):
    """d(_proj)/dX [N, 2, 3] (zero depth derivative where _proj guards
    a depth below 1e-9, as differentiating its torch.where gives)."""
    x, y, z = X[:, 0], X[:, 1], X[:, 2]
    guarded = torch.abs(z) < 1e-9
    zs = torch.where(guarded, 1e-9, z)
    dz = torch.where(guarded, 0.0, 1.0)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([cam.fx / zs, zero, -cam.fx * x / (zs * zs) * dz], -1),
        torch.stack([zero, cam.fy / zs, -cam.fy * y / (zs * zs) * dz], -1)],
        dim=-2)


def sim3_ransac(cam: PinholeCamera, X1, X2, level_sigma2_1, level_sigma2_2,
                valid, generator: Optional[torch.Generator] = None,
                n_hypotheses: int = 256, fix_scale: bool = False,
                min_inliers: int = 20, idx=None) -> Sim3RansacResult:
    """Estimate S12 (maps camera-2-frame points into camera 1) from paired
    camera-frame points X1, X2 [N, 3].

    The inlier check is the reference's two-direction reprojection error
    gate: project S12*X2 into image 1 and S21*X1 into image 2, threshold
    9.21 * sigma2 each (reference: src/Sim3Solver.cc:340-365 CheckInliers).
    The minimal sets are drawn from `generator` (on the inputs' device),
    or given as `idx` [H, 3]."""
    if idx is None:
        idx = sample_minimal_sets(valid, n_hypotheses, generator, size=3)
    idx = idx.long()
    Rs, ts, ss = horn.absolute_orientation(X2[idx], X1[idx],
                                           with_scale=not fix_scale)

    # forward: S12 X2 vs proj of X1
    X2in1 = (ss[:, None, None] * torch.einsum("hij,nj->hni", Rs, X2)
             + ts[:, None, :])
    e1 = _proj(cam, X2in1) - _proj(cam, X1)[None]
    # backward: S21 X1 vs proj of X2
    Rt = Rs.transpose(-1, -2)
    s_inv = 1.0 / ss
    t_inv = -s_inv[:, None] * torch.einsum("hij,hj->hi", Rt, ts)
    X1in2 = (s_inv[:, None, None] * torch.einsum("hij,nj->hni", Rt, X1)
             + t_inv[:, None, :])
    e2 = _proj(cam, X1in2) - _proj(cam, X2)[None]

    th = 9.210
    inl = ((torch.sum(e1 * e1, dim=-1) < th * level_sigma2_1[None, :])
           & (torch.sum(e2 * e2, dim=-1) < th * level_sigma2_2[None, :])
           & (X2in1[..., 2] > 0) & (X1in2[..., 2] > 0)
           & valid[None, :])
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    n = counts[best]
    return Sim3RansacResult(R=Rs[best], t=ts[best], s=ss[best],
                            inliers=inl[best], n_inliers=n.to(torch.int32),
                            ok=n >= min_inliers)


class Sim3OptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def optimize_sim3(cam: PinholeCamera, R0, t0, s0, X1, X2, uv1, uv2,
                  inv_sigma2_1, inv_sigma2_2, valid,
                  fix_scale: bool = False, iters: int = 20,
                  chi2_th: float = 9.999) -> Sim3OptResult:
    """LM refinement of S12 with forward/backward projection residuals
    (reference: src/Optimizer.cc:1046-1241; two-round inlier pruning):
    iters // 2 iterations, prune at chi2_th, then iters more."""
    w1 = torch.sqrt(inv_sigma2_1)[:, None]
    w2 = torch.sqrt(inv_sigma2_2)[:, None]

    def apply(xi, R, t, s):
        """Left-multiplicative update S = exp(xi) * S0."""
        dR, dt, ds = sim3.exp(xi)
        return sim3.compose(dR, dt, ds, R, t, s)

    # the Sim3 is carried with a leading axis of 1 (R [1,3,3], t [1,3],
    # s [1])
    def both(params):
        R, t, s = (p[:, None] for p in params)
        X2in1 = sim3.act(R, t, s, X2)
        X1in2 = sim3.act(*sim3.inverse(R, t, s), X1)
        return _proj(cam, X2in1) - uv1, _proj(cam, X1in2) - uv2

    def residuals(params, active):
        d1, d2 = both(params)
        w = active.to(torch.float32)[:, None]
        return d1 * w1 * w, d2 * w2 * w

    def chi2(params):
        d1, d2 = both(params)
        return (torch.sum(d1 * d1, -1)[0] * inv_sigma2_1,
                torch.sum(d2 * d2, -1)[0] * inv_sigma2_2)

    def total(params, active):
        e1, e2 = residuals(params, active)
        return torch.sum(e1 * e1) + torch.sum(e2 * e2)

    dt_, dev = X1.dtype, X1.device
    eye7 = torch.eye(7, dtype=dt_, device=dev)
    scale_free = torch.ones(7, dtype=dt_, device=dev)
    if fix_scale:
        scale_free[6] = 0.0

    def jacobian(params, active):
        """Exact d(residuals)/d(xi) [4N, 7] at xi = 0 (the JAX package
        takes it with jax.jacfwd). With Y = S X2 and Z = S^-1 X1, the
        left update exp(xi) S moves Y by [I | -hat(Y) | Y] xi and Z by
        -(1/s) R^T [I | -hat(X1) | X1] xi."""
        R, t, s = (p[0] for p in params)
        Y = sim3.act(R, t, s, X2)
        Z = sim3.act(*sim3.inverse(R, t, s), X1)
        eye3 = torch.eye(3, dtype=dt_, device=dev).expand(len(X1), 3, 3)
        dY = torch.cat([eye3, -se3.hat(Y), Y[:, :, None]], dim=-1)
        dZ = (-1.0 / s) * R.T @ torch.cat(
            [eye3, -se3.hat(X1), X1[:, :, None]], dim=-1)
        w = active.to(dt_)[:, None, None]
        J1 = _proj_jacobian(cam, Y) @ dY * (w1[:, :, None] * w)
        J2 = _proj_jacobian(cam, Z) @ dZ * (w2[:, :, None] * w)
        return torch.cat([J1.reshape(-1, 7), J2.reshape(-1, 7)])

    def lm(params, active, n_iters):
        lam = torch.tensor(1e-4, dtype=dt_, device=dev)
        for _ in range(n_iters):
            R, t, s = params
            J = jacobian(params, active) * scale_free          # [4N, 7]
            e1, e2 = residuals(params, active)
            r = torch.cat([e1.reshape(-1), e2.reshape(-1)])
            H = J.T @ J + lam * eye7
            dx = torch.linalg.solve_ex(H, -J.T @ r)[0] * scale_free
            new = apply(dx[None], R, t, s)
            better = total(new, active) < total(params, active)
            params = tuple(torch.where(better, a, b)
                           for a, b in zip(new, params))
            lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0),
                              1e-9, 1e6)
        return params

    params = lm((R0[None], t0[None], s0.reshape(1)), valid, iters // 2)
    c1, c2 = chi2(params)
    active = valid & (c1 < chi2_th) & (c2 < chi2_th)
    params = lm(params, active, iters)
    c1, c2 = chi2(params)
    inl = valid & (c1 < chi2_th) & (c2 < chi2_th)
    R, t, s = params
    return Sim3OptResult(R=R[0], t=t[0], s=s[0], inliers=inl,
                         n_inliers=inl.sum().to(torch.int32))
