"""Essential-graph / pose-graph optimization over Sim3.

Port of orb_slam2_map_tpu/optim/pose_graph.py, replacing
Optimizer::OptimizeEssentialGraph (reference: src/Optimizer.cc:781-1044):
Sim3 vertices (7-DoF, scale frozen for stereo/RGB-D via `_fix_scale`),
loop + spanning-tree + strong-covisibility edges with identity
information, 20 LM iterations.

Residuals r_e = log_sim3(S_meas_ji * S_i * S_j^-1) for all edges at
once; per-edge 7x14 Jacobians by float64 central differences (the JAX
package takes them exactly with vmap(jacfwd); these agree to ~1e-9); the normal equations are assembled as a
dense [7V, 7V] matrix with index_put_ accumulation and solved with
torch.linalg.solve_ex. The graph is solved at its exact vertex and edge
counts. The JAX package's lax.scan is a Python loop with the same
accept/reject and damping schedule, written with torch.where, so it
makes no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import sim3


class PoseGraphResult(NamedTuple):
    R: torch.Tensor   # [V, 3, 3] optimized S_iw rotations
    t: torch.Tensor   # [V, 3]
    s: torch.Tensor   # [V]


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log(S_meas_ji * S_i * S_j^{-1}), [..., 7]."""
    Rij, tij, sij = sim3.compose(Ri, ti, si, *sim3.inverse(Rj, tj, sj))
    Re, te, se = sim3.compose(Rm, tm, sm, Rij, tij, sij)
    return sim3.log(Re, te, se)


def _edge_residual_tangent(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Residuals after left-perturbing both endpoints of every edge."""
    Rii, tii, sii = sim3.compose(*sim3.exp(xi_i), Ri, ti, si)
    Rjj, tjj, sjj = sim3.compose(*sim3.exp(xi_j), Rj, tj, sj)
    return _edge_residual(Rii, tii, sii, Rjj, tjj, sjj, Rm, tm, sm)


# central-difference step of the float64 Jacobian: its truncation error
# (~h^2/6 times the third derivative) and rounding error (~1e-16/h) both
# stay below 1e-9, and no perturbation lands on a small-angle branch
# threshold of sim3.exp (1e-5) or se3.so3_log (1e-4)
_FD_STEP = 3e-5


def _jacobians(*edge_args):
    """Per-edge Jacobians (Ji, Jj) [E, 7, 7] of the residual with respect
    to the two endpoints' tangents at 0 (the JAX package's vmap(jacfwd)
    over edges): central differences in float64, all 28 perturbations of
    every edge in one batched evaluation. Accurate to ~1e-9, far below
    the float32 the solve runs in, and one pass of plain ops where
    forward-mode AD costs several times the launches. One difference:
    at sigma = 0 autodiff differentiates sim3.exp's small-sigma limit
    formulas, which leave sigma out of two coefficients, so the JAX
    package's scale column is not the derivative that this one measures;
    it matters only with a free scale (fix_scale=False, monocular) and
    changes the LM's steps, not its optimum."""
    E = edge_args[0].shape[0]
    dev = edge_args[0].device
    rep = [a.double().repeat(28, *([1] * (a.dim() - 1))) for a in edge_args]
    step = _FD_STEP * torch.eye(7, dtype=torch.float64, device=dev)
    step = step.repeat_interleave(E, 0)                    # [7E, 7]
    zero = torch.zeros_like(step)
    xi_i = torch.cat([step, -step, zero, zero])
    xi_j = torch.cat([zero, zero, step, -step])
    r = _edge_residual_tangent(xi_i, xi_j, *rep).reshape(4, 7, E, 7)
    Ji = (r[0] - r[1]) / (2 * _FD_STEP)                   # [7 (tangent), E, 7]
    Jj = (r[2] - r[3]) / (2 * _FD_STEP)
    dt = edge_args[0].dtype
    return Ji.permute(1, 2, 0).to(dt), Jj.permute(1, 2, 0).to(dt)


def optimize_pose_graph(poses, edges_ij, edges_meas, edge_valid,
                        vertex_valid, fixed, fix_scale: bool = True,
                        iters: int = 20) -> PoseGraphResult:
    """Args:
      poses: (R [V,3,3], t [V,3], s [V]) current S_iw estimates
        (s=1 unless a loop correction seeded scale drift).
      edges_ij: [E, 2] int64 (i, j) vertex indices.
      edges_meas: (Rm [E,3,3], tm [E,3], sm [E]) measurements S_ji.
      edge_valid: [E] bool. vertex_valid: [V] bool. fixed: [V] bool
        (the loop keyframe, reference :820).
    """
    R, t, s = poses
    Rm, tm, sm = edges_meas
    V = R.shape[0]
    dev, dt = R.device, R.dtype
    i = edges_ij[:, 0].long()
    j = edges_ij[:, 1].long()
    w = edge_valid.to(dt)
    free = vertex_valid & ~fixed
    fmask = free.to(dt)
    pin = (~free).to(dt).repeat_interleave(7)
    scale_coord = (torch.arange(7, device=dev) == 6).to(dt).repeat(V)
    if fix_scale:
        pin = torch.clamp(pin + scale_coord, 0.0, 1.0)
    # dense H as [V, 7, V, 7]: block (a, b) of edge e lands at rows a*7..,
    # columns b*7..
    r7 = torch.arange(7, device=dev)
    rows_ii = (i[:, None, None] * 7 + r7[None, :, None]).expand(-1, 7, 7)
    cols_ii = (i[:, None, None] * 7 + r7[None, None, :]).expand(-1, 7, 7)
    rows_jj = (j[:, None, None] * 7 + r7[None, :, None]).expand(-1, 7, 7)
    cols_jj = (j[:, None, None] * 7 + r7[None, None, :]).expand(-1, 7, 7)

    def residual(R_, t_, s_):
        return _edge_residual(R_[i], t_[i], s_[i], R_[j], t_[j], s_[j],
                              Rm, tm, sm)

    def total(R_, t_, s_):
        r_ = residual(R_, t_, s_)
        return torch.sum(torch.sum(r_ * r_, -1) * w)

    lam = torch.tensor(1e-8, dtype=dt, device=dev)
    for _ in range(iters):
        r = residual(R, t, s)
        Ji, Jj = _jacobians(R[i], t[i], s[i], R[j], t[j], s[j], Rm, tm, sm)
        if fix_scale:
            keep = 1.0 - (r7 == 6).to(dt)
            Ji = Ji * keep[None, :, None] * keep[None, None, :]
            Jj = Jj * keep[None, :, None] * keep[None, None, :]
            r = r * keep
        Hii = torch.einsum("eai,e,eaj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eai,e,eaj->eij", Jj, w, Jj)
        Hij = torch.einsum("eai,e,eaj->eij", Ji, w, Jj)
        gi = -torch.einsum("eai,e,ea->ei", Ji, w, r)
        gj = -torch.einsum("eai,e,ea->ei", Jj, w, r)

        Hf = torch.zeros((V * 7, V * 7), dtype=dt, device=dev)
        Hf.index_put_((rows_ii, cols_ii), Hii, accumulate=True)
        Hf.index_put_((rows_jj, cols_jj), Hjj, accumulate=True)
        Hf.index_put_((rows_ii, cols_jj), Hij, accumulate=True)
        Hf.index_put_((rows_jj, cols_ii), Hij.transpose(-1, -2),
                      accumulate=True)
        g = torch.zeros((V, 7), dtype=dt, device=dev)
        g.index_add_(0, i, gi)
        g.index_add_(0, j, gj)

        # rows/cols of non-free vertices out; damping + identity on the
        # pinned coordinates
        fm = fmask.repeat_interleave(7)
        Hf = Hf * fm[:, None] * fm[None, :]
        Hf = Hf + torch.diag(lam * (torch.abs(torch.diagonal(Hf)) + 1e-6)
                             + pin)
        gf = (g * fmask[:, None]).reshape(V * 7)
        if fix_scale:
            gf = gf * (1.0 - scale_coord)

        dx = torch.linalg.solve_ex(Hf, gf)[0].reshape(V, 7)
        dR, dtr, ds = sim3.exp(dx)
        Rn, tn, sn = sim3.compose(dR, dtr, ds, R, t, s)
        Rn = torch.where(free[:, None, None], Rn, R)
        tn = torch.where(free[:, None], tn, t)
        sn = torch.where(free, sn, s)

        better = total(Rn, tn, sn) < total(R, t, s)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        s = torch.where(better, sn, s)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 5.0),
                          1e-12, 1e4)
    return PoseGraphResult(R=R, t=t, s=s)
