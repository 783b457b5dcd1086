"""Global bundle adjustment: implicit-Schur conjugate gradient.

Port of orb_slam2_map_tpu/optim/global_ba.py, replacing
Optimizer::GlobalBundleAdjustemnt (reference: src/Optimizer.cc:41-237 —
g2o LM over all keyframes + landmarks with Schur marginalization). The
reduced camera system S = Hcc - W Hpp^-1 W^T is never materialized:

  * observations live in flat [O] tensors (cam_idx, pnt_idx, uv, ...);
  * residuals/Jacobians are one batched evaluation over O;
  * Hpp (3x3 blocks) is a segment sum (index_add_) + closed-form inverse;
  * S @ x inside CG is four segment-sum/gather passes;
  * block-Jacobi (6x6 camera blocks) preconditioning.

Both of the JAX package's lax.while_loops (CG, LM) have data-dependent
exits; here they are Python loops that read their exit condition on the
host, one synchronisation per CG iteration and one per LM iteration
(GBAResult counts them). Global BA runs on the loop closer's thread or
the background-GBA worker, never on a tracking dispatch thread. The JAX
package pads K, P and O to powers of two to bound its XLA compiles; the
port solves at the exact sizes. index_add_ sums in another order than
XLA's segment_sum (on CUDA, with atomics, in an order that changes from
run to run), so results agree with the JAX package's to float32 rounding
amplified by the iterations, not bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geom import se3
from ..geom.camera import PinholeCamera
from ..utils import profiling
from ..utils.device import default_device
from . import residuals as res_mod


class GBAProblem(NamedTuple):
    R: torch.Tensor          # [K, 3, 3]
    t: torch.Tensor          # [K, 3]
    X: torch.Tensor          # [P, 3]
    cam_free: torch.Tensor   # [K] bool (False = held fixed)
    cam_idx: torch.Tensor    # [O] int64
    pnt_idx: torch.Tensor    # [O] int64
    uv: torch.Tensor         # [O, 2]
    ur: torch.Tensor         # [O]
    inv_sigma2: torch.Tensor # [O]
    obs_valid: torch.Tensor  # [O] bool


class GBAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    inliers: torch.Tensor    # [O] bool
    chi2: torch.Tensor
    n_iters: int = 0         # LM iterations run
    n_cg_iters: int = 0      # CG iterations run, over all LM iterations
    n_syncs: int = 0         # host synchronisations of the loops' exits


def _obs_terms(cam: PinholeCamera, p: GBAProblem, use_huber: bool):
    Rg = p.R[p.cam_idx]
    tg = p.t[p.cam_idx]
    Xg = p.X[p.pnt_idx]
    e, Xc = res_mod.project_residual(cam, Rg, tg, Xg, p.uv, p.ur)
    is_stereo = p.ur >= 0
    w = torch.where(p.obs_valid & (Xc[..., 2] > 1e-6), p.inv_sigma2, 0.0)
    chi2 = torch.einsum("oi,oi->o", e, e) * p.inv_sigma2
    if use_huber:
        d2 = torch.where(is_stereo, res_mod.CHI2_STEREO, res_mod.CHI2_MONO)
        w = w * res_mod.huber_weight(chi2, d2)
    Jpt = res_mod.proj_jacobian_point(cam, Xc, is_stereo)    # [O,3,3]
    Jc = res_mod.pose_jacobian_from_point_jac(Jpt, Xc)       # [O,3,6]
    Jp = Jpt @ Rg                                             # [O,3,3]
    # zero camera Jacobian for fixed cameras
    free = p.cam_free[p.cam_idx]
    Jc = torch.where(free[:, None, None], Jc, 0.0)
    return e, Jc, Jp, w, chi2


def _inv3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj / det[..., None, None]


def _inv6(M):
    eye = torch.eye(6, dtype=M.dtype, device=M.device)
    return torch.linalg.inv_ex(M + 1e-9 * eye)[0]


def _segment_sum(vals, idx, n):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _gn_step(cam, p: GBAProblem, lam, use_huber: bool, cg_iters: int):
    """One damped implicit-Schur GN step. Returns (R, t, X, CG iterations
    run, host reads of CG's exit condition)."""
    K = p.R.shape[0]
    P = p.X.shape[0]
    e, Jc, Jp, w, _ = _obs_terms(cam, p, use_huber)

    def seg_cam(vals):  # [O, ...] -> [K, ...]
        return _segment_sum(vals, p.cam_idx, K)

    def seg_pnt(vals):  # [O, ...] -> [P, ...]
        return _segment_sum(vals, p.pnt_idx, P)

    Hcc = seg_cam(torch.einsum("oai,o,oaj->oij", Jc, w, Jc))   # [K,6,6]
    gc = seg_cam(-torch.einsum("oai,o,oa->oi", Jc, w, e))      # [K,6]
    Hpp = seg_pnt(torch.einsum("oai,o,oaj->oij", Jp, w, Jp))   # [P,3,3]
    gp = seg_pnt(-torch.einsum("oai,o,oa->oi", Jp, w, e))      # [P,3]

    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Hpp_d = Hpp + lam * (torch.abs(Hpp) * eye3 + 1e-8 * eye3)
    has_obs = Hpp[..., 0, 0] + Hpp[..., 1, 1] + Hpp[..., 2, 2] > 0
    Hpp_d = torch.where(has_obs[:, None, None], Hpp_d, eye3)
    Hpp_inv = _inv3(Hpp_d)
    Hcc_d = Hcc + lam * (torch.abs(Hcc) * eye6 + 1e-8 * eye6)

    #   W[c,p] = sum_{o in (c,p)} Jc_o^T w Jp_o  (6x3)
    #   (W^T x)_p = sum_o Jp_o^T w (Jc_o x_c)
    def matvec(x):
        jc_x = torch.einsum("oai,oi->oa", Jc, x[p.cam_idx])        # [O,3]
        v = seg_pnt(torch.einsum("oab,o,oa->ob", Jp, w, jc_x))     # [P,3]
        c = torch.einsum("pij,pj->pi", Hpp_inv, v)                 # [P,3]
        jp_c = torch.einsum("oab,ob->oa", Jp, c[p.pnt_idx])        # [O,3]
        back = seg_cam(torch.einsum("oai,o,oa->oi", Jc, w, jp_c))
        return torch.einsum("kij,kj->ki", Hcc_d, x) - back

    # rhs = gc - W Hpp^-1 gp
    cpre = torch.einsum("pij,pj->pi", Hpp_inv, gp)
    jp_c = torch.einsum("oab,ob->oa", Jp, cpre[p.pnt_idx])
    rhs = gc - seg_cam(torch.einsum("oai,o,oa->oi", Jc, w, jp_c))

    # block-Jacobi preconditioner
    Minv = _inv6(Hcc_d)
    pinned = ~p.cam_free

    def precond(r):
        out = torch.einsum("kij,kj->ki", Minv, r)
        return torch.where(pinned[:, None], 0.0, out)

    x = torch.zeros_like(rhs)
    r = torch.where(pinned[:, None], 0.0, rhs)
    z = precond(r)
    pdir = z
    rz0 = torch.sum(r * z)
    rz = rz0
    it = reads = 0
    # early exit on a converged (e.g. warm-started) system: one host read
    # of the condition per iteration
    while it < cg_iters:
        reads += 1
        if not bool((rz > 1e-6 * rz0) & (rz > 1e-30)):
            break
        Ap = torch.where(pinned[:, None], 0.0, matvec(pdir))
        alpha = rz / torch.clamp(torch.sum(pdir * Ap), min=1e-20)
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        pdir = z + beta * pdir
        rz = rz_new
        it += 1
    dc = torch.where(pinned[:, None], 0.0, x)

    # back-substitute landmarks: dp = Hpp^-1 (gp - W^T dc)
    jc_dc = torch.einsum("oai,oi->oa", Jc, dc[p.cam_idx])
    wtd = seg_pnt(torch.einsum("oab,o,oa->ob", Jp, w, jc_dc))
    dp = torch.einsum("pij,pj->pi", Hpp_inv, gp - wtd)
    dp = torch.where(has_obs[:, None], dp, 0.0)

    dR, dt = se3.se3_exp(dc)
    R_new, t_new = se3.compose(dR, dt, p.R, p.t)
    R_new = torch.where(p.cam_free[:, None, None], R_new, p.R)
    t_new = torch.where(p.cam_free[:, None], t_new, p.t)
    return R_new, t_new, p.X + dp, it, reads


def _total_chi2(cam, p: GBAProblem, robust=False):
    """Acceptance objective for LM. Every valid observation contributes;
    non-finite terms are replaced by a large finite penalty (a divergent
    step must not hide its own residuals). With robust=True the Huber rho
    is summed (what _gn_step minimizes)."""
    _, _, _, _, chi2 = _obs_terms(cam, p, use_huber=False)
    if robust:
        is_stereo = p.ur >= 0
        d2 = torch.where(is_stereo, res_mod.CHI2_STEREO, res_mod.CHI2_MONO)
        delta = torch.sqrt(d2)
        r = torch.sqrt(torch.clamp(chi2, min=1e-12))
        chi2 = torch.where(chi2 <= d2, chi2, 2.0 * delta * r - d2)
    chi2_safe = torch.where(torch.isfinite(chi2), chi2, 1e12)
    total = torch.sum(torch.where(p.obs_valid, chi2_safe, 0.0))
    return total, chi2


def _lm_loop(cam, prob: GBAProblem, iters, cg_iters, use_huber, lam0):
    """LM with a chi2-plateau early exit. Returns (problem, lam, LM
    iterations, CG iterations, host synchronisations)."""
    cur, _ = _total_chi2(cam, prob, robust=use_huber)
    lam = torch.as_tensor(lam0, dtype=torch.float32, device=prob.R.device)
    n_cg = n_sync = 0
    i = 0
    while i < iters:
        R_new, t_new, X_new, n, reads = _gn_step(cam, prob, lam, use_huber,
                                                 cg_iters)
        n_cg += n
        n_sync += reads
        cand = prob._replace(R=R_new, t=t_new, X=X_new)
        new, _ = _total_chi2(cam, cand, robust=use_huber)
        nbad = ((~torch.isfinite(X_new)).sum() + (~torch.isfinite(t_new)).sum()
                + (~torch.isfinite(R_new)).sum())
        ok = (new < cur) & torch.isfinite(new) & (nbad == 0)
        prob = prob._replace(R=torch.where(ok, R_new, prob.R),
                             t=torch.where(ok, t_new, prob.t),
                             X=torch.where(ok, X_new, prob.X))
        # stop when an accepted step no longer buys relative improvement
        # (1e-6), or the damping has blown past any useful range
        plateau = ok & (cur - new <= 1e-6 * torch.clamp(cur, min=1e-12))
        cur = torch.where(ok, new, cur)
        stuck = ~ok & (lam >= 1e5)
        lam = torch.clamp(torch.where(ok, lam * 0.4, lam * 5.0), 1e-9, 1e5)
        i += 1
        n_sync += 1
        if bool(plateau | stuck):
            break
    return prob, lam, i, n_cg, n_sync


def _finish(cam, prob: GBAProblem, n_iters=0, n_cg=0, n_sync=0) -> GBAResult:
    total, chi2 = _total_chi2(cam, prob)
    is_stereo = prob.ur >= 0
    th = torch.where(is_stereo, res_mod.CHI2_STEREO, res_mod.CHI2_MONO)
    inl = prob.obs_valid & (chi2 <= th)
    return GBAResult(R=prob.R, t=prob.t, X=prob.X, inliers=inl, chi2=total,
                     n_iters=n_iters, n_cg_iters=n_cg, n_syncs=n_sync)


def global_ba(cam: PinholeCamera, prob: GBAProblem, iters: int = 20,
              cg_iters: int = 24, use_huber: bool = True) -> GBAResult:
    prob, _, n, n_cg, n_sync = _lm_loop(cam, prob, iters, cg_iters,
                                        use_huber, 1e-5)
    return _finish(cam, prob, n, n_cg, n_sync)


def global_ba_chunk(cam: PinholeCamera, prob: GBAProblem, iters: int,
                    cg_iters: int, use_huber: bool, lam0):
    """Chunked entry for background GBA: carries the LM damping across
    chunks and reports how many iterations ran, so the caller can stop
    once chi2 plateaus. Returns (GBAResult, lam_out, n_iters_done)."""
    prob, lam, n, n_cg, n_sync = _lm_loop(cam, prob, iters, cg_iters,
                                          use_huber, lam0)
    return _finish(cam, prob, n, n_cg, n_sync), lam, n


# ---------------------------------------------------------------------------
# host-side assembly from the map store
# ---------------------------------------------------------------------------

def build_gba_problem(cfg, map_store, fixed_kf: int, device=None):
    """Assemble a GBAProblem snapshot from the map, at its exact sizes.
    Returns (problem, kfs, mids) or None if the map is too small — the
    snapshot is what lets global BA run on a background thread while the
    map keeps evolving (reference mTcwGBA staging,
    src/Optimizer.cc:121-135, 207-235)."""
    device = default_device(device)
    m = map_store
    kfs = m.keyframe_ids()
    mids = m.point_ids()
    if len(kfs) < 2 or len(mids) < 10:
        return None
    K = len(kfs)
    kf_slot = np.full(m.K, -1, np.int64)
    kf_slot[kfs] = np.arange(K)
    mp_slot = np.full(m.M, -1, np.int64)
    mp_slot[mids] = np.arange(len(mids))

    inv_sigma2_tab = 1.0 / np.asarray(cfg.orb.level_sigma2, np.float32)
    cam_i, pnt_i, uvs, urs, ivs = [], [], [], [], []
    for k in kfs:
        obs = m.kf_obs[k]
        kp = np.nonzero((obs >= 0) & (mp_slot[np.clip(obs, 0, None)] >= 0))[0]
        if len(kp) == 0:
            continue
        cam_i.append(np.full(len(kp), kf_slot[k]))
        pnt_i.append(mp_slot[obs[kp]])
        uvs.append(m.kf_xy[k][kp])
        urs.append(m.kf_ur[k][kp])
        ivs.append(inv_sigma2_tab[m.kf_level[k][kp]])
    if not cam_i:
        return None
    cam_free = np.ones(K, bool)
    if fixed_kf >= 0 and kf_slot[fixed_kf] >= 0:
        cam_free[kf_slot[fixed_kf]] = False

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    cam_i = np.concatenate(cam_i)
    prob = GBAProblem(
        R=dev(m.kf_R[kfs], torch.float32), t=dev(m.kf_t[kfs], torch.float32),
        X=dev(m.mp_pos[mids], torch.float32),
        cam_free=dev(cam_free, torch.bool),
        cam_idx=dev(cam_i, torch.int64),
        pnt_idx=dev(np.concatenate(pnt_i), torch.int64),
        uv=dev(np.concatenate(uvs), torch.float32),
        ur=dev(np.concatenate(urs), torch.float32),
        inv_sigma2=dev(np.concatenate(ivs), torch.float32),
        obs_valid=torch.ones(len(cam_i), dtype=torch.bool, device=device))
    return prob, kfs, mids


def run_global_ba(cfg, map_store, fixed_kf: int, iters: int = 20,
                  device=None):
    """Synchronous GBA: assemble, run, write back. Returns the GBAResult
    (None when the map is too small); its iteration and synchronisation
    counts also go to the profiler (global_ba/*, as sample values)."""
    built = build_gba_problem(cfg, map_store, fixed_kf, device)
    if built is None:
        return None
    prob, kfs, mids = built
    res = global_ba(cfg.camera, prob, iters)
    for name, n in (("lm_iters", res.n_iters), ("cg_iters", res.n_cg_iters),
                    ("host_syncs", res.n_syncs)):
        profiling.PROFILER.add_sample(f"global_ba/{name}", float(n))
    m = map_store
    Rn = res.R.cpu().numpy()
    tn = res.t.cpu().numpy()
    Xn = res.X.cpu().numpy()
    # write-back guard: a degenerate solve must never teleport the map
    pose_ok = np.isfinite(tn).all(axis=1) \
        & (np.linalg.norm(tn - m.kf_t[kfs], axis=1) < 3.0)
    pt_ok = np.isfinite(Xn).all(axis=1) \
        & (np.linalg.norm(Xn - m.mp_pos[mids], axis=1) < 10.0)
    # project back to SO(3): f32 LM retractions drift R R^T off identity
    U, _, Vt = np.linalg.svd(Rn[pose_ok])
    m.kf_R[kfs[pose_ok]] = (U @ Vt).astype(np.float32)
    m.kf_t[kfs[pose_ok]] = tn[pose_ok]
    m.mp_pos[mids[pt_ok]] = Xn[pt_ok]
    m.mark_all_points_dirty()
    m.version += 1
    return res
