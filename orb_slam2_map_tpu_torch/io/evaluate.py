"""Trajectory evaluation: ATE (absolute trajectory error) and RPE.

The reference relies on the external TUM `evaluate_ate.py` tooling
(SURVEY.md §4); here evaluation is built in. ATE follows the standard
protocol: associate by timestamp, align with a closed-form Horn/Umeyama
similarity (or rigid) transform, report RMSE of translational residuals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (TUM tooling semantics)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(ts_b):
                dt = abs(ts_b[k] - t)
                if dt <= best_dt:
                    best, best_dt = k, dt
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Closed-form similarity/rigid alignment src -> dst. [N,3] each.
    Returns (s, R, t) with dst ~= s * R @ src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(ts_est: np.ndarray, pos_est: np.ndarray,
             ts_gt: np.ndarray, pos_gt: np.ndarray,
             with_scale: bool = False, max_dt: float = 0.02) -> float:
    """ATE RMSE in the units of the input positions ([N,3] translations)."""
    ia, ib = associate(ts_est, ts_gt, max_dt)
    if len(ia) < 3:
        return float("inf")
    est, gt = pos_est[ia], pos_gt[ib]
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = aligned - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(ts_est: np.ndarray, Twc_est: np.ndarray,
        ts_gt: np.ndarray, Twc_gt: np.ndarray,
        delta: int = 1, max_dt: float = 0.02):
    """Relative pose error over a frame delta.
    Returns (trans_rmse, rot_rmse_rad)."""
    ia, ib = associate(ts_est, ts_gt, max_dt)
    Te, Tg = Twc_est[ia], Twc_gt[ib]
    terrs, rerrs = [], []
    for i in range(len(Te) - delta):
        de = np.linalg.inv(Te[i]) @ Te[i + delta]
        dg = np.linalg.inv(Tg[i]) @ Tg[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c))
    if not terrs:
        return float("inf"), float("inf")
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))
